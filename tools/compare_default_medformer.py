#!/usr/bin/env python
"""Default-configuration MedFormer: the PyTorch port against the JAX package,
on the CPU, with the same seeded random parameters.

    JAX_PLATFORMS=cpu python tools/compare_default_medformer.py [--size 32]

Prints, for the logits and the aux head, the distance of the port from the
JAX model in float32 and in bf16, and each package's own bf16-vs-float32
distance (how far bf16 rounding alone moves this randomly initialised
model). The port runs its plain PyTorch paths; the JAX model its XLA paths.
About two minutes at 32³ (the JAX compile dominates).

    JAX_PLATFORMS=cpu python tools/compare_default_medformer.py --grad

compares instead, in float32, the loss terms and every parameter's gradient
of one training step's loss (``LossConfig(loss="dice")`` on the synthetic
batch of ``bench_train`` at `--size`, ``remat`` off): the port against
``jax.value_and_grad`` of the JAX package's ``loss_fn``. It also prints how
far one float32 rounding of the input image (x·(1 ± 2^-22)) moves the port's
own gradients: the scale any float32 agreement of this randomly initialised
model can be held to.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _dist(a, b):
    import numpy as np

    return dict(max_abs_err=float(np.abs(a - b).max()),
                max_abs_ref=float(np.abs(b).max()),
                rel_l2=float(np.linalg.norm(a - b) / np.linalg.norm(b)))


def _rel_l2_all(got, ref):
    import numpy as np

    num = np.sqrt(sum(float(((got[k] - ref[k]) ** 2).sum()) for k in ref))
    return num / np.sqrt(sum(float((ref[k] ** 2).sum()) for k in ref))


def _compare_grads(args, flat):
    """Loss terms and gradients of one step's loss, port against JAX."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from flax.traverse_util import flatten_dict, unflatten_dict

    from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
    from rsuper_tpu.losses import LossConfig as JLossConfig
    from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
    from rsuper_tpu.train.step import loss_fn as jax_loss_fn
    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.models import (get_model, load_flax_params,
                                         params_from_flax)
    from rsuper_tpu_torch.train import loss_fn

    classes = bench_train.CLASSES
    batch = {k: v.float() for k, v in bench_train.synthetic_batch(
        args.size, 1, seed=args.seed).items()}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jmodel = JaxMedFormer(len(classes), dtype=jnp.float32, remat=False)
    # without remat the blocks lose flax's "Checkpoint" name prefix
    flat = {k.replace("Checkpoint", ""): v for k, v in flat.items()}
    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(jax_loss_fn, has_aux=True),
        static_argnums=(1, 3, 4))(params, jmodel, jbatch,
                                  JLesionChannelMap.from_classes(classes),
                                  JLossConfig(loss="dice"))
    model = load_flax_params(
        get_model("medformer", len(classes), {"remat": False},
                  dtype=torch.float32), flat).train()
    lmap, cfg = LesionChannelMap.from_classes(classes), LossConfig(loss="dice")

    def port(b):
        model.zero_grad(set_to_none=True)
        overall, losses = loss_fn(model, b, lmap, cfg)
        overall.backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: p.grad.numpy().copy() for k, p in model.named_parameters()})

    losses, grads = port(batch)
    sign = torch.from_numpy(np.random.default_rng(args.seed + 1).choice(
        [-1.0, 1.0], size=tuple(batch["image"].shape)).astype(np.float32))
    _, nudged = port({**batch,
                      "image": batch["image"] * (1 + 2.0 ** -22 * sign)})
    want = {k: v.numpy() for k, v in params_from_flax(
        {"/".join(k): np.asarray(v)
         for k, v in flatten_dict(jgrads["params"]).items()}, model).items()}
    top = max(float(np.linalg.norm(w)) for w in want.values())
    rel = sorted((float(np.linalg.norm(grads[k] - w)
                        / (np.linalg.norm(w) + 1e-3 * top)), k)
                 for k, w in want.items())
    return {
        "size": args.size, "seed": args.seed, "parameters": len(want),
        "losses": {k: dict(port=losses[k], jax=float(v),
                           rel_err=abs(losses[k] - float(v)) / abs(float(v)))
                   for k, v in jlosses.items()},
        "grad_rel_l2_all_port_vs_jax": _rel_l2_all(grads, want),
        "grad_rel_l2_all_port_one_rounding_of_the_input":
            _rel_l2_all(nudged, grads),
        # per parameter: ‖Δ‖ / (‖ref‖ + 1e-3·max over parameters of ‖ref‖)
        "per_parameter_rel_quantiles": {
            q: rel[min(len(rel) - 1, int(q * len(rel)))][0]
            for q in (0.5, 0.9, 0.99, 1.0)},
        "worst": [dict(name=k, rel=r) for r, k in rel[-3:]],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=32,
                   help="edge of the input window (a multiple of 16)")
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grad", action="store_true",
                   help="compare the training step's loss terms and "
                        "gradients (float32) instead of the forward")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from flax.traverse_util import unflatten_dict

    from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
    from rsuper_tpu_torch.models import get_model, load_flax_params

    rng = np.random.default_rng(args.seed)
    x = rng.normal(size=(1, *(args.size,) * 3, 1)).astype(np.float32)
    jm = {dt: JaxMedFormer(args.classes, dtype=jdt)
          for dt, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16))}
    shapes = jax.eval_shape(jm["float32"].init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    flat = {}  # LeCun-normal kernels, small biases, LayerNorm scales near 1
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        if key.endswith("bias"):
            a = rng.normal(size=leaf.shape) * 0.1
        elif key.endswith("scale"):
            a = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            a = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        flat[key] = a.astype(np.float32)
    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    if args.grad:
        print(json.dumps(_compare_grads(args, flat), indent=1))
        return

    out = {}
    for dt, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ref = jm[dt].apply(params, jnp.asarray(x))["segmentation"]
        model = load_flax_params(get_model("medformer", args.classes, {},
                                           dtype=tdt), flat).eval()
        with torch.inference_mode():
            got = model(torch.from_numpy(x))["segmentation"]
        out[dt] = ([np.asarray(r, np.float32) for r in ref],
                   [g.float().numpy() for g in got])
    res = {}
    for i, name in enumerate(("logits", "aux")):
        res[name] = {
            "port_vs_jax_float32": _dist(out["float32"][1][i],
                                         out["float32"][0][i]),
            "port_vs_jax_bfloat16": _dist(out["bfloat16"][1][i],
                                          out["bfloat16"][0][i]),
            "jax_bf16_vs_f32": _dist(out["bfloat16"][0][i],
                                     out["float32"][0][i]),
            "port_bf16_vs_f32": _dist(out["bfloat16"][1][i],
                                      out["float32"][1][i]),
        }
    print(json.dumps({"size": args.size, "seed": args.seed, **res}, indent=1))


if __name__ == "__main__":
    main()
