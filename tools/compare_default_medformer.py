#!/usr/bin/env python
"""Default-configuration MedFormer: the PyTorch port against the JAX package,
on the CPU, with the same seeded random parameters.

    JAX_PLATFORMS=cpu python tools/compare_default_medformer.py [--size 32]

Prints, for the logits and the aux head, the distance of the port from the
JAX model in float32 and in bf16, and each package's own bf16-vs-float32
distance (how far bf16 rounding alone moves this randomly initialised
model). The port runs its plain PyTorch paths; the JAX model its XLA paths.
About two minutes at 32³ (the JAX compile dominates).
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=32,
                   help="edge of the input window (a multiple of 16)")
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
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
