#!/usr/bin/env python
"""How far float32 rounding alone takes the CLIP loss of a small MedFormer,
in the PyTorch port and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/clip_rounding_witness.py [--size 64]

The model is the small MedFormer of ``tests/test_torch_clip_loop.py`` with
its CLIP head (16 features), the parameters seeded as that test seeds them
(``flax_params`` of ``tests/test_torch_medformer.py``, seeds 0–3), the input
a seeded normal batch of two `--size`³ crops and the report embeddings
seeded (seeds 0–2). Prints, as JSON lines:

* ``sums``: the relative error of a float32 Σx and Σx² over the spatial
  axes of a (2, 64, 4, 64, 64) array (what an instance norm sums), by
  XLA:CPU and by PyTorch, against float64;
* ``loss``: for each (parameter seed, embedding seed) the CLIP loss of the
  JAX model and of the port in float32 and of the JAX model in float64,
  and the two float32 losses' relative distances from each other and from
  float64;
* ``layers``: for parameter seed `--layer-seed`, the relative L2 distance
  of each encoder block's and head module's output from the float64 run,
  JAX float32 and port float32 side by side.

The float64 run is the JAX package with every ``jnp.float32`` it names
promoted to float64 (a worker process of this script with ``jax_enable_x64``
on), so its instance norms, attention and heads compute in float64. The
port runs its plain PyTorch paths. About three minutes at 64³.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TINY = dict(base_chan=4, chan_num=(8, 16, 32, 40, 32, 16, 8, 4),
            conv_num=(2, 0, 0, 0, 0, 0, 2, 2),
            trans_num=(0, 1, 2, 1, 1, 1, 0, 0),
            num_heads=(1, 2, 2, 2, 2, 2, 1, 1), fusion_depth=1, fusion_dim=40,
            fusion_heads=2, expansion=2, clip_branch=True, clip_feats=16)
NUM_CLASSES = 9
PARAM_SEEDS, EMB_SEEDS = range(4), range(3)
# JAX's module path of each compared output: port name -> flax name
BLOCKS = {"BasicBlock_0": "BasicBlock_0",
          **{f"DownBlockMF_{k}": f"CheckpointDownBlockMF_{k}"
             for k in range(4)},
          **{k: k for k in ("clip_extra", "clip_branch/Conv_0",
                            "clip_branch/TransformerBlock_0", "clip_branch")}}


def _flax_params(module, size, seed):
    """The seeded flat tree of ``flax_params`` in
    ``tests/test_torch_medformer.py``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, size, 1)))["params"]
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        if key.endswith("bias"):
            a = rng.normal(size=leaf.shape) * 0.1
        elif key.endswith("scale"):
            a = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            a = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        flat[key] = a.astype(np.float32)
    return flat


def _inputs(size):
    import numpy as np

    x = np.random.default_rng(size).normal(
        size=(2, size, size, size, 1)).astype(np.float32)
    embs = [np.random.default_rng(e).normal(size=(2, TINY["clip_feats"]))
            .astype(np.float32) for e in EMB_SEEDS]
    return x, embs


def _outputs(intermediates, names):
    """{port name: the first array a flax module's ``__call__`` returned}."""
    import jax
    import numpy as np

    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(intermediates)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(v, np.float64)
    out = {}
    for port, jname in names.items():
        # a rematerialised block is named with or without its "Checkpoint"
        # prefix, as the model's route for the dtype and size has it
        keys = sorted(k for k in flat for n in {jname, jname.replace(
            "Checkpoint", "")} if k.startswith(n + "/__call__/"))
        out[port] = flat[keys[0]]
    return out


def _nce64(a, b):
    """Symmetric InfoNCE at T = 0.1 in float64 (numpy)."""
    import numpy as np

    def one(q, k):
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
        lg = q @ k.T / 0.1
        lg = lg - lg.max(-1, keepdims=True)
        logp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
        return -np.mean(np.diagonal(logp))

    return 0.5 * (one(a, b) + one(b, a))


def _float64_worker(size, params_path, out_path):
    """The JAX model in float64: clip vectors of every parameter seed (the
    float32 trees in `params_path`) and the compared outputs of each."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    jnp.float32 = jnp.float64  # every float32 the package names
    from flax.traverse_util import unflatten_dict

    from rsuper_tpu.models.medformer import MedFormer

    x, _ = _inputs(size)
    params = np.load(params_path)
    jm = MedFormer(NUM_CLASSES, dtype=jnp.float64, **TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, size, 1)))["params"]
    fwd = jax.jit(lambda p, xx: jm.apply(
        {"params": p}, xx, capture_intermediates=True,
        mutable=["intermediates"]))
    saved = {}
    for seed in PARAM_SEEDS:
        flat = {k.split("/", 1)[1]: params[k] for k in params.files
                if k.startswith(f"{seed}/")}
        tree = {}
        # the float32 model's tree under the float64 model's names: its
        # decoder takes another route (remat names, 1×1 conv shapes)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            src = flat.get(key, flat.get(key.replace("Checkpoint", "", 1)))
            tree[tuple(key.split("/"))] = jnp.asarray(
                src.reshape(leaf.shape), jnp.float64)
        out, st = fwd(unflatten_dict(tree), jnp.asarray(x, jnp.float64))
        saved[f"{seed}/clip"] = np.asarray(out["clip"], np.float64)
        for k, v in _outputs(st["intermediates"], BLOCKS).items():
            saved[f"{seed}/{k}"] = v
    np.savez(out_path, **saved)


def _align(a, like):
    """`a` in the layout of `like` (the port's and the float64 run's
    channel-first and channels-last 5D tensors differ)."""
    import numpy as np

    if a.shape == like.shape:
        return a
    for perm in ((0, 1, 3, 4, 2), (0, 1, 4, 2, 3)):
        if a.ndim == 5 and np.transpose(a, perm).shape == like.shape:
            return np.transpose(a, perm)
    raise ValueError(f"{a.shape} against {like.shape}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--layer-seed", type=int, default=1)
    ap.add_argument("--float64-worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.float64_worker:
        return _float64_worker(args.size, *args.float64_worker)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from flax.traverse_util import unflatten_dict

    from rsuper_tpu.losses import info_nce as jnce
    from rsuper_tpu.models.medformer import MedFormer
    from rsuper_tpu_torch.losses import symmetric_info_nce
    from rsuper_tpu_torch.models import get_model, load_flax_params

    jm = MedFormer(NUM_CLASSES, dtype=jnp.float32, **TINY)
    flats = {seed: _flax_params(jm, 32, seed) for seed in PARAM_SEEDS}
    with tempfile.TemporaryDirectory() as tmp:
        params, path = (os.path.join(tmp, n) for n in ("p.npz", "f64.npz"))
        np.savez(params, **{f"{s}/{k}": v for s, f in flats.items()
                            for k, v in f.items()})
        subprocess.run([sys.executable, __file__, "--size", str(args.size),
                        "--float64-worker", params, path], check=True)
        ref = dict(np.load(path))

    a = np.random.default_rng(0).normal(
        size=(2, 64, 4, 64, 64)).astype(np.float32) * 0.5 + 0.3
    sums = {}
    for name, f in (("sum", lambda v: v), ("sum_sq", lambda v: v * v)):
        want = f(a.astype(np.float64)).sum(axis=(1, 3, 4))
        xla = np.asarray(jax.jit(lambda v: jnp.sum(f(v), axis=(1, 3, 4)))(a))
        pt = torch.sum(f(torch.from_numpy(a)), dim=(1, 3, 4)).numpy()
        sums[name] = {"xla_cpu": float(np.abs(xla / want - 1).max()),
                      "pytorch": float(np.abs(pt / want - 1).max())}
    print(json.dumps({"sums": sums}))

    x, embs = _inputs(args.size)
    fwd = jax.jit(lambda p, xx: jm.apply(
        {"params": p}, xx, capture_intermediates=True,
        mutable=["intermediates"]))
    torch.set_num_threads(4)
    for seed in PARAM_SEEDS:
        flat = flats[seed]
        out, st = fwd(unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}),
            jnp.asarray(x))
        model = load_flax_params(get_model(
            "medformer", NUM_CLASSES, dict(TINY), dtype=torch.float32), flat)
        acts = {}
        modules = dict(model.named_modules())
        for name in BLOCKS:
            modules[name.replace("/", ".")].register_forward_hook(
                lambda m, i, o, name=name: acts.__setitem__(name, o))
        with torch.no_grad():
            x4 = model.encoder(torch.from_numpy(x))[4]
            clip = model.branches(x4)["clip"]
        for e, emb in zip(EMB_SEEDS, embs):
            lj = float(jnce.symmetric_info_nce(out["clip"], jnp.asarray(emb)))
            lp = float(symmetric_info_nce(clip, torch.from_numpy(emb)))
            l64 = float(_nce64(ref[f"{seed}/clip"], emb.astype(np.float64)))
            print(json.dumps({"loss": {
                "param_seed": seed, "emb_seed": e, "jax_f32": lj,
                "port_f32": lp, "jax_f64": l64,
                "port_vs_jax": abs(lp - lj) / abs(lj),
                "jax_f32_vs_f64": abs(lj - l64) / abs(l64),
                "port_f32_vs_f64": abs(lp - l64) / abs(l64)}}))
        if seed != args.layer_seed:
            continue
        jouts = _outputs(st["intermediates"], BLOCKS)
        for name in BLOCKS:
            o = acts[name]
            while isinstance(o, (tuple, list)):
                o = o[0]
            want = ref[f"{seed}/{name}"]
            j = _align(jouts[name], want)
            p = _align(o.double().numpy(), want)
            norm = np.linalg.norm(want)
            print(json.dumps({"layers": {
                "module": name, "jax_f32_vs_f64":
                float(np.linalg.norm(j - want) / norm),
                "port_f32_vs_f64": float(np.linalg.norm(p - want) / norm)}}))


if __name__ == "__main__":
    main()
