#!/usr/bin/env python
"""Export the parameters of an rsuper_tpu checkpoint as an ``.npz`` for the
PyTorch port's predict CLI (``python -m rsuper_tpu_torch.predict
--params_npz``): one array per flax parameter, keyed by its path joined
with ``/``.

    python tools/export_params_npz.py --checkpoint exp/run1 \\
        --classes_json classes.json --out params.npz [--ema] [--tag best]

Takes the same model flags as ``predict.py``; uses the JAX package.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True, help="experiment dir (orbax)")
    p.add_argument("--tag", default="best", choices=["best", "latest"])
    p.add_argument("--classes_json", required=True)
    p.add_argument("--arch", default="medformer")
    p.add_argument("--model_args_json", default=None)
    p.add_argument("--window", type=int, nargs=3, default=(128, 128, 128))
    p.add_argument("--ema", action="store_true", help="export EMA weights")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from rsuper_tpu.models import get_model
    from rsuper_tpu.train import make_optimizer
    from rsuper_tpu.train.checkpoint import CheckpointManager
    from rsuper_tpu.train.loop import init_params_on_host
    from rsuper_tpu.train.state import TrainState

    with open(args.classes_json) as f:
        classes = sorted(json.load(f))
    model_args = {}
    if args.model_args_json:
        with open(args.model_args_json) as f:
            model_args = json.load(f)
    model = get_model(args.arch, len(classes), model_args, dtype=jnp.bfloat16)
    tx = make_optimizer()
    params0 = init_params_on_host(
        model, jax.random.PRNGKey(0), jnp.zeros((1, *args.window, 1)))
    template = TrainState(
        params=params0, opt_state=tx.init(params0),
        ema_params=jax.tree.map(jnp.copy, params0),
        step=jnp.zeros((), jnp.int32), tx=tx,
    )
    ckpt = CheckpointManager(args.checkpoint)
    tag = args.tag if ckpt.has(args.tag) else "latest"
    state = ckpt.restore(template, tag)
    params = state.ema_params if args.ema else state.params
    params = params.get("params", params)

    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(
            leaf, np.float32)
    np.savez(args.out, **flat)
    print(f"wrote {args.out} ({len(flat)} arrays)")


if __name__ == "__main__":
    main()
