#!/usr/bin/env python
"""How far the phantom study's two training loops part with only the
arithmetic differing, and why, on the CPU.

    python tools/phantom_rounding_witness.py

The arms and data of ``tests/test_torch_phantom_parity.py`` (seed 0's
small study, a float32 ResUNet base 8 at 32³ × 4, ``ball_dice_last``, report
weight 0 or 0.1; the port from the JAX loop's initial parameters with its
draws replayed), three steps of each loop. Prints one JSON line an arm:
each step's relative loss gap, port against JAX, free-running and from the
JAX loop's parameters of that step on the same batch (``forced``), and the
parameters' update gap after the steps (the largest relative L2 of a
tensor's update, as ``tests/test_torch_loop.py:_check_params`` takes it).

Then one line on the gradient of Σ logits·r (r seeded) of the phantom model
at the JAX loop's initial parameters and its first batch's image: the
largest relative L2 distance over the parameter tensors of the JAX float32
gradient, the port's float32 gradient, and the port's gradient with the
instance norm in float64, each from the JAX package's gradient with the
instance norm in float64 (both packages take the norm's statistics in
float32 whatever the dtype, so the float64 runs swap in a plain float64
norm). About two minutes.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import rsuper_tpu.models.layers as jlayers  # noqa: E402
import rsuper_tpu_torch.models.layers as tlayers  # noqa: E402
from rsuper_tpu.models import get_model as jget_model  # noqa: E402
from rsuper_tpu.train import loop as jloop  # noqa: E402
from rsuper_tpu_torch import phantom_benchmark as pb  # noqa: E402
from rsuper_tpu_torch.models import (get_model, load_flax_params,  # noqa: E402
                                     params_from_flax)
from rsuper_tpu_torch.train import loop  # noqa: E402
from test_torch_loop import _flat, _jax_draws  # noqa: E402
from test_torch_phantom import SMALL, SMALL_SIZE, jtool  # noqa: E402
from test_torch_phantom_parity import (STEPS, _jax_steps, _kept,  # noqa: E402
                                       _port_steps)


def _gap(got, want):
    return {k: abs(got[k] - v) / abs(v) for k, v in want.items()}


def arm(root: Path, flat0, with_reports: bool, first: dict):
    """The loss gaps of one arm; the JAX loop's first batch's image is put
    in `first`."""
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        tmp = Path(tmp)
        for name in ("jax", "port"):
            shutil.copytree(root, tmp / name)
        jsteps = _jax_steps(mp)
        build = jloop.build_train_step

        def keep_first(*args, **kwargs):
            step = build(*args, **kwargs)

            def run(state, batch):
                first.setdefault("image", np.array(
                    jax.device_get(batch["image"])))
                return step(state, batch)

            return run

        mp.setattr(jloop, "build_train_step", keep_first)
        jkept = _kept(mp, jloop)
        jtool.train_variant(str(tmp / "jax"), with_reports, STEPS)
        steps = _port_steps(mp, jsteps)
        kept = _kept(mp, loop, flat=flat0, draws=_jax_draws)
        pb.train_variant(str(tmp / "port"), with_reports, STEPS,
                         device="cpu")
    (_, state), (_, jstate) = kept[0], jkept[0]
    start = params_from_flax(flat0, state.model)
    final = params_from_flax(_flat(jstate.params["params"]), state.model)
    update = max(float(((p.detach() - start[k]) - (final[k] - start[k]))
                       .norm() / (final[k] - start[k]).norm())
                 for k, p in state.model.named_parameters())
    return dict(
        arm="report" if with_reports else "mask_only",
        free=[_gap(free, want) for (_, free), (_, want) in
              zip(steps, jsteps)],
        forced=[_gap(forced, want) for (forced, _), (_, want) in
                zip(steps, jsteps)],
        update_max_rel=update)


def _norm64_jax(x, eps=1e-4):
    axes = tuple(range(1, x.ndim - 1))
    mean = x.mean(axes, keepdims=True)
    var = ((x - mean) ** 2).mean(axes, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps)


def _norm64_torch(x, eps=1e-4, spatial=None):
    axes = tuple(range(1, x.dim() - 1))
    mean = x.mean(axes, keepdim=True)
    var = ((x - mean) ** 2).mean(axes, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def gradients(flat0, image):
    """The gradient witness of the module docstring."""
    cfg = pb.variant_config("", False, STEPS)
    C = len(pb.MASK_CLASSES)

    def head(seg):
        return seg[0] if isinstance(seg, (list, tuple)) else seg

    r = np.random.default_rng(3).normal(size=(*image.shape[:-1], C))
    grads = {}
    for name, norm64 in (("jax32", False), ("jax64", True)):
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            if norm64:
                mp.setattr(jlayers, "instance_norm", _norm64_jax)
            dt = jnp.float64 if norm64 else jnp.float32
            jm = jget_model(cfg.arch, C, dict(cfg.model_args), dtype=dt)
            params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dt),
                {"params": _unflat(flat0)})

            def loss(p, jm=jm, dt=dt):
                seg = jm.apply(p, jnp.asarray(image, dt))["segmentation"]
                return jnp.sum(head(seg) * jnp.asarray(r, dt))

            g = jax.grad(loss)(params)
            grads[name] = {k: np.asarray(v, np.float64)
                           for k, v in _flat(g["params"]).items()}
    for name, dt in (("port32", torch.float32), ("port64", torch.float64)):
        with pytest.MonkeyPatch.context() as mp:
            if dt == torch.float64:
                mp.setattr(tlayers, "instance_norm", _norm64_torch)
            model = load_flax_params(get_model(cfg.arch, C,
                                               dict(cfg.model_args),
                                               dtype=dt), flat0).to(dt)
            seg = model(torch.from_numpy(image).to(dt))["segmentation"]
            (head(seg) * torch.from_numpy(r).to(dt)).sum().backward()
            grads[name] = {k: p.grad.double()
                           for k, p in model.named_parameters()}
            template = model
    ref = params_from_flax(grads["jax64"], template)
    out = {}
    for name in ("jax32", "port32", "port64"):
        g = (grads[name] if name.startswith("port")
             else params_from_flax(grads[name], template))
        out[f"{name}_vs_jax64_max_rel"] = max(
            float((g[k].double() - ref[k].double()).norm()
                  / ref[k].double().norm()) for k in ref)
    return out


def _unflat(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def main():
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        size, pb.SIZE = pb.SIZE, SMALL_SIZE
        try:
            pb.generate(str(root), **SMALL, seed=0)
        finally:
            pb.SIZE = size
        cfg = pb.variant_config(str(root), True, STEPS)
        jm = jget_model(cfg.arch, len(pb.MASK_CLASSES), dict(cfg.model_args),
                        dtype=jnp.float32)
        flat0 = _flat(jloop.init_params_on_host(
            jm, jax.random.PRNGKey(cfg.seed),
            jnp.zeros((1, *cfg.training_size, 1), jnp.float32))["params"])
        first = {}
        for with_reports in (False, True):
            print(json.dumps(arm(root, flat0, with_reports, first)),
                  flush=True)
    print(json.dumps({"gradient": gradients(flat0, first["image"])}))


if __name__ == "__main__":
    main()
