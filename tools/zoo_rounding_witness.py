#!/usr/bin/env python
"""How far float32 rounding alone takes the gradients of the model zoo's
conv nets, in the PyTorch port and in the JAX package, on the CPU.

    python tools/zoo_rounding_witness.py [case ...]
    python tools/zoo_rounding_witness.py --medformer [case ...]
    python tools/zoo_rounding_witness.py --dim2 [arch ...]

The cases are the conv nets of ``tests/test_torch_zoo.py`` at its widths,
shapes and seeds (parameters from ``flax_params`` of
``tests/test_torch_medformer.py``, input and head weights r from
``default_rng(3)``). For each, the gradient of Σ logits·r is taken by the
JAX model in float32 and in float64 (``jax_enable_x64``, every parameter
and the input promoted) and by the port in float32. Prints one JSON line a
case: the largest relative error over the parameter tensors,
‖g − g64‖ / (‖g64‖ + 1e-3·max‖g64‖), of the JAX float32 gradient and of the
port's, and the tensor of each. About a minute.

With ``--medformer`` the cases are the MedFormer configurations of
``tests/test_torch_medformer_options.py`` (its inputs, parameters and
output weights from ``default_rng(5)``, the gradient of the sum over all
its outputs), and the line also gives the largest relative distance of the
port's float32 gradient from JAX's (``port_vs_jax32``), the quantity that
file bounds. With ``--dim2`` the cases are the 2D architectures of
``tests/test_torch_dim2.py`` (``default_rng(7)``), the same quantities.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rsuper_tpu.models import factory as jfactory  # noqa: E402
from rsuper_tpu_torch.models import (get_model, load_flax_params,  # noqa: E402
                                     params_from_flax)
from test_torch_medformer import _unflatten, flax_params  # noqa: E402

UNET, POOL = (1, 20, 24, 32), (1, 32, 36, 40)
CASES = {  # the conv nets of tests/test_torch_zoo.py
    "unet_pool": ("unet", dict(base_chan=4, pool=True), POOL),
    "resunet_aux": ("resunet", dict(base_chan=4, aux_head=True), UNET),
    "attention_unet": ("attention_unet", dict(base_chan=4), POOL),
    "unetpp": ("unetpp", dict(base_chan=4, depth=3), POOL),
}


def _head(seg):
    return seg[0] if isinstance(seg, (list, tuple)) else seg


def witness(case):
    arch, args, shape = CASES[case]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(*shape, 1)).astype(np.float32)
    r = rng.normal(size=(*shape, 3)).astype(np.float32)
    grads, flat = {}, None
    for dt in (jnp.float32, jnp.float64):
        jm = jfactory.get_model(arch, 3, dict(args), dtype=dt)
        flat = flat or flax_params(jm, x)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                        _unflatten(flat))

        def loss(p, jm=jm, dt=dt):
            seg = jm.apply({"params": p}, jnp.asarray(x, dt))["segmentation"]
            return jnp.sum(_head(seg) * jnp.asarray(r, dt))

        grads[dt] = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(params))
    model = load_flax_params(get_model(arch, 3, dict(args),
                                       dtype=torch.float32), flat)
    (_head(model(torch.from_numpy(x))["segmentation"])
     * torch.from_numpy(r)).sum().backward()
    g32 = params_from_flax(grads[jnp.float32], model)
    g64 = params_from_flax(grads[jnp.float64], model)
    top = max(float(v.norm()) for v in g64.values())
    jax_err, port_err = [], []
    for k, p in model.named_parameters():
        den = float(g64[k].norm()) + 1e-3 * top
        jax_err.append((float((g32[k] - g64[k]).norm()) / den, k))
        port_err.append((float((p.grad - g64[k]).norm()) / den, k))
    (je, jk), (pe, pk) = max(jax_err), max(port_err)
    return dict(case=case, jax32_max_rel=je, jax32_tensor=jk,
                port32_max_rel=pe, port32_tensor=pk)


def _witness_all(case, jax_model, port_model, x, outputs, seed_rng):
    """The float32/float64 witness of one model: `jax_model(dtype)` builds
    the JAX model, `port_model(flat)` the loaded port model, `outputs` maps
    a model's output dict to a list of tensors, weights r from
    `seed_rng` after x."""
    grads, flat, r = {}, None, None
    for dt in (jnp.float32, jnp.float64):
        jm = jax_model(dt)
        flat = flat or flax_params(jm, x)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                        _unflatten(flat))
        if r is None:
            r = [seed_rng.normal(size=o.shape).astype(np.float32)
                 for o in outputs(jax.eval_shape(
                     jm.apply, {"params": params}, jnp.asarray(x)))]

        def loss(p, jm=jm, dt=dt):
            outs = outputs(jm.apply({"params": p}, jnp.asarray(x, dt)))
            return sum(jnp.sum(o * jnp.asarray(w, dt))
                       for o, w in zip(outs, r))

        grads[dt] = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(params))
    model = port_model(flat)
    outs = outputs(model(torch.from_numpy(x)))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, r)).backward()
    g32 = params_from_flax(grads[jnp.float32], model)
    g64 = params_from_flax(grads[jnp.float64], model)
    top64 = max(float(v.norm()) for v in g64.values())
    top32 = max(float(v.norm()) for v in g32.values())
    jax_err, port_err, pair_err = [], [], []
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        den = float(g64[k].norm()) + 1e-3 * top64
        jax_err.append((float((g32[k] - g64[k]).norm()) / den, k))
        port_err.append((float((g - g64[k]).norm()) / den, k))
        pair_err.append((float((g - g32[k]).norm())
                         / (float(g32[k].norm()) + 1e-3 * top32), k))
    (je, jk), (pe, pk), (qe, qk) = (max(jax_err), max(port_err),
                                    max(pair_err))
    return dict(case=case, jax32_max_rel=je, jax32_tensor=jk,
                port32_max_rel=pe, port32_tensor=pk, port_vs_jax32=qe,
                port_vs_jax32_tensor=qk)


def witness_medformer(case):
    import test_torch_medformer_options as opt
    from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer

    _, shape = opt.CASES[case]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(*shape, 1)).astype(np.float32)
    return _witness_all(
        case, lambda dt: JaxMedFormer(opt.NUM_CLASSES, dtype=dt,
                                      **opt._args(case)),
        lambda flat: opt._port(case, flat), x, opt._outputs, rng)


def witness_dim2(arch):
    import test_torch_dim2 as d2

    args, shape = d2.CASES[arch]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(*shape, 1)).astype(np.float32)
    return _witness_all(
        arch, lambda dt: jfactory.get_model(arch, 3, dict(args), dtype=dt),
        lambda flat: load_flax_params(d2._model(arch, dtype=torch.float32),
                                      flat),
        x, lambda out: d2._heads(out["segmentation"]), rng)


if __name__ == "__main__":
    torch.set_num_threads(2)
    args = sys.argv[1:]
    if args[:1] == ["--medformer"]:
        import test_torch_medformer_options as opt

        for case in args[1:] or sorted(opt.CASES):
            print(json.dumps(witness_medformer(case)), flush=True)
    elif args[:1] == ["--dim2"]:
        import test_torch_dim2 as d2

        for arch in args[1:] or sorted(d2.CASES):
            print(json.dumps(witness_dim2(arch)), flush=True)
    else:
        for case in args or sorted(CASES):
            print(json.dumps(witness(case)), flush=True)
