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

With ``--steps`` the cases are the training steps of the parity tests
that start from ``init_params``, with those tests' own seeded models,
batches, meshes and JAX references: ``res_dice``
(``tests/test_torch_spatial.py``'s ResUNet on the 2×2 mesh, against the
step's float64 gradient, its instance norms in float64 too),
``mf_classification_branch`` and ``mf_classification_branch_64`` (its
MedFormer's classification step at 64×32×32 and at 64³ on the 1×2 mesh;
``mf_dice`` and ``mf_clip`` name two other modes),
``mf_ball_dice_last`` (``tests/test_torch_parallel.py``'s step on the
2-device data mesh) and ``mf_attention_up2``
(``tests/test_torch_spatial_mf.py``'s). Per parameter, in the test's own
norm (max-norm for the ResUNet, L2 for the others), relative to the
reference: ρ, the JAX float32 gradient's move under one float32 rounding
of the image (``rho_nudge``); for the MedFormers the same step on one
device, unsharded: the mesh gradient's distance from it
(``mesh_vs_one_device``), its own move under the rounding
(``rho_nudge_one_device``) and the port's distance from it
(``port_vs_one_device``), with the ``_over_bound`` ratios that
``_close_grads`` of ``tests/test_torch_spatial.py`` forms (where the mesh
and the one-device gradients lie apart by more than 1, the one-device
gradient is the test's second reference); for the
ResUNet the JAX float32
gradient's distance from the float64 one (``jax32_vs_exact``); and the
port's one-process float32 gradient's distance from the reference
(``port_vs_ref``; the tests hold the sharded one); for the ResUNet also
the port's step in float64, its norms too (``port64_vs_exact``), and
each tensor's norm over the largest's. Prints one line a case:
the stem conv's tensor and the five farthest from the reference, and the
largest of each quantity. About ten minutes.
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
# the parity tests' meshes: the conftest's 8 virtual CPU devices
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

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


def _port64_res(model, batch):
    """The port's ResUNet ``dice`` step in float64, its instance norms by
    the two-pass definition in float64 (as ``_exact_res_grads`` takes the
    JAX package's)."""
    import pytest

    from rsuper_tpu_torch.models import get_model
    from rsuper_tpu_torch.models import layers as tlayers
    from test_torch_parallel_ranks import CLASSES
    from test_torch_spatial_ranks import RESUNET, step

    def norm64(x, eps=1e-4, spatial=None):
        axes = tuple(range(1, x.dim() - 1))
        mean = x.mean(axes, keepdim=True)
        var = ((x - mean) ** 2).mean(axes, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)

    m64 = get_model("resunet", len(CLASSES), dict(RESUNET),
                    dtype=torch.float64)
    m64.load_state_dict({k: v.double() for k, v in
                         model.state_dict().items()})
    b64 = {k: torch.from_numpy(v).double() if v.dtype.kind == "f"
           else torch.from_numpy(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "instance_norm", norm64)
        return step(m64.double(), b64, "dice")[1]


STEP_CASES = ("res_dice", "mf_classification_branch",
              "mf_classification_branch_64", "mf_ball_dice_last",
              "mf_attention_up2")


def _rel(a, b, top):
    return float((a - b).norm()) / top


def _rel_max(a, b, top):
    return float((a - b).abs().max()) / top


def witness_step(case):
    """The quantities of one parity test's step, per parameter (the
    worst few by the port's gap, and the largest of each)."""
    import test_torch_parallel as tp
    import test_torch_spatial as ts
    import test_torch_spatial_zoo as tz
    from rsuper_tpu.parallel import make_mesh
    from rsuper_tpu_torch.models import flax_from_state_dict
    from test_torch_spatial_ranks import medformer, resunet, rows, step
    from test_torch_spatial_zoo_ranks import zoo_model

    mesh2 = make_mesh(jax.devices()[:2], data=1, model=2)
    if case == "mf_ball_dice_last":  # test_torch_parallel.py, data mesh
        d = tp._inputs()
        jax_ref = tp._jax_refs(d)["step"]
        model, batch, mode = d["model"], d["batch"], "ball_dice_last"
        ref, moved, one, exact = jax_ref[1], jax_ref[3], None, None
    elif case == "mf_attention_up2":  # test_torch_spatial_mf.py
        d = tz._inputs(("mf",))
        model, batch, mode = (zoo_model(case, d["state"][case]),
                              d["mf"][case], "dice")
        _, ref, _, moved, one = tz._jax_step(
            case, flax_from_state_dict(d["state"][case]), batch, mesh2)
        exact = None
    else:  # test_torch_spatial.py
        d = ts._inputs()
        if case == "res_dice":
            model, batch, mode = resunet(d["res_state"]), d["res_batch"], \
                "dice"
            flat = flax_from_state_dict(d["res_state"])
            jm = jfactory.get_model("resunet", len(ts.CLASSES),
                                    dict(ts.RESUNET), dtype=jnp.float32)
            mesh = make_mesh(jax.devices()[:4], data=2, model=2)
            exact = ts._exact_res_grads(flat, batch)
        else:
            from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer

            model = medformer(d["mf_state"])
            mode = case[len("mf_"):].removesuffix("_64")
            batch = d["mf_cls_batch" if case.endswith("64") else
                      "mf_clip_batch" if mode == "clip" else "mf_batch"]
            flat = flax_from_state_dict(d["mf_state"], remat=False)
            jm = JaxMedFormer(len(ts.CLASSES), dtype=jnp.float32,
                              remat=False, **ts.TINY, **ts.HEADS)
            mesh, exact = mesh2, None
        _, ref, _, moved, *one = ts._jax_step(
            jm, flat, batch, mode, mesh, True, one_device=exact is None)
        one = one[0] if one else None
    conv = lambda g: None if g is None else params_from_flax(g, model)  # noqa
    ref, moved, exact = map(conv, (ref, moved, exact))
    one = None if one is None else tuple(map(conv, one))
    _, port = step(model, rows(batch, slice(None)), mode)
    port64 = _port64_res(model, batch) if case == "res_dice" else None
    largest = max(float(g.norm()) for g in ref.values())
    if one is not None:
        largest1 = max(float(g.norm()) for g in one[0].values())
    out = {}
    for k in ref:
        g = exact[k] if exact is not None else ref[k]
        if float(g.norm()) == 0.0:
            continue
        f = _rel_max if case == "res_dice" else _rel  # the test's norm
        top = float(g.abs().max() if case == "res_dice" else g.norm())
        row = dict(norm_of_largest=float(ref[k].norm()) / largest,
                   rho_nudge=f(moved[k], ref[k], top),
                   port_vs_ref=f(port[k], g, top))
        if port64 is not None:
            row["port64_vs_exact"] = f(port64[k], g, top)
        if exact is None:  # the test's rule (``_close_grads``)
            bound, _ = ts._grad_bound(ref, moved, k, ts.BALL_GRAD_TOL,
                                      largest)
            row["port_vs_ref_over_bound"] = float(
                (port[k] - ref[k]).norm()) / bound
        if one is not None:
            top1 = float(one[0][k].norm())
            bound1, _ = ts._grad_bound(one[0], one[1], k, ts.BALL_GRAD_TOL,
                                       largest1)
            # as _close_grads: apart by more than the tighter bound
            apart = min(bound1, ts._grad_bound(
                ref, moved, k, ts.BALL_GRAD_TOL, largest)[0])
            row.update(
                mesh_vs_one_device=f(one[0][k], ref[k], top),
                rho_nudge_one_device=f(one[1][k], one[0][k], top1),
                port_vs_one_device=f(port[k], one[0][k], top1),
                mesh_vs_one_device_over_bound=float(
                    (one[0][k] - ref[k]).norm()) / apart,
                port_vs_one_device_over_bound=float(
                    (port[k] - one[0][k]).norm()) / bound1)
        if exact is not None:
            row["jax32_vs_exact"] = f(ref[k], g, top)
            row["port_vs_jax32"] = f(port[k], ref[k], top)
        out[k] = row
    keys = next(iter(out.values()))
    stem = next(k for k in out if k.startswith("BasicBlock_0.ConvNormAct_0."))
    worst = sorted(out, key=lambda k: -out[k]["port_vs_ref"])[:5]
    strays = {k: {q: round(v, 6) for q, v in r.items()} for k, r in out.items()
              if r.get("mesh_vs_one_device_over_bound", 0.0) > 1.0}
    capped = [r for r in out.values() if r["rho_nudge"] <= 2e-2]
    extra = dict(mesh_strays=strays) if one is not None else {}
    if exact is None:
        extra["port_vs_ref_over_bound_where_rho_within_cap"] = max(
            r["port_vs_ref_over_bound"] for r in capped)
    return dict(case=case, mode=mode, shape=list(batch["image"].shape),
                reference="float64 (norms too)" if exact is not None
                else "the JAX step, float32",
                tensors=len(out),
                over_rho_max=sum(r["rho_nudge"] > 2e-2 for r in out.values()),
                worst={k: {q: round(v, 6) for q, v in out[k].items()}
                       for k in [stem] + worst},
                max={q: max(r[q] for r in out.values()) for q in keys},
                **extra)


if __name__ == "__main__":
    torch.set_num_threads(2)
    args = sys.argv[1:]
    # --steps runs float32 as the tests do (x64 only inside its float64
    # reference); the other modes promote whole models
    jax.config.update("jax_enable_x64", args[:1] != ["--steps"])
    if args[:1] == ["--medformer"]:
        import test_torch_medformer_options as opt

        for case in args[1:] or sorted(opt.CASES):
            print(json.dumps(witness_medformer(case)), flush=True)
    elif args[:1] == ["--steps"]:
        torch.set_num_threads(1)  # as the tests' ranks
        for case in args[1:] or STEP_CASES:
            print(json.dumps(witness_step(case)), flush=True)
    elif args[:1] == ["--dim2"]:
        import test_torch_dim2 as d2

        for arch in args[1:] or sorted(d2.CASES):
            print(json.dumps(witness_dim2(arch)), flush=True)
    else:
        for case in args or sorted(CASES):
            print(json.dumps(witness(case)), flush=True)
