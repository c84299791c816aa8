"""Spatial sharding of the port (``rsuper_tpu_torch/parallel/spatial.py``)
and the deterministic trilinear-resize backward, on the CPU, against the
JAX package and the port's own one-process step.

Gloo ranks are launched once (``tests/test_torch_spatial_ranks.py``, which
imports no JAX) while this process computes the JAX references:

* the ResUNet (base 4) ``dice`` step at 64³ × 2 on a 2×2 (data × model)
  grid of 4 ranks against the JAX ``loss_fn`` on ``make_mesh(devices[:4],
  data=2, model=2)`` with ``spatial_constraint``, as
  ``tests/test_train.py::test_train_step_spatial_sharding`` builds it, at
  that test's bounds (loss rtol 1e-5, max|Δg| < 5e-4);
* the tiny MedFormer with both heads at 64×32×32 × 2 (the CLIP step at
  64³) on a 1×2 grid, every mode of ``MODES``, against the JAX spatial step
  on a (1, 2) mesh at the bound the data-parallel tests hold the step
  against JAX's 2-device mesh (terms 1e-4·|ref|, gradients BALL_GRAD_TOL)
  or, where one float32 rounding of the image moves the reference's own
  gradient more, at the chip's ρ rule: per parameter ‖Δg‖ ≤ max(tol,
  4·min(ρ, RHO_MAX))·(‖g‖ + GRAD_FLOOR·max‖g‖), ρ that move;
* both models' sharded steps against the port's one-process step (an item
  at a time, ``PerItem``): losses 1e-4·|ref|, gradients at GRAD_TOL, by
  the same ρ rule for the MedFormer;
* every rank's logged terms and gradients the same bits; the model
  group's gathered logits bit-equal; ``remat`` changes no bit;
* the unit checks of the ranks (the 1×2 grid's, and a 1×4 grid's whose
  middle ranks have two neighbours): the collectives and the float64
  layers within F64_TOL of their unsharded selves, the float32 ones within
  F32_TOL.

The resize's backward (``layers._Resize``) equals autograd of
``F.interpolate`` in float64 and the VJP of the JAX resize in float32.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
from rsuper_tpu.losses import dispatcher as jdisp
from rsuper_tpu.models import get_model as jax_get_model
from rsuper_tpu.models import layers as jlayers
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.parallel import make_mesh
from rsuper_tpu.parallel.mesh import spatial_constraint
from rsuper_tpu.train.step import loss_fn as jax_loss_fn
from rsuper_tpu_torch.models import (flax_from_state_dict, init_params,
                                     params_from_flax)
from rsuper_tpu_torch.models import layers
from test_torch_parallel_ranks import CLASSES, HEADS, MODES, TINY
from test_torch_spatial_ranks import (B, MF_CLIP_SHAPE, MF_SHAPE, RES_MODES,
                                      RES_SIZE, RESUNET, medformer, nudged,
                                      resunet)
from test_torch_train import GRAD_FLOOR, GRAD_TOL, _unflatten

ROOT = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "test_torch_spatial_ranks.py"
BALL_GRAD_TOL = 6e-3
RHO_MAX = 2e-2  # chip_smoke.py's cap: a larger move would let anything pass
F64_TOL, F32_TOL = 1e-12, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return env


def _masks(shape, tumours):
    """label / unk / segment_mask / volumes / diameters: item i has
    ``tumours[i]`` reported tumours in a pancreatic-lesion segment (0: a
    voxel-labelled liver lesion instead) and a liver label."""
    C, n = len(CLASSES), len(tumours)
    d, h, w = shape
    seg = np.zeros((n, d, h, w, C), np.float32)
    lab = np.zeros_like(seg)
    vols = np.zeros((n, 10), np.float32)
    dias = np.zeros((n, 10, 3), np.float32)
    for i, k in enumerate(tumours):
        lab[i, 1:d // 3, 2:h // 2, w // 4:3 * w // 4,
            CLASSES.index("liver")] = 1.0
        if k:
            seg[i, d // 4:3 * d // 4, h // 4:3 * h // 4, w // 4:3 * w // 4,
                CLASSES.index("pancreatic_lesion")] = 1.0
            vols[i, :k] = [300.0, 80.0, 40.0][:k]
            dias[i, :k] = [[9, 8, 7], [5, 5, 4], [4, 4, 3]][:k]
        else:
            lab[i, d // 2:3 * d // 4, h // 2:3 * h // 4, w // 2:3 * w // 4,
                CLASSES.index("liver_lesion")] = 1.0
    return dict(label=lab, unk=seg.copy(), segment_mask=seg, volumes=vols,
                diameters=dias)


def _inputs():
    rng = np.random.default_rng(0)
    res = init_params(resunet(), seed=0)
    mf = init_params(medformer(), seed=0)
    state = lambda m: {k: v.detach().clone()  # noqa: E731
                       for k, v in m.state_dict().items()}
    return dict(
        res_state=state(res), mf_state=state(mf),
        res_batch=dict(image=rng.normal(size=(B, *(RES_SIZE,) * 3, 1))
                       .astype(np.float32),
                       **_masks((RES_SIZE,) * 3, [2, 0])),
        mf_batch=dict(image=rng.normal(size=(B, *MF_SHAPE, 1))
                      .astype(np.float32), **_masks(MF_SHAPE, [2, 0])),
        mf_clip_batch=dict(image=rng.normal(size=(B, *MF_CLIP_SHAPE, 1))
                           .astype(np.float32),
                           report_embedding=rng.normal(size=(B, 16))
                           .astype(np.float32)))


def _jax_step(model, flat, batch, mode, mesh, nudge=False):
    """The JAX spatial step's loss terms and gradient (flat); with `nudge`
    also the gradient on the nudged batch (the same compiled step)."""
    from flax.traverse_util import flatten_dict

    pcfg, clip_only = MODES[mode]
    cfg = jdisp.LossConfig(**dataclasses.asdict(pcfg))
    lmap = JLesionChannelMap.from_classes(CLASSES)
    data = NamedSharding(mesh, P("data"))

    @jax.jit
    def g(params, batch):
        batch = spatial_constraint(batch, mesh)
        return jax.value_and_grad(jax_loss_fn, has_aux=True)(
            params, model, batch, lmap, cfg, False, clip_only, None, mesh)

    params = jax.device_put({"params": _unflatten(flat)},
                            NamedSharding(mesh, P()))
    out = []
    for b in (batch, nudged(batch)) if nudge else (batch,):
        (_, losses), grads = g(params, jax.device_put(
            {k: jnp.asarray(v) for k, v in b.items()}, data))
        out += [{k: float(v) for k, v in losses.items()},
                {"/".join(k): np.asarray(v)
                 for k, v in flatten_dict(grads["params"]).items()}]
    return out


def _jax_refs(d):
    """The ResUNet dice step on the 2×2 mesh and the MedFormer's four
    modes on the (1, 2) mesh, compiled at once in threads."""
    res_model = jax_get_model("resunet", len(CLASSES), dict(RESUNET),
                              dtype=jnp.float32)
    mf_model = JaxMedFormer(len(CLASSES), dtype=jnp.float32, remat=False,
                            **TINY, **HEADS)
    mesh4 = make_mesh(jax.devices()[:4], data=2, model=2)
    mesh2 = make_mesh(jax.devices()[:2], data=1, model=2)
    res_flat = flax_from_state_dict(d["res_state"])
    mf_flat = flax_from_state_dict(d["mf_state"], remat=False)
    jobs = {"res/dice": (res_model, res_flat, d["res_batch"], "dice", mesh4)}
    for mode in MODES:
        b = d["mf_clip_batch"] if mode == "clip" else d["mf_batch"]
        jobs[f"mf/{mode}"] = (mf_model, mf_flat, b, mode, mesh2, True)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_jax_step, *v) for k, v in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results, the port's one-process references (a further
    process) and the JAX references (this one), computed at once."""
    d = _inputs()
    tmp = tmp_path_factory.mktemp("spatial")
    torch.save(d, tmp / "inputs.pt")
    jobs = [["rank", "res", str(r), "4", "2", None] for r in range(4)]
    jobs += [["rank", "mf", str(r), "2", "2", None] for r in range(2)]
    jobs += [["rank", "units", str(r), "4", "4", None] for r in range(4)]
    ports = {k: str(_free_port()) for k in ("res", "mf", "units")}
    for job in jobs:
        job[-1] = ports[job[1]]
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS), *job, str(tmp / "inputs.pt"), str(tmp)],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for job in jobs + [["one", "res"], ["one", "mf"]]]
    try:
        jax_ref = _jax_refs(d)
    finally:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    load = lambda n: torch.load(tmp / f"{n}.pt",  # noqa: E731
                                weights_only=False)
    return dict(d=d, jax=jax_ref, one=dict(res=load("one_res"),
                                           mf=load("one_mf")),
                res=[load(f"res{r}") for r in range(4)],
                mf=[load(f"mf{r}") for r in range(2)],
                units=[load(f"units{r}") for r in range(4)])


def _close_terms(got, want, rtol, what, atol=0.0):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= rtol * abs(float(v)) + atol, \
            (what, k, float(got[k]), float(v))


def _close_grads(got, want, tol, what, moved=None):
    """Per parameter ‖Δg‖ ≤ tol·(‖g‖ + GRAD_FLOOR·max‖g‖); with `moved`
    (the reference's gradients on the nudged batch) tol is raised to
    4·min(ρ, RHO_MAX), ρ the parameter's relative move. Returns the worst
    ratio of error to bound."""
    top = max(float(w.norm()) for w in want.values())
    assert top > 0
    worst = 0.0
    for k, w in want.items():
        err = float((got[k] - w).norm())
        t = tol
        if moved is not None:
            rho = float((moved[k] - w).norm() / w.norm().clamp_min(1e-30))
            t = max(tol, 4.0 * min(rho, RHO_MAX))
        bound = t * (float(w.norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{what} {k}: ‖Δ‖ {err} > {bound}"
        worst = max(worst, err / bound)
    return worst


def test_ranks_sit_on_the_jax_meshs_grid(run):
    """rank = d·S + m: (data rank, data size, model rank, model size)."""
    assert [r["place"] for r in run["res"]] == [
        (0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]
    assert [r["place"] for r in run["mf"]] == [(0, 1, 0, 2), (0, 1, 1, 2)]
    assert [r["place"] for r in run["units"]] == [(0, 1, m, 4)
                                                  for m in range(4)]


def test_resunet_2x2_step_matches_jax_spatial_step(run):
    losses, grads = run["res"][0]["dice"]
    ref_losses, ref_grads = run["jax"]["res/dice"]
    assert np.isclose(float(losses["overall"]), ref_losses["overall"],
                      rtol=1e-5, atol=1e-6)
    model = resunet(run["d"]["res_state"])
    want = params_from_flax(ref_grads, model)
    gmax = max(float((grads[k] - w).abs().max()) for k, w in want.items())
    assert gmax < 5e-4, gmax


@pytest.mark.parametrize("mode", list(MODES))
def test_medformer_1x2_step_matches_jax_spatial_step(run, mode):
    losses, grads = run["mf"][0][mode]
    ref_losses, ref_grads, _, moved = run["jax"][f"mf/{mode}"]
    _close_terms(losses, ref_losses, 1e-4, mode)
    m = medformer(run["d"]["mf_state"])
    _close_grads(grads, params_from_flax(ref_grads, m), BALL_GRAD_TOL, mode,
                 params_from_flax(moved, m))


CASES = [("res", m) for m in RES_MODES] + [("mf", m) for m in MODES]


@pytest.mark.parametrize("model,mode", CASES)
def test_sharded_step_matches_one_process(run, model, mode):
    losses, grads = run[model][0][mode]
    ref_losses, ref_grads = run["one"][model][mode]
    _close_terms(losses, ref_losses, 1e-4, mode)
    moved = run["one"][model].get(f"{mode}/nudged", (None, None))[1]
    _close_grads(grads, ref_grads, GRAD_TOL, f"{model} {mode}", moved)
    if mode == "ball_dice_last":  # the ball and the empty branch both ran
        assert ref_losses["ball_loss_bce"] > 0


@pytest.mark.parametrize("model,mode", CASES)
def test_every_rank_holds_the_same_bits(run, model, mode):
    (a, ga), *others = [r[mode] for r in run[model]]
    for b, gb in others:
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a), (model, mode)
        assert all(torch.equal(ga[k], gb[k]) for k in ga), (model, mode)


def test_model_group_logits_bit_equal_and_remat_changes_nothing(run):
    (l0, a0), (l1, a1) = (r["logits"] for r in run["mf"])
    assert l0.shape[1:4] == a0.shape[1:4] == MF_SHAPE
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for r in run["mf"]:
        (a, ga), (b, gb) = r["dice"], r["dice_remat"]
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(ga[k], gb[k]) for k in ga)


UNITS = ["halo_zeros_11", "halo_zeros_01", "halo_zeros_21", "halo_drop_11",
         "halo_drop_01", "halo_drop_21", "shard_depth", "gather_depth",
         "reduce_sum", "conv_k3_s1", "conv_k3_s2", "conv_k1_s1",
         "conv_k2_s2", "resize_x2", "resize_x4", "resize_x1",
         "resize_align_corners", "resize_cf_x2", "conv_transpose_k2_s2"]
# float32 inside whatever the input: the norm's statistics, the CUDA
# kernels' plain versions, the SE mean, softmax and LayerNorm
UNITS32 = ["instance_norm", "conv3x3x3_cf", "in_relu_conv3x3x3_cf",
           "in_stats_cf", "in_relu_bwd", "in_relu_conv_plain",
           "depthwise_conv3x3x3", "se_block", "mbconv", "fused_mbconv",
           "token_stage", "per_voxel"]


@pytest.mark.parametrize("job", ["mf", "units"], ids=["S2", "S4"])
@pytest.mark.parametrize("name", UNITS + UNITS32)
def test_sharded_layer_matches_its_unsharded_self(run, name, job):
    tol = F32_TOL if name in UNITS32 else F64_TOL
    for r in run[job]:
        errs = r["units"][name]
        assert errs and max(errs) <= tol, (name, job, errs)


# ------------------------------------------------ the resize's backward
RESIZES = [((4, 5, 6), (8, 10, 12)), ((4, 5, 6), (16, 20, 24)),
           ((5, 7, 3), (11, 9, 4)), ((7, 5, 6), (4, 3, 6))]


@pytest.mark.parametrize("cf", [False, True], ids=["cl", "cf"])
@pytest.mark.parametrize("align_corners", [False, True], ids=["half", "ac"])
@pytest.mark.parametrize("sizes", RESIZES, ids=["x2", "x4", "odd", "down"])
def test_resize_backward_equals_autograd_of_interpolate(sizes, align_corners,
                                                        cf):
    """float64: the contraction with the interpolation matrices equals
    autograd of ``F.interpolate`` (the forward is the same call)."""
    (d, h, w), size = sizes
    g = torch.Generator().manual_seed(0)
    shape = (2, d, 3, h, w) if cf else (2, d, h, w, 3)
    x = torch.randn(shape, dtype=torch.float64, generator=g)
    fn = layers.resize_trilinear_cf if cf else layers.resize_trilinear
    xa = x.clone().requires_grad_()
    y = fn(xa, size, align_corners)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    y.backward(gy)
    xb = x.clone().requires_grad_()
    perm = (0, 2, 1, 3, 4) if cf else (0, 4, 1, 2, 3)
    back = (0, 2, 1, 3, 4) if cf else (0, 2, 3, 4, 1)
    ref = F.interpolate(xb.permute(*perm), size=size, mode="trilinear",
                        align_corners=align_corners).permute(*back)
    assert torch.equal(y.detach(), ref.detach())
    ref.backward(gy)
    assert float((xa.grad - xb.grad).abs().max()) <= 1e-12


@pytest.mark.parametrize("cf", [False, True], ids=["cl", "cf"])
@pytest.mark.parametrize("align_corners", [False, True], ids=["half", "ac"])
@pytest.mark.parametrize("sizes", RESIZES[:3], ids=["x2", "x4", "odd"])
def test_resize_backward_matches_jax_vjp(sizes, align_corners, cf):
    """float32, upsampling (the JAX half-pixel resize antialiases when it
    shrinks): the VJP of the JAX resize on the same input and cotangent,
    within 1e-6·max|ref|."""
    (d, h, w), size = sizes
    rng = np.random.default_rng(1)
    shape = (2, d, 3, h, w) if cf else (2, d, h, w, 3)
    x = rng.normal(size=shape).astype(np.float32)
    out = (2, size[0], 3, size[1], size[2]) if cf else (2, *size, 3)
    gy = rng.normal(size=out).astype(np.float32)
    jfn = jlayers.resize_trilinear_cf if cf else jlayers.resize_trilinear
    _, vjp = jax.vjp(lambda t: jfn(t, size, align_corners), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    fn = layers.resize_trilinear_cf if cf else layers.resize_trilinear
    xt = torch.from_numpy(x).requires_grad_()
    fn(xt, size, align_corners).backward(torch.from_numpy(gy))
    err = float(np.abs(xt.grad.numpy() - want).max())
    assert err <= 1e-6 * float(np.abs(want).max()), err
