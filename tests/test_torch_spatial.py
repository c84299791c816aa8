"""Spatial sharding of the port (``rsuper_tpu_torch/parallel/spatial.py``)
and the deterministic trilinear-resize backward, on the CPU, against the
JAX package and the port's own one-process step.

Gloo ranks are launched once (``tests/test_torch_spatial_ranks.py``, which
imports no JAX) while this process computes the JAX references:

* the ResUNet (base 4) ``dice`` step at 64³ × 2 on a 2×2 (data × model)
  grid of 4 ranks against the JAX ``loss_fn`` on ``make_mesh(devices[:4],
  data=2, model=2)`` with ``spatial_constraint``, as
  ``tests/test_train.py::test_train_step_spatial_sharding`` builds it: the
  loss at that test's rtol 1e-5, the gradients against the step's
  float64 gradient (``_exact_res_grads``) at that test's max|Δg| 5e-4
  raised by the ρ rule below (max-norm, ρ the JAX float32 step's move);
* the tiny MedFormer with both heads at 64×32×32 × 2 (the CLIP step at
  64³) on a 1×2 grid, every mode of ``MODES``, and the classification
  step again at 64³, against the JAX spatial step on a (1, 2) mesh at the
  bound the data-parallel tests hold the step against JAX's 2-device mesh
  (terms 1e-4·|ref|, gradients BALL_GRAD_TOL) or, where one float32
  rounding of the image moves the reference's own gradient more, at the
  chip's ρ rule: per parameter ‖Δg‖ ≤ max(tol, 4·min(ρ, RHO_MAX))·(‖g‖ +
  GRAD_FLOOR·max‖g‖), ρ that move (the classification step at 64×32×32
  only where ρ ≤ RHO_MAX; every tensor at 64³);
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
from test_torch_spatial_ranks import (B, CLS_KEY, MF_CLIP_SHAPE,
                                      MF_CLS_SHAPE, MF_SHAPE, RES_MODES,
                                      RES_SIZE, RESUNET, medformer, nudged,
                                      resunet)
from test_torch_train import GRAD_FLOOR, GRAD_TOL, _unflatten

ROOT = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "test_torch_spatial_ranks.py"
BALL_GRAD_TOL = 6e-3
RHO_MAX = 2e-2  # chip_smoke.py's cap: a larger move would let anything pass
RES_GRAD_ATOL = 5e-4  # tests/test_train.py's max|Δg| of the JAX spatial step
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
                           .astype(np.float32)),
        mf_cls_batch=dict(image=rng.normal(size=(B, *MF_CLS_SHAPE, 1))
                          .astype(np.float32),
                          **_masks(MF_CLS_SHAPE, [2, 0])))


def _jax_step(model, flat, batch, mode, mesh, nudge=False,
              one_device=False):
    """The JAX spatial step's loss terms and gradient (flat); with `nudge`
    also the terms and gradient on the nudged batch (the same compiled
    step); with `one_device` then the same step's gradients on one device,
    unsharded (``_one_device_grads``)."""
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
    if one_device:
        out.append(_one_device_grads(model, flat, batch, cfg, clip_only))
    return out


def _one_device_grads(model, flat, batch, cfg, clip_only):
    """The flat gradients of the JAX step on one device, unsharded, on
    `batch` and on its nudged copy (one compile): the reference that
    ``_close_grads`` takes where the mesh step's gradient strays from it."""
    from flax.traverse_util import flatten_dict

    lmap = JLesionChannelMap.from_classes(CLASSES)
    params = {"params": _unflatten(flat)}
    put = [{k: jnp.asarray(v) for k, v in b.items()}
           for b in (batch, nudged(batch))]
    # LLVM's optimisation level 0 halves the compile, which dominates
    fn = jax.jit(jax.grad(lambda p, b: jax_loss_fn(
        p, model, b, lmap, cfg, False, clip_only)[0])).lower(
            params, put[0]).compile(
                compiler_options={"xla_backend_optimization_level": 0})
    return tuple({"/".join(k): np.asarray(v)
                  for k, v in flatten_dict(fn(params, b)["params"]).items()}
                 for b in put)


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
    jobs = {"res/dice": (res_model, res_flat, d["res_batch"], "dice", mesh4,
                         True)}
    for mode in MODES:
        b = d["mf_clip_batch"] if mode == "clip" else d["mf_batch"]
        jobs[f"mf/{mode}"] = (mf_model, mf_flat, b, mode, mesh2, True)
    jobs[f"mf/{CLS_KEY}"] = (mf_model, mf_flat, d["mf_cls_batch"],
                             "classification_branch", mesh2, True)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_jax_step, *v) for k, v in jobs.items()}
        out = {k: f.result() for k, f in futures.items()}
    # after the threads: it swaps the JAX package's instance norm for a
    # while
    out["res/exact"] = _exact_res_grads(res_flat, d["res_batch"])
    return out


def _norm64(x, eps: float = 1e-4):
    """The instance norm by plain autodiff of its two-pass definition: in
    float64 the JAX package's (whose own statistics stay float32)."""
    axes = tuple(range(1, x.ndim - 1))
    mean = x.mean(axes, keepdims=True)
    var = ((x - mean) ** 2).mean(axes, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps)


def _exact_res_grads(flat, batch):
    """The flat gradient of the JAX ResUNet ``dice`` step in float64 on one
    device (``jax_enable_x64``, parameters, batch and instance norms in
    float64): the value that both packages' float32 steps approximate."""
    from flax.traverse_util import flatten_dict

    cfg = jdisp.LossConfig(**dataclasses.asdict(MODES["dice"][0]))
    lmap = JLesionChannelMap.from_classes(CLASSES)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "instance_norm", _norm64)
        model = jax_get_model("resunet", len(CLASSES), dict(RESUNET),
                              dtype=jnp.float64)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        {"params": _unflatten(flat)})
        b = {k: jnp.asarray(v, jnp.float64 if v.dtype.kind == "f" else None)
             for k, v in batch.items()}
        g = jax.jit(jax.grad(lambda p: jax_loss_fn(
            p, model, b, lmap, cfg)[0]))(params)
    return {"/".join(k): np.asarray(v, np.float32)
            for k, v in flatten_dict(g["params"]).items()}


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


def _grad_bound(want, moved, k, tol, top):
    """Parameter k's bound tol·(‖g‖ + GRAD_FLOOR·top), tol raised to
    4·min(ρ, RHO_MAX) by the move ρ of g under the nudge; and ρ."""
    w, t, rho = want[k], tol, None
    if moved is not None:
        rho = float((moved[k] - w).norm() / w.norm().clamp_min(1e-30))
        t = max(tol, 4.0 * min(rho, RHO_MAX))
    return t * (float(w.norm()) + GRAD_FLOOR * top), rho


def _close_grads(got, want, tol, what, moved=None, one=None,
                 within_cap=False):
    """Per parameter ‖Δg‖ ≤ tol·(‖g‖ + GRAD_FLOOR·max‖g‖); with `moved`
    (the reference's gradients on the nudged batch) tol is raised to
    4·min(ρ, RHO_MAX), ρ the parameter's relative move. With `one` (the
    same JAX step on one device, unsharded: its gradients on the batch and
    on the nudged batch), where the mesh and the one-device gradients lie
    further apart than the tighter of their two bounds (JAX's two
    partitionings disagree, as the references alone show), the one-device
    gradient is a second reference at its own bound, ρ its own move, and
    the parameter passes within the bound of either. With `within_cap`
    only the parameters whose ρ ≤ RHO_MAX are held. Returns the worst
    ratio of error to bound."""
    top = max(float(w.norm()) for w in want.values())
    assert top > 0
    if one is not None:
        top1 = max(float(w.norm()) for w in one[0].values())
    worst = 0.0
    for k, w in want.items():
        refs = [(w, *_grad_bound(want, moved, k, tol, top), "reference")]
        if within_cap and refs[0][2] > RHO_MAX:
            continue
        if one is not None:
            b1 = _grad_bound(one[0], one[1], k, tol, top1)
            if float((w - one[0][k]).norm()) > min(refs[0][1], b1[0]):
                refs.append((one[0][k], *b1, "one device"))
        ratio, why = min(
            (float((got[k] - ref).norm()) / bound,
             f"‖g‖ {float(ref.norm())}, bound {bound}, ρ {rho}, {name}")
            for ref, bound, rho, name in refs)
        assert ratio <= 1.0, f"{what} {k}: ‖Δ‖/bound {ratio} ({why})"
        worst = max(worst, ratio)
    return worst


def test_ranks_sit_on_the_jax_meshs_grid(run):
    """rank = d·S + m: (data rank, data size, model rank, model size)."""
    assert [r["place"] for r in run["res"]] == [
        (0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]
    assert [r["place"] for r in run["mf"]] == [(0, 1, 0, 2), (0, 1, 1, 2)]
    assert [r["place"] for r in run["units"]] == [(0, 1, m, 4)
                                                  for m in range(4)]


def test_resunet_2x2_step_matches_jax_spatial_step(run):
    """Only the loss is held against the JAX spatial step itself (float32,
    rtol 1e-5); each parameter's gradient within max|Δg| ≤ max(5e-4,
    4·min(ρ, RHO_MAX)·max|g|) of that step's float64 gradient g
    (``_exact_res_grads``), ρ = max|moved − g32| / max|g|, the JAX float32
    step's move under one rounding of the image (≤ 2.7e-3). ρ is read on
    the float32 step because it stands for the float32 noise that a
    rounding stirs up, which the port's float32 step carries and the
    float64 step has none of.

    The bound was max|Δg| < 5e-4 against the JAX float32 step. Seeded with
    flax's truncated draw, the port's gradient lies 1.29e-3 from that
    step's, and the JAX float32 gradient is the one off: on XLA:CPU it lies
    up to 10.6 % of max|g| from float64 (2.0 % at the stem), the port's
    one-process float32 gradient within 0.093 %; in float64, norms too,
    the two packages agree within 1e-6 (``python
    tools/zoo_rounding_witness.py --steps res_dice``)."""
    losses, grads = run["res"][0]["dice"]
    ref_losses, ref_grads, _, moved = run["jax"]["res/dice"]
    assert np.isclose(float(losses["overall"]), ref_losses["overall"],
                      rtol=1e-5, atol=1e-6)
    model = resunet(run["d"]["res_state"])
    want, moved, exact = (params_from_flax(g, model) for g in (
        ref_grads, moved, run["jax"]["res/exact"]))
    for k, g in exact.items():
        top = float(g.abs().max())
        rho = float((moved[k] - want[k]).abs().max()) / top
        bound = max(RES_GRAD_ATOL, 4.0 * min(rho, RHO_MAX) * top)
        gmax = float((grads[k] - g).abs().max())
        assert gmax <= bound, (k, gmax, bound, top, rho)


@pytest.mark.parametrize("mode", list(MODES) + [CLS_KEY])
def test_medformer_1x2_step_matches_jax_spatial_step(run, mode):
    """Each mode's terms and gradients against the JAX spatial step by the
    ρ rule (``_close_grads`` with the nudged gradients), the bound as
    before the truncated draw, and the classification step again at 64³
    (``CLS_KEY``). The classification step's gradients at 64×32×32 only
    where ρ ≤ RHO_MAX (before: on every tensor): its head normalises two
    voxels, and on the model seeded with flax's truncated draw ρ exceeds
    RHO_MAX on 81 of 164 tensors (6.6 % at the stem, up to 9.7 % in the
    head), where the capped bound means nothing (the port's gap there is
    up to 2.3 times it, against the one-device JAX step 2.2 times); on the
    others the port's largest gap is 0.47 of its bound. At 64³ the head
    normalises 8 voxels, ρ exceeds RHO_MAX only on a bias whose gradient
    is below 1e-6 of the largest norm, and every tensor is held: the
    port's largest gap is 0.25 of its bound (``python
    tools/zoo_rounding_witness.py --steps mf_classification_branch
    mf_classification_branch_64``)."""
    losses, grads = run["mf"][0][mode]
    ref_losses, ref_grads, _, moved = run["jax"][f"mf/{mode}"]
    _close_terms(losses, ref_losses, 1e-4, mode)
    m = medformer(run["d"]["mf_state"])
    _close_grads(grads, params_from_flax(ref_grads, m), BALL_GRAD_TOL, mode,
                 params_from_flax(moved, m),
                 within_cap=mode == "classification_branch")


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
