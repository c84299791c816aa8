"""Spatial sharding of the 2D pathway (rows over the model group) and the
deterministic bilinear-resize backward, on the CPU, against the JAX
package.

Gloo ranks are launched once a file (``tests/test_torch_spatial_2d_ranks.py``,
which imports no JAX): a 1 × 2 grid runs the float32 ``dice`` step of
every 2D arch at 64² × 2 (job ``archs``), a 2 × 2 grid the UNet's (job
``2x2``). Meanwhile this process compiles, once a case, the JAX
``loss_fn`` with ``spatial_constraint`` (rows of (B, H, W, C) over
``model``) on ``make_mesh(data, model)`` of the conftest's virtual CPU
devices, as ``tests/test_torch_spatial_zoo.py`` does for the 3D zoo (LLVM's
optimisation level 0: the compiles dominate), and runs it on the batch and
on the batch with its image moved by one float32 rounding.

A further process runs the port's one-process step of every case of
``archs`` on the whole batch.

Bounds, float32 on both sides:
* loss terms: 1e-4·|ref|;
* gradients, per parameter ‖Δg‖ ≤ tol·(‖g‖ + GRAD_FLOOR·max‖g‖) with
  tol = max(floor, 4·min(ρ, RHO_MAX)), ρ the parameter's relative move
  under one rounding of the image in the JAX step (the ρ rule of
  ``tests/test_torch_spatial.py``: the seeded 2D MedFormer moves its
  float32 gradients by a few hundredths under one rounding). The floor is
  GRAD_TOL, against the JAX step and against the port's one process,
  except for the preset's UNet (base 32) against JAX: PRESET_GRAD_TOL,
  since there the port's one-process step lies 2.0e-3 from the JAX step
  on ``BasicBlock2D_6.ConvNormAct2D_0.Conv_0.weight`` already, where ρ is
  5e-5 (float32 sums over eight times base 4's channels, in another
  order; ``tests/test_torch_dim2.py`` holds the 2D conv nets against JAX
  at 6e-2), and its sharded step is held to its one process at GRAD_TOL;
* every rank's terms and gradients the same bits.

The resize's backward (``layers._Resize`` on (B, C, H, W)) equals autograd
of ``F.interpolate(bilinear)`` in float64 and the VJP of the JAX 2D models'
resize in float32, at an upsampling and at the non-integer ratios of the
decoders' odd skips.
"""

import dataclasses
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
from rsuper_tpu.models.dim2 import _resize2d as jax_resize2d
from rsuper_tpu.parallel import make_mesh
from rsuper_tpu.parallel.mesh import spatial_constraint
from rsuper_tpu.train.step import loss_fn as jax_loss_fn
from rsuper_tpu_torch.models import (flax_from_state_dict, init_params,
                                     params_from_flax)
from rsuper_tpu_torch.models import layers
from rsuper_tpu_torch.models.dim2 import resize2d
from test_torch_parallel_ranks import CLASSES, MODES
from test_torch_spatial import _close_grads, _close_terms, _env, _free_port
from test_torch_spatial_2d_ranks import (ARCHS, JOBS, SIZE, arch_model,
                                         masks2d, model_args)
from test_torch_spatial_ranks import nudged
from test_torch_train import GRAD_TOL, _unflatten

ROOT = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "test_torch_spatial_2d_ranks.py"
PRESET_GRAD_TOL = 4e-3


def _inputs():
    rng = np.random.default_rng(0)
    state = {}
    for c in ARCHS:
        m = init_params(arch_model(c), seed=0)
        for name, p in m.named_parameters():  # DANet's gates: let them count
            if name.endswith("gamma"):
                p.data.fill_(0.5)
        state[c] = {k: v.detach().clone() for k, v in m.state_dict().items()}
    d = {"state": state}
    for job, (cases, batch, _, _) in JOBS.items():
        d[job] = {c: dict(image=rng.normal(size=(batch, *SIZE, 1))
                          .astype(np.float32), **masks2d(batch))
                  for c in cases}
    return d


def _jax_step(case, flat, batch, mesh):
    """The JAX spatial ``dice`` step's loss terms and flat gradient on
    `batch` and on its nudged copy, from one compile."""
    from flax.traverse_util import flatten_dict

    args = {k: v for k, v in model_args(case).items() if k != "img_size"}
    model = jax_get_model(case, len(CLASSES), args, dtype=jnp.float32)
    pcfg, clip_only = MODES["dice"]
    cfg = jdisp.LossConfig(**dataclasses.asdict(pcfg))
    lmap = JLesionChannelMap.from_classes(CLASSES)

    def g(params, batch):
        batch = spatial_constraint(batch, mesh)
        return jax.value_and_grad(jax_loss_fn, has_aux=True)(
            params, model, batch, lmap, cfg, False, clip_only, None, mesh)

    params = jax.device_put({"params": _unflatten(flat)},
                            NamedSharding(mesh, P()))
    data = NamedSharding(mesh, P("data"))
    put = [jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, data)
           for b in (batch, nudged(batch))]
    fn = jax.jit(g).lower(params, put[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    out = []
    for b in put:
        (_, losses), grads = fn(params, b)
        out += [{k: float(v) for k, v in losses.items()},
                {"/".join(k): np.asarray(v)
                 for k, v in flatten_dict(grads["params"]).items()}]
    return out


def _jax_refs(d):
    jobs = {}
    for job, (cases, _, world, S) in JOBS.items():
        mesh = make_mesh(jax.devices()[:world], data=world // S, model=S)
        jobs.update({(job, c): (c, flax_from_state_dict(
            d["state"][c], model=arch_model(c)), d[job][c], mesh)
            for c in cases})
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(_jax_step, *v) for k, v in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results and the JAX references, computed meanwhile."""
    d = _inputs()
    tmp = tmp_path_factory.mktemp("spatial_2d")
    torch.save(d, tmp / "inputs.pt")
    procs = []
    for job, (_, _, world, _) in JOBS.items():
        port = str(_free_port())
        procs += [subprocess.Popen(
            [sys.executable, str(RANKS), job, str(r), port,
             str(tmp / "inputs.pt"), str(tmp)],
            env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    procs.append(subprocess.Popen(
        [sys.executable, str(RANKS), "one", str(tmp / "inputs.pt"),
         str(tmp)], env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    try:
        jax_ref = _jax_refs(d)
    finally:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = {job: [torch.load(tmp / f"{job}{r}.pt", weights_only=False)
                   for r in range(JOBS[job][2])] for job in JOBS}
    return dict(d=d, jax=jax_ref, ranks=ranks,
                one=torch.load(tmp / "one.pt", weights_only=False))


CASES = [(job, c) for job in JOBS for c in JOBS[job][0]]


@pytest.mark.parametrize("job", list(JOBS))
def test_ranks_sit_on_the_jax_meshs_grid(run, job):
    """rank = d·S + m: (data rank, data size, model rank, model size)."""
    _, _, world, S = JOBS[job]
    assert [r["place"] for r in run["ranks"][job]] == [
        (r // S, world // S, r % S, S) for r in range(world)]


@pytest.mark.parametrize("job,case", CASES)
def test_sharded_2d_step_matches_jax_spatial_step(run, job, case):
    losses, grads = run["ranks"][job][0][case]
    ref_losses, ref_grads, _, moved = run["jax"][(job, case)]
    _close_terms(losses, ref_losses, 1e-4, f"{job} {case}")
    m = arch_model(case)
    want = params_from_flax(ref_grads, m)
    assert sorted(grads) == sorted(want)
    _close_grads(grads, want,
                 PRESET_GRAD_TOL if case == "resunet_2d" else GRAD_TOL,
                 f"{job} {case}", params_from_flax(moved, m))


@pytest.mark.parametrize("case", JOBS["archs"][0])
def test_sharded_2d_step_matches_one_process(run, case):
    losses, grads = run["ranks"]["archs"][0][case]
    ref_losses, ref_grads = run["one"][case]
    _close_terms(losses, ref_losses, 1e-4, case)
    moved = params_from_flax(run["jax"][("archs", case)][3],
                             arch_model(case))
    _close_grads(grads, ref_grads, GRAD_TOL, case, moved)


@pytest.mark.parametrize("job,case", CASES)
def test_every_rank_holds_the_same_2d_bits(run, job, case):
    (a, ga), *others = [r[case] for r in run["ranks"][job]]
    for b, gb in others:
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a), case
        assert all(torch.equal(ga[k], gb[k]) for k in ga), case


def test_gather_segmentation_gathers_2d_heads(run):
    """The model/loss boundary gathers every (B, H, W, C) head of the
    rank's rows, in a list too, and leaves the others as they are."""
    for r in run["ranks"]["archs"]:
        g = r["gather"]
        assert torch.equal(g["single"], g["whole"])
        assert torch.equal(g["list"][0], g["whole"])
        assert torch.equal(g["list"][1], g["other"])


# ------------------------------------------------ the resize's backward
RESIZES = [((4, 6), (8, 12)), ((3, 3), (5, 6)), ((5, 7), (11, 9)),
           ((7, 6), (4, 3))]


@pytest.mark.parametrize("align_corners", [False, True], ids=["half", "ac"])
@pytest.mark.parametrize("sizes", RESIZES, ids=["x2", "odd", "ratio",
                                                "down"])
def test_resize2d_backward_equals_autograd_of_interpolate(sizes,
                                                          align_corners):
    """float64: the taps' transpose equals autograd of ``F.interpolate``
    (bilinear; the forward is the same call)."""
    (h, w), size = sizes
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, h, w, 3), dtype=torch.float64, generator=g)
    xa = x.clone().requires_grad_()
    y = layers.resize_linear(xa, size, align_corners)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    y.backward(gy)
    xb = x.clone().requires_grad_()
    ref = F.interpolate(xb.permute(0, 3, 1, 2), size=size, mode="bilinear",
                        align_corners=align_corners).permute(0, 2, 3, 1)
    assert torch.equal(y.detach(), ref.detach())
    ref.backward(gy)
    assert float((xa.grad - xb.grad).abs().max()) <= 1e-12


@pytest.mark.parametrize("sizes", RESIZES[:3], ids=["x2", "odd", "ratio"])
def test_resize2d_backward_matches_jax_vjp(sizes):
    """float32, upsampling (the JAX half-pixel resize antialiases when it
    shrinks): ``dim2.resize2d``'s backward is the VJP of the JAX 2D
    models' resize on the same input and cotangent, within
    1e-6·max|ref|."""
    (h, w), size = sizes
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    gy = rng.normal(size=(2, *size, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_resize2d(t, size), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    xt = torch.from_numpy(x).requires_grad_()
    resize2d(xt, size).backward(torch.from_numpy(gy))
    err = float(np.abs(xt.grad.numpy() - want).max())
    assert err <= 1e-6 * float(np.abs(want).max()), err


# ------------------------------------------- the 2D conv's backward
CONVS = {  # (c_in, features, kernel, stride, groups, input (H, W))
    "k3": (3, 5, 3, 1, 1, (9, 8)),
    "k3s2_even": (3, 5, 3, 2, 1, (8, 8)),
    "k3s2_odd": (3, 5, 3, 2, 1, (9, 7)),
    "k4s4": (1, 4, 4, 4, 1, (8, 12)),
    "depthwise": (6, 6, 3, 1, 6, (7, 9)),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_conv2d_backward_equals_autograd_of_conv2d(name):
    """float64: ``layers.Conv(nd=2)``'s backward (``convolution_backward``
    with cuDNN held to its deterministic algorithms) gives the input,
    weight and bias gradients of autograd through ``F.pad`` and
    ``F.conv2d`` with flax's SAME pads."""
    c_in, c, k, s, groups, (h, w) = CONVS[name]
    g = torch.Generator().manual_seed(0)
    conv = layers.Conv(c_in, c, k, s, True, torch.float64, groups,
                       nd=2).double()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        conv.bias.copy_(torch.randn(c, generator=g))
    x = torch.randn((2, h, w, c_in), dtype=torch.float64, generator=g)
    xa = x.clone().requires_grad_()
    y = conv(xa)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    y.backward(gy)
    got = [xa.grad, conv.weight.grad, conv.bias.grad]
    xb = x.clone().requires_grad_()
    wb = conv.weight.detach().double().requires_grad_()
    bb = conv.bias.detach().double().requires_grad_()
    pads = [p for n in (w, h) for p in layers.same_pads(n, k, s)]
    ref = F.conv2d(F.pad(xb.movedim(-1, 1), pads), wb, bb, s,
                   groups=groups).movedim(1, -1)
    assert float((y.detach() - ref.detach()).abs().max()) <= 1e-12
    ref.backward(gy)
    for a, b in zip(got, [xb.grad, wb.grad, bb.grad]):
        assert float((a - b).abs().max()) <= 1e-12 * (
            1 + float(b.abs().max())), name
