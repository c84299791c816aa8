"""Spatial sharding of the 3D zoo (the MBConv UNet, V-Net, Attention U-Net,
UNet++, UNETR, SwinUNETR, nnFormer, VT-UNet), on the CPU, against the JAX
package's spatial step; ``tests/test_torch_spatial_mf.py`` holds the
MedFormer configurations with the helpers of this file.

Gloo ranks are launched once a file (``tests/test_torch_spatial_zoo_ranks.py``,
which imports no JAX): here a 1 × 2 grid runs the ``dice`` step of every
arch at 64×32×32 × 1 (job ``zoo``), a 2 × 2 grid the MBConv UNet's at
batch 2 (job ``2x2``). Meanwhile this process compiles, once a case, the
JAX ``loss_fn`` with
``spatial_constraint`` on ``make_mesh(data, model)`` of the conftest's
virtual CPU devices, as ``tests/test_torch_spatial.py`` builds it (LLVM's
optimisation level 0: the compiles dominate), and runs it on the batch
and, for a case the ρ rule bounds, on the batch with its image moved by one
float32 rounding, and then the same step on one device, unsharded, on both.

Bounds, float32 on both sides:
* loss terms: 1e-4·|ref|, ``tests/test_torch_spatial.py``'s;
* gradients, per parameter ‖Δg‖ ≤ tol·(‖g‖ + GRAD_FLOOR·max‖g‖):
  - the instance-normed conv nets of CONV_NETS at CONV_GRAD_TOL,
    ``tests/test_torch_zoo.py``'s (their float32 gradients lie up to ~2 %
    from float64 on both sides, ``tools/zoo_rounding_witness.py``);
  - V-Net and the transformers at GRAD_TOL, ``tests/test_torch_zoo.py``'s
    (V-Net's largest ‖Δg‖ / (‖g‖ + GRAD_FLOOR·max‖g‖) seen is 4.9e-4,
    within GRAD_TOL alone), and the MedFormers at BALL_GRAD_TOL,
  ``tests/test_torch_spatial.py``'s, each raised by the ρ rule where one
  rounding of the image moves the reference's own gradient more: tol =
  max(tol, 4·min(ρ, RHO_MAX)), ρ the parameter's relative move; where
  the JAX mesh step's gradient and the same step's on one device,
  unsharded, lie further apart than the tighter of their bounds, the
  one-device gradient is a second reference at its own bound
  (``_close_grads``'s `one`). On the model seeded with flax's truncated
  draw, ``mf_attention_up2``'s mesh step lies 0.7 to 1.8 % from its
  one-device step wherever the port's sharded step lies past its bound
  from the mesh step (up to 2.9 times it), and the port's sharded step
  lies within 0.36 of the bound from the one-device step on every tensor
  (``python tools/zoo_rounding_witness.py --steps mf_attention_up2``, for
  the one-process step);
* every rank's terms and gradients the same bits.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
from rsuper_tpu.losses import dispatcher as jdisp
from rsuper_tpu.models import get_model as jax_get_model
from rsuper_tpu.parallel import make_mesh
from rsuper_tpu.parallel.mesh import spatial_constraint
from rsuper_tpu.train.step import loss_fn as jax_loss_fn
from rsuper_tpu_torch.models import (flax_from_state_dict, init_params,
                                     params_from_flax)
from test_torch_parallel_ranks import CLASSES, MODES
from test_torch_spatial import (BALL_GRAD_TOL, _close_grads, _close_terms,
                                _env, _free_port, _masks, _one_device_grads)
from test_torch_spatial_ranks import nudged
from test_torch_spatial_zoo_ranks import JOBS, SHAPE, ZOO, zoo_model
from test_torch_train import GRAD_TOL, _unflatten
from test_torch_zoo import CONV_GRAD_TOL

ROOT = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "test_torch_spatial_zoo_ranks.py"
CONV_NETS = ("unet_mbconv", "attention_unet", "unetpp")
JOBS_HERE = ("zoo", "2x2")


def _inputs(jobs):
    rng = np.random.default_rng(0)
    cases = sorted({c for j in jobs for c in JOBS[j][0]})
    d = {"state": {c: {k: v.detach().clone() for k, v in init_params(
        zoo_model(c), seed=0).state_dict().items()} for c in cases}}
    for job in jobs:
        cases, batch, _, _ = JOBS[job]
        d[job] = {c: dict(image=rng.normal(size=(batch, *SHAPE, 1))
                          .astype(np.float32),
                          **_masks(SHAPE, [2, 0][:batch])) for c in cases}
    return d


def _jax_step(case, flat, batch, mesh):
    """The JAX spatial ``dice`` step's loss terms and flat gradient on
    `batch`, then, for a case the ρ rule bounds, on its nudged copy, from
    one compile, and the same step's gradients on one device, unsharded,
    on both (``_one_device_grads``)."""
    from flax.traverse_util import flatten_dict

    arch, args = ZOO[case]
    if arch == "medformer":
        args = {**args, "remat": False}
    model = jax_get_model(arch, len(CLASSES), dict(args), dtype=jnp.float32)
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
           for b in ((batch,) if case in CONV_NETS
                     else (batch, nudged(batch)))]
    fn = jax.jit(g).lower(params, put[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    out = []
    for b in put:
        (_, losses), grads = fn(params, b)
        out += [{k: float(v) for k, v in losses.items()},
                {"/".join(k): np.asarray(v)
                 for k, v in flatten_dict(grads["params"]).items()}]
    if case not in CONV_NETS:
        out.append(_one_device_grads(model, flat, batch, cfg, clip_only))
    return out


def _jax_refs(d, jobs):
    jobs_ = {}
    for job in jobs:
        cases, _, world, S = JOBS[job]
        mesh = make_mesh(jax.devices()[:world], data=world // S, model=S)
        jobs_.update({(job, c): (c, flax_from_state_dict(d["state"][c]),
                                 d[job][c], mesh) for c in cases})
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(_jax_step, *v) for k, v in jobs_.items()}
        return {k: f.result() for k, f in futures.items()}


def launch(tmp_path_factory, jobs):
    """Every rank's results of `jobs` (launched at once) and the JAX
    references, computed meanwhile."""
    d = _inputs(jobs)
    tmp = tmp_path_factory.mktemp("spatial_zoo")
    torch.save(d, tmp / "inputs.pt")
    procs = []
    for job in jobs:
        port = str(_free_port())
        procs += [subprocess.Popen(
            [sys.executable, str(RANKS), job, str(r), port,
             str(tmp / "inputs.pt"), str(tmp)],
            env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(JOBS[job][2])]
    try:
        jax_ref = _jax_refs(d, jobs)
    finally:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = {job: [torch.load(tmp / f"{job}{r}.pt", weights_only=False)
                   for r in range(JOBS[job][2])] for job in jobs}
    return dict(jax=jax_ref, ranks=ranks)


def cases(jobs):
    return [(job, c) for job in jobs for c in JOBS[job][0]]


def check_places(run, job):
    """rank = d·S + m: (data rank, data size, model rank, model size)."""
    _, _, world, S = JOBS[job]
    assert [r["place"] for r in run["ranks"][job]] == [
        (r // S, world // S, r % S, S) for r in range(world)]


def check_step(run, job, case):
    losses, grads = run["ranks"][job][0][case]
    ref_losses, ref_grads, *nudge = run["jax"][(job, case)]
    _close_terms(losses, ref_losses, 1e-4, f"{job} {case}")
    m = zoo_model(case)
    want = params_from_flax(ref_grads, m)
    assert sorted(grads) == sorted(want)
    if case in CONV_NETS:
        _close_grads(grads, want, CONV_GRAD_TOL, f"{job} {case}")
    else:
        tol = BALL_GRAD_TOL if ZOO[case][0] == "medformer" else GRAD_TOL
        _close_grads(grads, want, tol, f"{job} {case}",
                     params_from_flax(nudge[1], m),
                     tuple(params_from_flax(g, m) for g in nudge[2]))


def check_bits(run, job, case):
    (a, ga), *others = [r[case] for r in run["ranks"][job]]
    for b, gb in others:
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a), case
        assert all(torch.equal(ga[k], gb[k]) for k in ga), case


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return launch(tmp_path_factory, JOBS_HERE)


@pytest.mark.parametrize("job", JOBS_HERE)
def test_ranks_sit_on_the_jax_meshs_grid(run, job):
    check_places(run, job)


@pytest.mark.parametrize("job,case", cases(JOBS_HERE))
def test_sharded_step_matches_jax_spatial_step(run, job, case):
    check_step(run, job, case)


@pytest.mark.parametrize("job,case", cases(JOBS_HERE))
def test_every_rank_holds_the_same_bits(run, job, case):
    check_bits(run, job, case)
