"""Data parallelism of the port (``rsuper_tpu_torch/parallel/``) on the
CPU: two gloo ranks against one process on the global batch and against
the JAX package on a 2-device mesh of the conftest's virtual devices.

Two ranks are launched once (``tests/test_torch_parallel_ranks.py``) and
run every check of this file on their rows r, r + 2, ... of the global
batches while this process computes the references: one JAX compile of
the step's gradient function under the step's shardings on the mesh (the
``ball_dice_last`` step of the tiny MedFormer with both heads, 32³ × 2),
one of the four loss functions on the mesh, one ``shard_map`` of the JAX
``axis_name`` InfoNCE, and the port's own one-process steps.

* The step (``train.step.gradients``), for ``dice``, ``ball_dice_last``
  (item 0 with two reported tumours and so two live ball slots, item 1
  with none: the ranks take different branches), the CLIP step (64³, the
  encoder only) and ``classification_branch``: every rank reports the
  global loss terms, the same bits on both; the terms are within 1e-4·|ref|
  of one process's and every parameter's averaged gradient within
  GRAD_TOL·(‖ref‖ + GRAD_FLOOR·max‖ref‖) of one process's, GRAD_TOL 2e-3,
  6e-3 with the Ball Loss (``tests/test_torch_train.py``,
  ``tests/test_torch_ball_loss.py``); the ``ball_dice_last`` step also
  against JAX's gradient on the mesh at those bounds raised by the ρ rule
  of ``tests/test_torch_spatial.py`` (ρ the JAX step's move under one
  rounding of the image, from the same compiled step).
* The loss functions of the four modes against JAX's on the mesh (4
  items, 16³): the ranks' mean terms within 1e-5·|ref| + 1e-7
  (1e-5·|ref| + 1e-8 with the Ball Loss), the gradient of every model output within 1e-5·max|ref| (1e-4
  with the Ball Loss; the CLIP embeddings' 1e-6·max|ref| + 1e-9), the
  bounds of ``tests/test_torch_losses.py``, ``test_torch_ball_loss.py``
  and ``test_torch_clip.py``. A rank's output gradient is its share's
  backward, which the collectives' backward sums over the ranks: twice
  the global loss's gradient at its rows.
* ``symmetric_info_nce(group=)`` against JAX's ``axis_name`` form under
  ``shard_map``, value and gradient at ``test_torch_clip.py``'s NCE_TOL.
* ZeRO-1: ``zero_partition`` splits the tensors that ``zero_sharding_tree``
  splits, along a dimension of the same size (the same axis on the flax
  layout); three steps with ``zero_opt`` + ``zero_ema`` give the bits of
  three replicated steps (the update is elementwise on the same averaged
  gradient); each mode's checkpoint restores into the other bit for bit
  and the next step matches.
* The CLI in lockstep: two ``python -m rsuper_tpu_torch.train --device cpu
  --dist_*`` processes write identical losses to ``metrics.rank{0,1}.jsonl``,
  within 1e-4·|ref| of one process at the same global batch (the cases are
  the loader's load size, so no crop draw differs), and parameters within
  the lr-unit bounds of ``tests/test_torch_loop.py``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
from rsuper_tpu.losses import dispatcher as jdisp
from rsuper_tpu.losses import info_nce as jnce
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.parallel import make_mesh
from rsuper_tpu.parallel.mesh import zero_sharding_tree
from rsuper_tpu.train.step import loss_fn as jax_loss_fn
from rsuper_tpu_torch.data.dataset import RSuperDataConfig
from rsuper_tpu_torch.models import (flax_from_state_dict, init_params,
                                     params_from_flax)
from rsuper_tpu_torch.parallel import zero_partition
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_parallel_ranks import CLASSES, HEADS, MODES, TINY, model
from test_torch_spatial import _close_grads
from test_torch_spatial_ranks import nudged
from test_torch_train import GRAD_TOL, _unflatten

ROOT = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "test_torch_parallel_ranks.py"
WORLD = 2
S, S_CLIP, S_LOSS, B_LOSS = 32, 64, 16, 4
BALL_GRAD_TOL = 6e-3
LR = 6e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return env


def _masks(rng, B, size, tumours):
    """label / unk / segment_mask / volumes / diameters of B items: item i
    has ``tumours[i]`` reported tumours in a pancreatic-lesion segment (0:
    a voxel-labelled liver lesion instead) and a liver label."""
    C = len(CLASSES)
    q = size // 4
    seg = np.zeros((B, size, size, size, C), np.float32)
    lab = np.zeros_like(seg)
    vols = np.zeros((B, 10), np.float32)
    dias = np.zeros((B, 10, 3), np.float32)
    for i, n in enumerate(tumours):
        lab[i, 1:q + 2, 2:2 * q, q:3 * q, CLASSES.index("liver")] = 1.0
        if n:
            seg[i, q:3 * q, q:3 * q, q - i % 2:3 * q,
                CLASSES.index("pancreatic_lesion")] = 1.0
            v = (size / 32) ** 3
            vols[i, :n] = [500.0 * v, 120.0 * v, 60.0 * v][:n]
            d = size / 32
            dias[i, :n] = [[10 * d, 9 * d, 8 * d], [6 * d, 6 * d, 5 * d],
                           [4 * d, 4 * d, 4 * d]][:n]
        else:
            lab[i, 2 * q:3 * q, 2 * q:3 * q, 2 * q:3 * q,
                CLASSES.index("liver_lesion")] = 1.0
    del rng
    return dict(label=lab, unk=seg.copy(), segment_mask=seg, volumes=vols,
                diameters=dias)


def _inputs():
    rng = np.random.default_rng(0)
    jm = JaxMedFormer(len(CLASSES), dtype=jnp.float32, remat=False, **TINY,
                      **HEADS)
    torch_model = init_params(model(), seed=0)
    state = {k: v.detach().clone() for k, v in
             torch_model.state_dict().items()}
    flat = flax_from_state_dict(state, remat=False)
    batch = dict(image=rng.normal(size=(WORLD, S, S, S, 1)).astype(
        np.float32), **_masks(rng, WORLD, S, [2, 0]))
    clip_batch = dict(
        image=rng.normal(size=(WORLD, S_CLIP, S_CLIP, S_CLIP, 1)).astype(
            np.float32),
        report_embedding=rng.normal(size=(WORLD, 16)).astype(np.float32))
    C = len(CLASSES)
    seg_out = [(2 * rng.normal(size=(B_LOSS, S_LOSS, S_LOSS, S_LOSS, C)))
               .astype(np.float32) for _ in range(2)]
    masks = _masks(rng, B_LOSS, S_LOSS, [2, 0, 1, 0])
    emb = lambda: rng.normal(size=(B_LOSS, 16)).astype(np.float32)  # noqa
    outputs = {"dice": {"segmentation": seg_out},
               "ball_dice_last": {"segmentation": seg_out},
               "classification_branch": {
                   "segmentation": seg_out,
                   "classification": rng.normal(size=(B_LOSS, 2)).astype(
                       np.float32)},
               "clip": {"clip": emb()}}
    loss_batch = {m: masks for m in outputs}
    loss_batch["clip"] = {"report_embedding": emb()}
    return dict(flat=flat, state=state, model=torch_model, jax_model=jm,
                batch=batch, clip_batch=clip_batch, outputs=outputs,
                loss_batch=loss_batch, nce={"ct": emb(), "rep": emb()})


def _jax_refs(d):
    """JAX on a 2-device mesh: the ball_dice_last step's loss and gradient
    under the step's shardings, the four loss functions' terms and output
    gradients, and the axis_name InfoNCE under shard_map."""
    mesh = make_mesh(jax.devices()[:WORLD])
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    lmap = JLesionChannelMap.from_classes(CLASSES)
    out = {}
    jm = d["jax_model"]
    params = jax.device_put({"params": _unflatten(d["flat"])}, repl)
    cfg = jdisp.LossConfig(**dataclasses.asdict(MODES["ball_dice_last"][0]))
    step = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True),
                   static_argnums=(1, 3, 4))
    from flax.traverse_util import flatten_dict

    out["step"] = ()
    for b in (d["batch"], nudged(d["batch"])):
        (_, losses), g = step(params, jm, jax.device_put(
            {k: jnp.asarray(v) for k, v in b.items()}, data), lmap, cfg)
        out["step"] += ({k: float(v) for k, v in losses.items()},
                        {"/".join(k): np.asarray(v)
                         for k, v in flatten_dict(g["params"]).items()})

    def losses_of(outs, batches):
        res = {}
        for mode, (pcfg, clip_only) in MODES.items():
            b = batches[mode]
            cfg = jdisp.LossConfig(**dataclasses.asdict(pcfg))

            def f(o, b=b, cfg=cfg, clip_only=clip_only):
                ls = jdisp.calculate_loss(
                    o, b.get("label"), b.get("unk"), b.get("segment_mask"),
                    b.get("volumes"), b.get("diameters"), lmap, cfg,
                    clip_only=clip_only,
                    report_embeddings=b.get("report_embedding"))
                return ls["overall"], ls

            (_, ls), gs = jax.value_and_grad(f, has_aux=True)(outs[mode])
            res[mode] = (ls, gs)
        return res

    sh = lambda t: jax.device_put(  # noqa: E731
        jax.tree.map(jnp.asarray, t), data)
    ref = jax.jit(losses_of)(sh(d["outputs"]), sh(d["loss_batch"]))
    out["loss"] = {}
    for mode, (ls, gs) in ref.items():
        grads = {k: np.asarray(v) for k, v in gs.items()
                 if not isinstance(v, list)}
        for i, h in enumerate(gs.get("segmentation", [])):
            grads[f"segmentation/{i}"] = np.asarray(h)
        out["loss"][mode] = ({k: float(v) for k, v in ls.items()}, grads)

    nce = jax.shard_map(
        lambda c, r: jnce.symmetric_info_nce(c, r, axis_name="data"),
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P(),
        check_vma=False)  # the gathered loss is the same on every device
    v, (gc, gr) = jax.jit(jax.value_and_grad(nce, argnums=(0, 1)))(
        jnp.asarray(d["nce"]["ct"]), jnp.asarray(d["nce"]["rep"]))
    out["nce"] = (float(v), np.asarray(gc), np.asarray(gr))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results, the port's one-process references (a third
    process) and the JAX references (this one), computed at once."""
    d = _inputs()
    tmp = tmp_path_factory.mktemp("dp")
    torch.save({k: d[k] for k in ("state", "batch", "clip_batch", "outputs",
                                  "loss_batch", "nce")}, tmp / "inputs.pt")
    port = str(_free_port())
    jobs = [["rank", str(r), str(WORLD), port] for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS), *job, str(tmp / "inputs.pt"), str(tmp)],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for job in jobs + [["one"]]]
    try:
        jax_ref = _jax_refs(d)
    finally:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    load = lambda name: torch.load(tmp / f"{name}.pt",  # noqa: E731
                                   weights_only=False)
    return dict(d=d, ranks=[load(f"rank{r}") for r in range(WORLD)],
                one=load("one"), jax=jax_ref, state=d["state"],
                model=d["model"])


def _close_terms(got, want, rtol, what, atol=0.0):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= rtol * abs(float(v)) + atol, \
            (what, k, float(got[k]), float(v))


def _grad_tol(mode):
    return BALL_GRAD_TOL if mode == "ball_dice_last" else GRAD_TOL


@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_report_the_same_global_losses(run, mode):
    (a, _), (b, _) = (r["step"][mode] for r in run["ranks"])
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == torch.float32 and a[k].shape == ()
        assert torch.equal(a[k], b[k]), (mode, k)


@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_step_matches_one_process(run, mode):
    losses, grads = run["ranks"][0]["step"][mode]
    ref_losses, ref_grads = run["one"]["step"][mode]
    _close_terms(losses, ref_losses, 1e-4, mode)
    for r in run["ranks"]:
        _close_grads(r["step"][mode][1], ref_grads, _grad_tol(mode), mode)
    # both ranks hold the same averaged gradient
    other = run["ranks"][1]["step"][mode][1]
    assert all(torch.equal(grads[k], other[k]) for k in grads)
    if mode == "ball_dice_last":  # both branches ran: the ball and none
        assert ref_losses["ball_loss_bce"] > 0
        assert ref_losses["ball_loss_dice"] > 0
    if mode == "clip":  # the decoder's zero gradients reached the average
        outc = [k for k in grads if k.startswith("outc")]
        assert outc and not any(grads[k].any() for k in outc)


def test_two_rank_ball_dice_last_step_matches_jax_mesh(run):
    """Terms at 1e-4·|ref|; gradients per parameter at max(BALL_GRAD_TOL,
    4·min(ρ, RHO_MAX)), ρ the JAX step's own move under one rounding of the
    image. Seeded with flax's truncated draw, the stem conv's gradient
    lies 0.0193 (1.4 % of its norm) from JAX's, past BALL_GRAD_TOL's
    0.0084; one rounding moves JAX's own by ρ = 0.57 %, which raises that
    parameter's bound to 2.3 % (``python tools/zoo_rounding_witness.py
    --steps mf_ball_dice_last``; no float64 reference: the JAX Ball
    Loss's morphology takes float32 only)."""
    losses, grads = run["ranks"][0]["step"]["ball_dice_last"]
    ref_losses, ref_grads, _, moved = run["jax"]["step"]
    _close_terms(losses, ref_losses, 1e-4, "jax mesh")
    want = params_from_flax(ref_grads, run["model"])
    _close_grads(grads, want, BALL_GRAD_TOL, "jax mesh",
                 params_from_flax(moved, run["model"]))


@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_losses_match_jax_mesh(run, mode):
    ref_terms, ref_grads = run["jax"]["loss"][mode]
    ball = mode == "ball_dice_last"
    shares = [res["loss"][mode][0] for res in run["ranks"]]
    terms = {k: sum(float(s[k]) for s in shares) / WORLD for k in shares[0]}
    _close_terms(terms, ref_terms, 1e-5, mode, 1e-8 if ball else 1e-7)
    for r, res in enumerate(run["ranks"]):
        grads = res["loss"][mode][1]
        assert sorted(grads) == sorted(ref_grads)
        for k, want in ref_grads.items():
            want = want[r::WORLD]
            mx = float(np.abs(want).max())
            assert mx > 0, (mode, k)
            got = grads[k].numpy() / WORLD
            tol = (1e-6 * mx + 1e-9 if mode == "clip"
                   else (1e-4 if ball else 1e-5) * mx)
            assert float(np.abs(got - want).max()) <= tol, (mode, k, r)
    # and the one-process port on the whole batch agrees with both
    terms, _ = run["one"]["loss"][mode]
    _close_terms(terms, ref_terms, 1e-5, mode, 1e-8 if ball else 1e-7)


def test_symmetric_info_nce_group_matches_jax_axis_name(run):
    value, g_ct, g_rep = run["jax"]["nce"]
    tol = lambda ref: 1e-6 * float(np.abs(ref).max()) + 1e-9  # noqa: E731
    for r, res in enumerate(run["ranks"]):
        loss, ct, rep = res["nce"]
        assert abs(float(loss) - value) <= tol(value)
        assert float(np.abs(ct.numpy() - g_ct[r::WORLD]).max()) <= tol(g_ct)
        assert float(np.abs(rep.numpy() - g_rep[r::WORLD]).max()) \
            <= tol(g_rep)
    # the axis form is the global loss scaled by the ranks
    from rsuper_tpu_torch.losses import symmetric_info_nce

    one = symmetric_info_nce(torch.from_numpy(run["d"]["nce"]["ct"]),
                             torch.from_numpy(run["d"]["nce"]["rep"]))
    assert abs(WORLD * float(one) - value) <= tol(value)


def test_zero_partition_matches_zero_sharding_tree(run):
    flat = run["d"]["flat"]
    mesh = make_mesh(jax.devices()[:WORLD])
    specs = zero_sharding_tree(mesh, flat)
    jax_axis = {k: next((a for a, s in enumerate(spec.spec) if s), None)
                for k, spec in specs.items()}
    # the same rule on the same (flax-layout) shapes: the same axes
    assert zero_partition({k: np.empty(v.shape) for k, v in flat.items()},
                          WORLD) == jax_axis
    # on the port's layout: the same tensors split, along a dimension of
    # the same size
    mine = zero_partition(run["state"], WORLD)
    def tag(v, a):  # each element's index along the split axis
        if a is None:
            return np.zeros(v.shape, np.float32)
        shape = [-1 if i == a else 1 for i in range(v.ndim)]
        return np.broadcast_to(np.arange(v.shape[a]).reshape(shape),
                               v.shape).astype(np.float32)

    tagged = {k: tag(v, jax_axis[k]) for k, v in flat.items()}
    moved = params_from_flax(tagged, run["model"])
    assert sum(a is not None for a in mine.values()) == \
        sum(a is not None for a in jax_axis.values()) > 0
    for k, t in moved.items():
        a = mine[k]
        varies = [i for i in range(t.dim()) if t.shape[i] > 1 and bool(
            (t.diff(dim=i) != 0).any())]
        if a is None:
            assert not varies, k
        else:
            assert len(varies) == 1 and t.shape[varies[0]] == t.shape[a], k


def test_zero_opt_and_ema_equal_the_replicated_run(run):
    for res in run["ranks"]:
        rep, zero = res["zero"][False], res["zero"][True]
        assert zero["split"] > 0 and rep["split"] == 0
        assert rep["losses"] == zero["losses"]
        a, b = rep["after"], zero["after"]
        assert a["step"] == b["step"] == 3
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), k
            assert torch.equal(a["ema"][k], b["ema"][k]), k
        sa, sb = a["opt"]["state"], b["opt"]["state"]
        assert sorted(sa) == sorted(sb) and len(sa) == len(a["params"])
        for i in sa:
            for n in sa[i]:
                assert torch.equal(sa[i][n], sb[i][n]), (i, n)
    # the ranks hold the same parameters
    p0, p1 = (r["zero"][True]["after"]["params"] for r in run["ranks"])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_checkpoints_resume_across_the_two_modes(run):
    for res in run["ranks"]:
        for zero in (False, True):
            got = res["zero"][zero]["restored"]
            want = res["zero"][not zero]["after"]
            assert got["step"] == want["step"] == 3
            for k in want["params"]:
                assert torch.equal(got["params"][k], want["params"][k]), k
                assert torch.equal(got["ema"][k], want["ema"][k]), k
            for i, st in want["opt"]["state"].items():
                for n, v in st.items():
                    assert torch.equal(got["opt"]["state"][i][n], v), (i, n)
        a, b = res["zero"][False], res["zero"][True]
        assert a["next_loss"] == b["next_loss"]
        for k in a["next_params"]:
            assert torch.equal(a["next_params"][k], b["next_params"][k]), k


# ------------------------------------------------------------ the CLI
def _write_mask_cases(root: Path, n: int = 4):
    """CT-Mask cases exactly the loader's load size for 32³ crops, so every
    crop is the whole case whatever the loader's draws."""
    names = ["background", "liver", "liver_lesion", "pancreas"]
    shape = RSuperDataConfig(classes=tuple(names), report_classes=(),
                             crop_size=(S, S, S)).load_size
    root.mkdir(parents=True)
    (root / "classes.json").write_text(json.dumps(names))
    for k in range(n):
        rng = np.random.default_rng(20 + k)
        lab = np.zeros((len(names), *shape), bool)
        lab[1, 10:30, 20:50, 20:50 - k] = True
        lab[2, 18:24, 30:36, 30:36] = k % 2 == 0
        lab[3, 30:44, 20:40, 30:50] = True
        np.savez_compressed(root / f"BDMAP_M{k}.npz",
                            image=rng.normal(size=shape).astype(np.float32),
                            labels=np.packbits(lab, axis=0),
                            num_classes=len(names))


def _cli(tmp, name, extra):
    cmd = [sys.executable, "-m", "rsuper_tpu_torch.train", "--device", "cpu",
           "--config", str(tmp / "tiny.yaml"), "--data_root",
           str(tmp / "masks"), "--all_train", "--batch_size", "2",
           "--iter_per_epoch", "2", "--epochs", "1", "--max_steps", "2",
           "--unique_name", name, "--cp_path", str(tmp / "exp"), *extra]
    return subprocess.Popen(cmd, env=_env(), cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def test_cli_two_ranks_in_lockstep_match_one_process(tmp_path):
    import yaml

    _write_mask_cases(tmp_path / "masks")
    yaml.safe_dump({"model_args": dict(TINY), "training_size": [S, S, S],
                    "compute_dtype": "float32", "num_workers": 1,
                    "warmup_epochs": 0, "nan_check_every": 1},
                   open(tmp_path / "tiny.yaml", "w"))
    port = _free_port()
    procs = [_cli(tmp_path, "dp", ["--dist_coordinator", f"127.0.0.1:{port}",
                                   "--dist_num_processes", str(WORLD),
                                   "--dist_process_id", str(r),
                                   "--zero_opt", "--zero_ema"])
             for r in range(WORLD)]
    procs.append(_cli(tmp_path, "one", []))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    exp = tmp_path / "exp"
    ranks = [[json.loads(x) for x in open(exp / "dp" / f"metrics.rank{r}"
                                          ".jsonl")] for r in range(WORLD)]
    one = [json.loads(x) for x in open(exp / "one" / "metrics.jsonl")]
    train = lambda recs: [r for r in recs if "train/overall" in r]  # noqa
    a, b, c = train(ranks[0]), train(ranks[1]), train(one)
    assert len(a) == len(b) == len(c) >= 1
    for x, y, z in zip(a, b, c):
        keys = sorted(k for k in z if k.startswith("train/"))
        assert keys == sorted(k for k in x if k.startswith("train/"))
        for k in keys:
            assert x[k] == y[k], k  # lockstep: the same bits
            assert abs(x[k] - z[k]) <= 1e-4 * abs(z[k]) + 1e-7, (k, x[k], z[k])
    assert not (exp / "dp" / "metrics.jsonl").exists()
    assert (exp / "dp" / "tb").exists() and (exp / "dp" / "latest").exists()
    dp = torch.load(exp / "dp" / "latest", weights_only=True)
    ref = torch.load(exp / "one" / "latest", weights_only=True)
    assert dp["step"] == ref["step"] == 2
    assert sorted(dp["opt_state"]["state"]) == sorted(
        ref["opt_state"]["state"])
    diffs = torch.cat([(dp["params"][k] - v).abs().flatten()
                       for k, v in ref["params"].items()])
    assert float(diffs.max()) <= 2 * LR * 2
    assert float(diffs.mean()) <= 0.2 * LR
