"""The rank side of the data-parallel tests, and the parallel helpers' own
checks, on the CPU with PyTorch alone (no JAX: every rank is a fresh
interpreter and imports this file).

``python tests/test_torch_parallel_ranks.py rank RANK WORLD PORT INPUTS
OUT`` joins a gloo job of WORLD ranks at 127.0.0.1:PORT, runs every check
of ``tests/test_torch_parallel.py`` on its rows of the global batches in
INPUTS (``torch.save`` of the parameters and the batches) and writes what
it saw to ``OUT/rank{RANK}.pt``; ``... one INPUTS OUT`` writes the
one-process references of ``step`` and ``loss`` to ``OUT/one.pt``:

* ``step``: for each mode of ``MODES``, the global loss terms and every
  parameter's averaged gradient of ``train.step.gradients`` at the global
  batch's rows r, r + world, ...;
* ``loss``: for each mode, the terms of ``calculate_loss(group=)`` on this
  rank's rows of given model outputs and the outputs' gradients;
* ``nce``: ``symmetric_info_nce(group=)`` (the JAX ``axis_name`` form) on
  this rank's rows of given embeddings, and their gradients;
* ``zero``: three steps replicated and three with ZeRO-1 of the optimizer
  and the EMA copy: the losses, the parameters, the whole EMA copy and the
  whole optimizer state after each run, and the states that the other
  mode's checkpoint restores.

Below, the helpers' checks that need no job: the ZeRO-1 split rule, the
data axis's size, each rank's rows and draws, the device ids, and the
entry points that must raise without CUDA.
"""

import copy
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig  # noqa: E402
from rsuper_tpu_torch.parallel import mesh, multihost  # noqa: E402

TINY = dict(
    base_chan=4,
    chan_num=(8, 16, 32, 40, 32, 16, 8, 4),
    conv_num=(2, 0, 0, 0, 0, 0, 2, 2),
    trans_num=(0, 1, 2, 1, 1, 1, 0, 0),
    num_heads=(1, 2, 2, 2, 2, 2, 1, 1),
    fusion_depth=1,
    fusion_dim=40,
    fusion_heads=2,
    expansion=2,
)
HEADS = dict(classification_classes=2, clip_branch=True, clip_feats=16)
CLASSES = ["background", "liver", "liver_lesion", "pancreatic_lesion"]
LMAP = LesionChannelMap.from_classes(CLASSES)
# mode → (LossConfig, clip_only)
MODES = {
    "dice": (LossConfig(loss="dice"), False),
    "ball_dice_last": (LossConfig(), False),
    "classification_branch": (LossConfig(loss="dice",
                                         classification_branch=True), False),
    "clip": (LossConfig(), True),
}
OPT = dict(base_lr=6e-4, warmup_epochs=0, max_epochs=100,
           steps_per_epoch=1000)


def model(state=None):
    """The tiny MedFormer with both heads, float32, no remat."""
    from rsuper_tpu_torch.models import get_model

    m = get_model("medformer", len(CLASSES), {**TINY, **HEADS,
                                              "remat": False},
                  dtype=torch.float32)
    if state is not None:
        m.load_state_dict(state)
    return m


def rows(batch, idx):
    """The items `idx` of a batch of numpy arrays, as tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[idx]))
            for k, v in batch.items()}


def _cat(outs):
    """One output of the items' outputs, item by item."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _cat([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_cat([o[j] for o in outs]) for j in range(len(first))]
    return torch.cat(outs)


class PerItem(torch.nn.Module):
    """`m` run an item at a time, as each rank runs it on its one item: the
    model computes per item, but the CPU's kernels round otherwise at batch
    1 than at batch 2 (1e-5 of the logits here, which the random tiny model
    amplifies to 4e-3 of a gradient), which is not what data parallelism
    is held to. The CLIP step's ``encoder`` passes the image on and
    ``branches`` runs both per item."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, x):
        return _cat([self.m(x[i:i + 1]) for i in range(x.shape[0])])

    def encoder(self, x):
        return [None] * 4 + [x]

    def branches(self, x):
        return _cat([self.m.branches(self.m.encoder(x[i:i + 1])[4])
                     for i in range(x.shape[0])])


def step_grads(state, batch, mode, group=None, per_item=False):
    """(global loss terms, every parameter's gradient) of one step; with
    `per_item` the model runs an item at a time (``PerItem``)."""
    from rsuper_tpu_torch.train.step import gradients

    cfg, clip_only = MODES[mode]
    m = model(state)
    losses = gradients(PerItem(m) if per_item else m, batch, LMAP, cfg,
                       clip_only=clip_only, group=group)
    return ({k: v.clone() for k, v in losses.items()},
            {k: p.grad.clone() for k, p in m.named_parameters()})


def loss_grads(outputs, batch, mode, group=None):
    """(loss terms, gradients of the model outputs) of ``calculate_loss``."""
    from rsuper_tpu_torch.losses import calculate_loss

    cfg, clip_only = MODES[mode]
    out = {k: (torch.from_numpy(v).requires_grad_() if not isinstance(v, list)
               else [torch.from_numpy(h).requires_grad_() for h in v])
           for k, v in outputs.items()}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = calculate_loss(out, t.get("label"), t.get("unk"),
                            t.get("segment_mask"), t.get("volumes"),
                            t.get("diameters"), LMAP, cfg,
                            clip_only=clip_only,
                            report_embeddings=t.get("report_embedding"),
                            group=group)
    losses["overall"].backward()
    leaves = ({k: v for k, v in out.items() if not isinstance(v, list)}
              | {f"segmentation/{i}": h
                 for i, h in enumerate(out.get("segmentation", []))})
    return ({k: v.detach().clone() for k, v in losses.items()},
            {k: v.grad.clone() for k, v in leaves.items()
             if v.grad is not None})


def _zero_runs(data, dp, exp):
    """Three steps replicated and three with zero_opt + zero_ema; each
    run's checkpoint restored into the other mode."""
    from rsuper_tpu_torch.train import make_optimizer
    from rsuper_tpu_torch.train.checkpoint import CheckpointManager
    from rsuper_tpu_torch.train.optim import ZeroOptimizer
    from rsuper_tpu_torch.train.state import create_train_state
    from rsuper_tpu_torch.train.step import build_train_step

    batch = rows(data["batch"], slice(dp.rank, None, dp.world))
    step = build_train_step(LMAP, MODES["dice"][0], group=dp)

    def fresh(zero):
        m = model(data["state"])
        opt = make_optimizer(m.parameters(), **OPT)
        if zero:
            axes = mesh.zero_partition(dict(m.named_parameters()), dp.world)
            opt = ZeroOptimizer(opt, list(axes.values()), dp)
        return create_train_state(m, opt, dp=dp, zero_ema=zero)

    def snapshot(state):
        return dict(params={k: v.detach().clone() for k, v in
                            state.model.state_dict().items()},
                    ema={k: v.clone() for k, v in state.full_ema().items()},
                    opt=copy.deepcopy(state.optimizer.state_dict()),
                    step=state.step)

    out = {}
    for zero in (False, True):
        state = fresh(zero)
        losses = []
        for _ in range(3):
            state, ls = step(state, batch)
            losses.append(float(ls["overall"]))
        ckpt = CheckpointManager(os.path.join(exp, f"zero{int(zero)}"))
        ckpt.save_epoch(state, 0)
        ckpt.wait()
        out[zero] = dict(losses=losses, after=snapshot(state),
                         split=sum(a is not None for a in
                                   (state.ema_axes or {}).values()))
    for zero in (False, True):  # each mode resumes the other's checkpoint
        state = fresh(zero)
        CheckpointManager(os.path.join(exp, f"zero{int(not zero)}")).restore(
            state)
        restored = snapshot(state)
        state, ls = step(state, batch)
        out[zero]["restored"] = restored
        out[zero]["next_loss"] = float(ls["overall"])
        out[zero]["next_params"] = snapshot(state)["params"]
    return out


def run_rank(rank: int, world: int, port: int, inputs: str, out: str):
    import torch.distributed as dist

    from rsuper_tpu_torch.losses import symmetric_info_nce

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        dp = mesh.DataParallel(rank=rank, world=world)
        data = torch.load(inputs, weights_only=False)
        mine = slice(rank, None, world)
        res = {"step": {}, "loss": {}}
        for mode in MODES:
            b = data["clip_batch"] if mode == "clip" else data["batch"]
            res["step"][mode] = step_grads(data["state"], rows(b, mine),
                                           mode, dp)
            o, b = data["outputs"][mode], data["loss_batch"][mode]
            res["loss"][mode] = loss_grads(
                {k: [h[mine] for h in v] if isinstance(v, list) else v[mine]
                 for k, v in o.items()},
                {k: np.ascontiguousarray(v[mine]) for k, v in b.items()},
                mode, dp)
        ct, rep = (torch.from_numpy(data["nce"][k][mine]).requires_grad_()
                   for k in ("ct", "rep"))
        loss = symmetric_info_nce(ct, rep, group=dp)
        loss.backward()
        res["nce"] = (loss.detach(), ct.grad, rep.grad)
        res["zero"] = _zero_runs(data, dp, os.path.join(out, "exp"))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize("shape,world,axis", [
    ((3, 3, 3, 64, 64), 2, 3),       # the first of the equal largest
    ((64, 64, 3, 3, 3), 2, 0),
    ((27, 40, 40), 8, 1),
    ((2000, 15), 2, 0),
    ((999, 17), 2, None),            # no dimension divides
    ((129, 131), 2, None),
    ((200, 100), 3, None),
    ((100, 100), 2, None),           # below min_size
    ((16383,), 1, None),             # below min_size
    ((16384,), 1, 0),
    ((8, 2048), 4, 1),
    ((8, 2050), 4, 0),
    ((), 2, None),
])
def test_zero_partition_rule(shape, world, axis):
    got = mesh.zero_partition({"p": torch.empty(shape)}, world)
    assert got == {"p": axis}


@pytest.mark.parametrize("batch,devices,k", [
    (2, 1, 1), (2, 2, 2), (2, 4, 2), (2, 8, 2), (6, 4, 2), (8, 8, 8),
    (3, 8, 1), (12, 8, 4)])
def test_data_parallel_size_is_the_jax_loops_gcd(batch, devices, k):
    assert mesh.data_parallel_size(batch, devices) == k


def test_local_rows_follow_the_samplers_round_robin():
    from rsuper_tpu_torch.data.sampler import ChunkedSampler

    one = ChunkedSampler(10, 8, seed=3).epoch_indices(0)
    for world in (1, 2, 4):
        for r in range(world):
            mine = ChunkedSampler(10, 8, shard=r, num_shards=world,
                                  seed=3).epoch_indices(0)
            per = 4 // world  # global batch 4 → local batches
            for i in range(2):
                rows_r = multihost.local_rows(4, r, world)
                np.testing.assert_array_equal(
                    mine[i * per:(i + 1) * per], one[i * 4 + rows_r])
    with pytest.raises(ValueError, match="divide"):
        multihost.local_rows(3, 0, 2)


def test_draws_take_the_rows_of_the_global_batch():
    from rsuper_tpu_torch.data.pipeline import draw_augment

    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    d = draw_augment(g(), g(), 4, (6, 6, 6))
    part = d.take(np.array([1, 3]))
    for name in ("theta", "affine_coin", "coins", "multiply", "additive",
                 "gamma", "contrast", "sigma", "noise_std"):
        np.testing.assert_array_equal(getattr(part, name),
                                      getattr(d, name)[[1, 3]])
    assert torch.equal(part.noise, d.noise[[1, 3]])


def test_local_device_ids_take_one_id():
    assert multihost.local_device_id(None) is None
    assert multihost.local_device_id("3") == 3
    for bad in ("0,1", "", ","):
        with pytest.raises(ValueError, match="exactly one device id"):
            multihost.local_device_id(bad)
    with pytest.raises(ValueError, match="exactly one device id"):
        multihost.init_distributed("127.0.0.1:1", 1, 0, "0,1", device="cpu")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_data_parallel_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """``--dist_*`` and the local spawner ask for CUDA unless ``--device
    cpu``: without it they raise before any process group or rank."""
    import torch.distributed as dist

    from rsuper_tpu_torch.train import __main__ as cli

    base = ["--data_root", str(tmp_path), "--batch_size", "2"]
    dist_flags = ["--dist_coordinator", "127.0.0.1:1",
                  "--dist_num_processes", "2", "--dist_process_id", "0"]
    for argv in (base, base + dist_flags,
                 base + dist_flags + ["--local_device_ids", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.init_distributed("127.0.0.1:1", 2, 0)
    assert not dist.is_initialized()


def test_dist_flags_need_a_coordinator(tmp_path):
    from rsuper_tpu_torch.train import __main__ as cli

    for flags in (["--dist_num_processes", "1"], ["--dist_process_id", "0"],
                  ["--local_device_ids", "0"]):
        with pytest.raises(ValueError, match="need --dist_coordinator"):
            cli.main(["--data_root", str(tmp_path), "--device", "cpu",
                      *flags])
    with pytest.raises(ValueError, match="needs --dist_num_processes"):
        cli.main(["--data_root", str(tmp_path), "--device", "cpu",
                  "--dist_coordinator", "127.0.0.1:1"])


def test_spawner_runs_gcd_ranks(monkeypatch, capsys):
    """Without ``--dist_*`` on a host of 8 cards, batch 2 spawns 2 ranks,
    each named as rank r of 2 on card r, and prints the JAX loop's line."""
    import torch.multiprocessing as mp

    from rsuper_tpu_torch.train import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    seen = {}

    def spawn(fn, args, nprocs, join):
        seen.update(fn=fn, args=args, nprocs=nprocs, join=join)

    monkeypatch.setattr(mp, "spawn", spawn)
    assert cli.main(["--batch_size", "2"]) is None
    assert seen["nprocs"] == 2 and seen["join"]
    assert "[train] using a 2x1 (data x model) mesh over 8 devices " \
           "(batch 2)" in capsys.readouterr().out
    argv, world, port = seen["args"]
    calls = []
    monkeypatch.setattr(cli, "main", lambda a: calls.append(a))
    seen["fn"](1, argv, world, port)
    assert calls[0][-8:] == ["--dist_coordinator", f"127.0.0.1:{port}",
                             "--dist_num_processes", "2",
                             "--dist_process_id", "1",
                             "--local_device_ids", "1"]


def run_one(inputs: str, out: str):
    """The one-process references on the whole batches."""
    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    res = {"step": {}, "loss": {}}
    for mode in MODES:
        b = data["clip_batch"] if mode == "clip" else data["batch"]
        res["step"][mode] = step_grads(data["state"], rows(b, slice(None)),
                                       mode, per_item=True)
        res["loss"][mode] = loss_grads(data["outputs"][mode],
                                       data["loss_batch"][mode], mode)
    torch.save(res, os.path.join(out, "one.pt"))


if __name__ == "__main__":
    if sys.argv[1] == "one":
        run_one(*sys.argv[2:4])
    else:
        r, w, p = (int(a) for a in sys.argv[2:5])
        run_rank(r, w, p, sys.argv[5], sys.argv[6])
