"""The rank side of ``tests/test_torch_spatial_2d.py``: the 2D pathway's
archs with their rows sharded, on gloo ranks on the CPU with PyTorch alone
(every rank is a fresh interpreter that imports this file, which imports
no JAX).

``python tests/test_torch_spatial_2d_ranks.py JOB RANK PORT INPUTS OUT``
joins the gloo job JOB of ``JOBS`` (its ranks in a ``(WORLD / S) × S``
grid) at 127.0.0.1:PORT and writes what it saw to ``OUT/JOB{RANK}.pt``:
for each case of the job, the ``dice`` step's global loss terms and
reduced gradients (``train.step.gradients``) of the data rank's items of
the case's batch, and a 2D head gathered at the model/loss boundary
(``gathered``). ``... one INPUTS OUT`` writes the port's one-process steps
of job ``archs`` to ``OUT/one.pt``.

The cases (``ARCHS``): every name of the 2D registry at the widths of
``tests/test_torch_dim2.py`` on 64² slices, whose deepest map keeps 2 rows
a shard at S = 2 (the JAX loop's rule); ``resunet_2d`` with the
``slices/resunet_2d`` preset's own model arguments.

Below: the loop's guard counts rows in 2D, and a sharded max pool
refuses an odd run of rows.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from test_torch_parallel_ranks import CLASSES  # noqa: E402
from test_torch_spatial_ranks import rows, step  # noqa: E402

SIZE = (64, 64)
PRESET = "slices/resunet_2d"
# case → model args
ARCHS = {
    "unet_2d": dict(base_chan=4),
    "resunet_2d": None,  # the preset's
    "attention_unet_2d": dict(base_chan=4),
    "dual_attention_unet_2d": dict(base_chan=4),
    "transunet_2d": dict(base_chan=4, hidden=16, depth=2, heads=2),
    "swin_unet_2d": dict(embed_dim=8, depths=(2, 2, 2, 1),
                         num_heads=(2, 2, 2, 2)),
    "unetpp_2d": dict(base_chan=4, depth=3),
    "medformer_2d": dict(base_chan=4, num_heads=(1, 2, 2, 2, 2, 2, 1, 1),
                         fusion_dim=16, fusion_heads=2, aux_loss=True,
                         map_size=4),
}
# job → (its cases, the global batch, ranks, model ranks S): every arch on
# a 1 × 2 grid at batch 2, the UNet on 2 × 2 at batch 2
JOBS = {"archs": (tuple(ARCHS), 2, 2, 2),
        "2x2": (("unet_2d",), 2, 4, 2)}


def model_args(case: str) -> dict:
    if ARCHS[case] is not None:
        return {**ARCHS[case], "img_size": SIZE}
    from rsuper_tpu_torch.config import load_config

    return dict(load_config(PRESET).model_args)


def arch_model(case: str, state=None):
    """The case's model in float32 with `state` loaded."""
    from rsuper_tpu_torch.models import get_model

    m = get_model(case, len(CLASSES), model_args(case), dtype=torch.float32)
    if state is not None:
        m.load_state_dict(state)
    return m


def masks2d(n: int):
    """A 2D batch's label (a liver and a lesion a slice, each slice's
    placed apart), and the zeros of unk / segment_mask / volumes /
    diameters that ``SliceDataset`` gives every record."""
    h, w = SIZE
    lab = np.zeros((n, h, w, len(CLASSES)), np.float32)
    for i in range(n):
        lab[i, 4 + 6 * i:h // 2, 8:w - 8, CLASSES.index("liver")] = 1.0
        lab[i, h // 2:h // 2 + 10, 20 + 4 * i:36,
            CLASSES.index("liver_lesion")] = 1.0
    return dict(label=lab, unk=np.zeros_like(lab),
                segment_mask=np.zeros_like(lab),
                volumes=np.zeros((n, 10), np.float32),
                diameters=np.zeros((n, 10, 3), np.float32))


def gathered(sp) -> dict:
    """``gather_segmentation`` of the rank's rows of a (B, H, W, C) head,
    alone and in a list beside a (B, C) head, and what it should give."""
    from rsuper_tpu_torch.parallel.spatial import (gather_segmentation,
                                                   shard_depth)

    whole = torch.arange(2 * 8 * 3 * 2, dtype=torch.float32).reshape(
        2, 8, 3, 2)
    mine, other = shard_depth(whole, sp), torch.ones(2, 5)
    seg = lambda s: gather_segmentation(  # noqa: E731
        {"segmentation": s}, sp, mine.shape[1])["segmentation"]
    return dict(whole=whole, other=other, single=seg(mine),
                list=seg([mine, other]))


def run_rank(job: str, rank: int, port: int, inputs: str, out: str):
    import torch.distributed as dist

    from rsuper_tpu_torch.parallel.mesh import forget_grids, grid
    from rsuper_tpu_torch.parallel.multihost import local_rows

    cases, batch, world, S = JOBS[job]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        dp = grid(S)
        data = torch.load(inputs, weights_only=False)
        mine = local_rows(batch, dp.rank, dp.world)
        res = {case: step(arch_model(case, data["state"][case]),
                          rows(data[job][case], mine), "dice", dp)
               for case in cases}
        res["place"] = (dp.rank, dp.world, dp.spatial.rank, dp.spatial.size)
        res["gather"] = gathered(dp.spatial)
        torch.save(res, os.path.join(out, f"{job}{rank}.pt"))
    finally:
        forget_grids()
        dist.destroy_process_group()


def run_one(inputs: str, out: str):
    """The port's one-process ``dice`` step of every case of job ``archs``
    on its whole batch (``OUT/one.pt``)."""
    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    torch.save({case: step(arch_model(case, data["state"][case]),
                           rows(data["archs"][case], slice(None)), "dice")
                for case in JOBS["archs"][0]}, os.path.join(out, "one.pt"))


# ------------------------------------------------------- checks without JAX
def test_the_2d_guard_keeps_the_jax_loops_message():
    """The JAX loop's guard counts rows in 2D: 96 // 16 = 6 rows keep 2 a
    shard at S = 2, not at S = 4."""
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.train import loop

    loop.check_config(load_config(PRESET, overrides={
        "spatial_shard": 2, "training_size": (96, 96)}))
    with pytest.raises(ValueError, match=r"spatial_shard 4 too large for "
                       r"depth 96: the deepest feature map \(6 planes\)"):
        loop.check_config(load_config(PRESET, overrides={
            "spatial_shard": 4, "training_size": (96, 96)}))


def test_an_odd_run_of_rows_refuses_the_max_pool():
    """flax floors an odd size: a sharded 2×2 max pool needs an even run
    of rows."""
    from rsuper_tpu_torch.models.dim2 import max_pool2d
    from rsuper_tpu_torch.parallel.spatial import Spatial

    x = torch.zeros(1, 3, 4, 2)
    assert max_pool2d(x).shape == (1, 1, 2, 2)
    with pytest.raises(ValueError, match="even run of rows, got 3"):
        max_pool2d(x, Spatial(rank=0, size=2))


if __name__ == "__main__":
    if sys.argv[1] == "one":
        run_one(sys.argv[2], sys.argv[3])
    else:
        run_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                 sys.argv[4], sys.argv[5])
