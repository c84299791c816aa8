"""The rank side of ``tests/test_torch_spatial_zoo.py``: the 3D archs that
shard beside the default MedFormer and the plain UNets, on gloo ranks on
the CPU with PyTorch alone (every rank is a fresh interpreter that imports
this file, which imports no JAX).

``python tests/test_torch_spatial_zoo_ranks.py JOB RANK PORT INPUTS OUT``
joins the gloo job JOB of ``JOBS`` (its ranks in a ``(WORLD / S) × S``
grid) at 127.0.0.1:PORT and writes what it saw to ``OUT/JOB{RANK}.pt``:
for each case of the job, the ``dice`` step's global loss terms and
reduced gradients (``train.step.gradients``) of the data rank's items of
the case's batch.

The cases (``ZOO``): ``tests/test_torch_zoo.py``'s widths, MedFormer's
``TINY`` ones, at 64 planes deep: the deepest map of every arch keeps 2
planes a shard at S = 2, the JAX loop's rule.

Below: the training CLI through its local spawner with ``--spatial_shard
2`` for two archs of the zoo, against one process.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from test_torch_parallel_ranks import CLASSES, TINY  # noqa: E402
from test_torch_spatial_ranks import (_env, _finish, _train_records,  # noqa: E402
                                      _write_cases, rows, step)

SHAPE = (64, 32, 32)
# case → (arch, model args)
ZOO = {
    # chip_smoke.py's mf_mbconv at TINY's widths: MBConv stages
    # (channels-last, the depthwise kernel's plain version here) sharded
    # beside attention
    "mf_mbconv": ("medformer", {**TINY, "conv_block": "MBConv",
                                "conv_num": (2, 1, 1, 1, 1, 1, 2, 2),
                                "proj_type": "linear", "act": "gelu"}),
    # attention in UpBlockMF_2: gathered, run whole, sharded again
    "mf_attention_up2": ("medformer", {
        **TINY, "trans_num": (0, 1, 2, 1, 1, 1, 1, 0),
        "chan_num": (8, 16, 32, 40, 32, 16, 16, 4)}),
    "unet_mbconv": ("unet", dict(base_chan=4, block="MBConv")),
    "vnet": ("vnet", dict(base_chan=4)),
    "attention_unet": ("attention_unet", dict(base_chan=4)),
    "unetpp": ("unetpp", dict(base_chan=4, depth=3)),
    "unetr": ("unetr", dict(img_size=SHAPE, hidden_size=32, mlp_dim=64,
                            num_heads=4, num_layers=4, feature_size=4)),
    "swin_unetr": ("swin_unetr", dict(feature_size=4, depths=(2, 1, 1, 1),
                                      num_heads=(2, 2, 2, 2),
                                      window_size=2)),
    "nnformer": ("nnformer", dict(embed_dim=8, depths=(2, 1, 2),
                                  num_heads=(2, 2, 2), window_size=2)),
    "vtunet": ("vtunet", dict(embed_dim=8, depths=(2, 2, 1),
                              num_heads=(2, 2, 2), window_size=2)),
}
MEDFORMERS = ("mf_mbconv", "mf_attention_up2")
# job → (its cases, the global batch, ranks, model ranks S): every case on
# a 1 × 2 grid at batch 1 (the MedFormers in a job of their own), the MBConv
# UNet (its SE sums over the model group while the data group averages)
# on 2 × 2 at batch 2
JOBS = {"zoo": (tuple(c for c in ZOO if c not in MEDFORMERS), 1, 2, 2),
        "mf": (MEDFORMERS, 1, 2, 2),
        "2x2": (("unet_mbconv",), 2, 4, 2)}


def zoo_model(case: str, state=None):
    """The case's model in float32 (a MedFormer without remat: the JAX
    reference's parameter names), with `state` loaded."""
    from rsuper_tpu_torch.models import get_model

    arch, args = ZOO[case]
    if arch == "medformer":
        args = {**args, "remat": False}
    m = get_model(arch, len(CLASSES), dict(args), dtype=torch.float32)
    if state is not None:
        m.load_state_dict(state)
    return m


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
        res = {case: step(zoo_model(case, data["state"][case]),
                          rows(data[job][case], mine), "dice", dp)
               for case in cases}
        res["place"] = (dp.rank, dp.world, dp.spatial.rank, dp.spatial.size)
        torch.save(res, os.path.join(out, f"{job}{rank}.pt"))
    finally:
        forget_grids()
        dist.destroy_process_group()


# ---------------------------------------------------------------- the CLI
# arch → the config's model args: the smallest the arch takes at SHAPE
CLI_ARCHS = {
    "vnet": {"base_chan": 4},
    "swin_unetr": {"feature_size": 4, "depths": [2, 1, 1, 1],
                   "num_heads": [2, 2, 2, 2], "window_size": 2},
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two steps of each arch of CLI_ARCHS through the CLI's local spawner
    on a 1 × 2 grid, and in one process."""
    yaml = pytest.importorskip("yaml")
    tmp = tmp_path_factory.mktemp("spatial_zoo_cli")
    _write_cases(tmp / "masks", SHAPE)
    procs = []
    for arch, args in CLI_ARCHS.items():
        cfg = tmp / f"{arch}.yaml"
        yaml.safe_dump({"arch": arch, "model_args": args,
                        "training_size": list(SHAPE),
                        "compute_dtype": "float32", "num_workers": 1,
                        "warmup_epochs": 0, "nan_check_every": 1},
                       open(cfg, "w"))
        for name, extra in ((f"{arch}_sp", ["--dist_num_processes", "2",
                                            "--spatial_shard", "2"]),
                            (f"{arch}_one", [])):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rsuper_tpu_torch.train", "--device",
                 "cpu", "--config", str(cfg), "--data_root",
                 str(tmp / "masks"), "--all_train", "--batch_size", "2",
                 "--iter_per_epoch", "2", "--epochs", "1", "--max_steps",
                 "2", "--unique_name", name, "--cp_path", str(tmp / "exp"),
                 *extra], env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    _finish(procs)
    return tmp / "exp"


@pytest.mark.parametrize("arch", sorted(CLI_ARCHS))
def test_cli_shards_a_zoo_arch_in_lockstep_with_one_process(cli_runs, arch):
    """Both ranks log the same bits, within 1e-4 of one process's losses
    at the same global batch (the cases are the load size: no crop draw
    differs)."""
    ranks = [_train_records(cli_runs / f"{arch}_sp" / f"metrics.rank{r}.jsonl")
             for r in range(2)]
    one = _train_records(cli_runs / f"{arch}_one" / "metrics.jsonl")
    assert len(one) >= 1 and all(len(r) >= len(one) for r in ranks)
    for i, ref in enumerate(one):
        for k in (k for k in ref if k.startswith("train/")):
            assert ranks[0][i][k] == ranks[1][i][k], (k, ranks[1][i][k])
            assert abs(ranks[0][i][k] - ref[k]) <= 1e-4 * abs(ref[k]) \
                + 1e-7, (arch, k, ranks[0][i][k], ref[k])
    config = (cli_runs / f"{arch}_sp" / "config.txt").read_text()
    assert f"arch: {arch}\n" in config and "spatial_shard: 2\n" in config


if __name__ == "__main__":
    run_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
             sys.argv[5])
