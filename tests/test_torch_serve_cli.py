"""Serving a checkpoint of any origin with the port's predict CLI
(``python -m rsuper_tpu_torch.predict``), and its serving benchmark, on the
CPU.

One small MedFormer (``tests/test_torch_medformer.py``'s widths) with two
seeded parameter sets, the parameters and a different EMA copy, served from
a checkpoint directory that the training loop's ``CheckpointManager``
writes, from ``.npz`` files of flax parameter paths (the route of JAX
exports), and from a reference-layout ``.pth`` through
``python -m rsuper_tpu_torch.convert_checkpoint``. The same weights take the
same arithmetic on every route, so the masks must be equal, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from rsuper_tpu_torch import bench_infer, convert_checkpoint
from rsuper_tpu_torch import predict as cli
from rsuper_tpu_torch.data.nifti import read_nifti, write_nifti
from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                     init_params)
from rsuper_tpu_torch.models.torch_port import export_state_dict
from rsuper_tpu_torch.train import create_train_state, make_optimizer
from rsuper_tpu_torch.train.checkpoint import (CheckpointManager, load_params,
                                               save_params)

TINY = dict(  # tests/test_torch_medformer.py's widths (copied)
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
CLASSES = ["kidney_left", "kidney_lesion", "kidney_right", "liver",
           "liver_lesion"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Several test processes share the machine; PyTorch's pool of spinning
    intra-op threads would slow these small models tens of times, so they
    take one thread (as ``tests/test_torch_loop.py`` does)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Served:
    """A CT, the two parameter sets as port state_dicts and as ``.npz``
    files, a checkpoint directory with ``best`` and ``latest`` (EMA copy
    included) and one with ``latest`` alone."""

    def __init__(self, root):
        self.root = root
        (root / "in").mkdir()
        ct = (np.random.default_rng(6).normal(size=(30, 34, 20)) * 200.0
              ).astype(np.float32)
        write_nifti(str(root / "in" / "case_a.nii.gz"), ct, np.eye(4))
        (root / "classes.json").write_text(json.dumps(CLASSES))
        model = get_model("medformer", len(CLASSES), dict(TINY))
        self.params = init_params(model, seed=0).state_dict()
        self.ema = {k: v.clone() for k, v in init_params(
            get_model("medformer", len(CLASSES), dict(TINY)),
            seed=1).state_dict().items()}
        for name, sd in (("params", self.params), ("ema", self.ema)):
            np.savez(root / f"{name}.npz", **flax_from_state_dict(sd))
        state = create_train_state(model, make_optimizer(model.parameters()))
        state.ema_params = self.ema
        CheckpointManager(str(root / "run")).save_epoch(state, 0, metric=1.0)
        CheckpointManager(str(root / "latest_only")).save_epoch(state, 0)
        self.masks = {name: self.serve(name, ["--params_npz",
                                              str(root / f"{name}.npz")])
                      for name in ("params", "ema")}

    def serve(self, name, source, model_args=TINY):
        out = self.root / "out" / name
        done = cli.main([
            "--input_dir", str(self.root / "in"), "--output_dir", str(out),
            *source, "--classes_json", str(self.root / "classes.json"),
            "--model_args_json", json.dumps(model_args),
            "--window", "32", "32", "32", "--batch_windows", "2",
            "--device", "cpu"])
        assert done == ["case_a"]
        return {c: read_nifti(str(out / "case_a" / f"{c}.nii.gz")).data
                for c in CLASSES}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return Served(tmp_path_factory.mktemp("serve"))


def _equal(a, b):
    return all(np.array_equal(a[c], b[c]) for c in CLASSES)


def test_the_two_parameter_sets_give_different_masks(served):
    p, e = served.masks["params"], served.masks["ema"]
    assert 0 < sum(int(p[c].sum()) for c in CLASSES) < p["liver"].size * 5
    assert not _equal(p, e)


@pytest.mark.parametrize("tag", ["best", "latest"])
def test_checkpoint_masks_equal_params_npz(served, tag):
    got = served.serve(f"ckpt_{tag}", ["--checkpoint",
                                       str(served.root / "run"),
                                       "--tag", tag])
    assert _equal(got, served.masks["params"])


def test_tag_falls_back_to_latest(served):
    got = served.serve("fallback", ["--checkpoint",
                                    str(served.root / "latest_only"),
                                    "--tag", "best"])
    assert _equal(got, served.masks["params"])


def test_ema_serves_the_ema_copy(served):
    got = served.serve("ema", ["--checkpoint", str(served.root / "run"),
                               "--ema"])
    assert _equal(got, served.masks["ema"])
    for k, v in load_params(str(served.root / "run"), ema=True).items():
        assert torch.equal(v, served.ema[k]), k


def test_ema_without_an_ema_copy_raises(served, tmp_path):
    save_params(str(tmp_path / "converted"), served.params)
    with pytest.raises(ValueError, match="no EMA copy"):
        served.serve("x", ["--checkpoint", str(tmp_path / "converted"),
                           "--ema"])
    with pytest.raises(ValueError, match="npz"):
        served.serve("x", ["--checkpoint", str(served.root / "run"), "--ema",
                           "--ensemble", str(served.root / "ema.npz")])


def test_ensemble_mixes_directories_and_npz(served, tmp_path):
    save_params(str(tmp_path / "ema_dir"), served.ema)
    a = served.serve("ens_a", ["--checkpoint", str(served.root / "run"),
                               "--ensemble", str(served.root / "ema.npz")])
    b = served.serve("ens_b", ["--params_npz", str(served.root / "params.npz"),
                               "--ensemble", str(tmp_path / "ema_dir")])
    assert _equal(a, b)
    assert not _equal(a, served.masks["params"])


def test_missing_checkpoint_directory_raises_and_is_not_created(served,
                                                                tmp_path):
    missing = tmp_path / "no_such_run"
    with pytest.raises(FileNotFoundError, match="no_such_run"):
        served.serve("x", ["--checkpoint", str(missing)])
    CheckpointManager(str(missing))
    assert not missing.exists()
    with pytest.raises(SystemExit):  # one source, not both
        served.serve("x", ["--checkpoint", str(served.root / "run"),
                           "--params_npz", str(served.root / "params.npz")])


def test_converted_pth_is_served_with_torch_port(served, tmp_path):
    """Reference-layout weights through the converter serve as the same
    weights from an ``.npz``, both with the reference's numerics."""
    ref = export_state_dict(flax_from_state_dict(served.params),
                            base_chan=4, chan_num=TINY["chan_num"],
                            trans_num=TINY["trans_num"],
                            num_heads=TINY["num_heads"], fusion_depth=1)
    torch.save({"model_state_dict": {"module." + k: torch.from_numpy(v)
                                     for k, v in ref.items()}},
               tmp_path / "model.pth")
    convert_checkpoint.main([
        str(tmp_path / "model.pth"), str(tmp_path / "conv"),
        "--base_chan", "4", "--chan_num", "8,16,32,40,32,16,8,4",
        "--trans_num", "0,1,2,1,1,1,0,0", "--num_heads", "1,2,2,2,2,2,1,1",
        "--fusion_depth", "1", "--skip_verify"])  # verify: expansion 4
    args = {**TINY, "torch_port": True}
    got = served.serve("pth", ["--checkpoint", str(tmp_path / "conv")],
                       args)
    want = served.serve("pth_npz", ["--params_npz",
                                    str(served.root / "params.npz")], args)
    assert _equal(got, want)


def test_bench_infer_prints_its_line_on_the_cpu(capsys):
    bench_infer.main(["--device", "cpu", "--edge", "40", "--window", "32",
                      "--reps", "1", "--model_args_json", json.dumps(TINY)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == sorted([
        "metric", "value", "unit", "seconds_per_volume",
        "seconds_per_volume_prob_transfer",
        "seconds_per_volume_masks_plus_lesion_probs", "prob_wire",
        "first_call_with_compile_s"])
    assert line["metric"] == "sliding_window_volumes_per_min_per_cpu"
    assert line["value"] > 0 and line["prob_wire"] == "u8"
