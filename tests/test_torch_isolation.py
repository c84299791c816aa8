"""The PyTorch port stands apart from the JAX package, and runs on CUDA
unless the CPU is asked for.

* No module of ``rsuper_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax``, ``flax``, ``optax`` or ``rsuper_tpu``, nor the repository's
  ``tools``, nor ``pandas`` or ``sklearn``, which the card's machine
  lacks: checked on the source (AST)
  and by importing every module in a fresh interpreter and reading
  ``sys.modules``.
* The entry points raise without CUDA unless ``device="cpu"`` is given.
* ``chip_smoke.py`` exits non-zero, printing no result, without CUDA and
  when it stands alone in a directory.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "rsuper_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "rsuper_tpu", "pandas", "sklearn", "tools")


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30  # ops, models, inference, data, losses, train
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for new in ("ops/balls.py", "losses/dispatcher.py", "losses/volume.py",
                "train/step.py", "train/optim.py", "bench_train.py",
                "config/config.py", "config/label_names.py",
                "utils/logging.py", "utils/meters.py", "utils/tb_events.py",
                "utils/profiling.py", "data/table.py", "data/reports.py",
                "data/crops.py", "data/preprocess.py", "data/native_io.py",
                "data/dataset.py", "data/sampler.py", "data/class_weights.py",
                "ops/shear_warp.py", "data/augment.py", "data/pipeline.py",
                "train/checkpoint.py", "train/loop.py", "train/__main__.py",
                "metrics/dice.py", "metrics/surface.py",
                "train/validation.py", "train/crossval.py",
                "models/surgery.py", "data/host_augment.py",
                "data/clip.py", "losses/info_nce.py",
                "losses/classification.py", "models/torch_port.py",
                "convert_checkpoint.py", "eval/__init__.py",
                "eval/detection.py", "eval/sens_spec.py", "evaluate.py",
                "bench_infer.py", "models/unet3d.py",
                "models/attention_unet.py", "models/unetpp.py",
                "models/vnet.py", "models/unetr.py", "models/swin_unetr.py",
                "models/nnformer.py", "models/dim2.py",
                "models/dim2_zoo.py", "data/dataset2d.py",
                "inference/sliding_window2d.py", "losses/genesis.py",
                "losses/legacy.py", "losses/matcher.py",
                "baselines/__init__.py", "baselines/model_genesis.py",
                "baselines/pseudo_labels.py", "data/augment_daemon.py",
                "utils/debug_dumps.py", "organ_masks/__init__.py",
                "organ_masks/labels.py", "organ_masks/dataset_prep.py",
                "organ_masks/maintenance.py",
                "organ_masks/predict_suborgans.py",
                "report_extraction/__init__.py",
                "report_extraction/prompts.py",
                "report_extraction/parse.py",
                "report_extraction/metadata.py",
                "report_extraction/client.py", "report_extraction/run.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/multihost.py", "parallel/spatial.py",
                "phantom_benchmark.py", "bench_loop.py",
                "profile_loader.py", "export_checkpoint.py",
                "profile_infer.py", "train_forever.py",
                "launch_llm_fleet.py"):
        assert f"rsuper_tpu_torch/{new}" in names
    return files


def _module_name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port's package
                assert path.is_relative_to(PKG), f"{path}: relative import"
                depth = len(path.relative_to(PKG).parts)
                assert node.level <= depth, \
                    f"{path}: relative import leaves the package"
                continue
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = [_module_name(p) for p in sorted(PKG.rglob("*.py"))]
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_needs_cuda_unless_cpu(no_cuda):
    from rsuper_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from rsuper_tpu_torch import (bench_infer, bench_loop, bench_train,
                                  phantom_benchmark, profile_infer)
    from rsuper_tpu_torch import predict as cli
    from rsuper_tpu_torch.train import __main__ as train_cli
    from rsuper_tpu_torch.inference.predict import (predict_folder,
                                                    predict_masks_volume)
    from rsuper_tpu_torch.inference.sliding_window import (
        sliding_window_inference, sliding_window_probs_device)
    from rsuper_tpu_torch.inference.sliding_window2d import \
        sliding_window_inference_2d
    from rsuper_tpu_torch.organ_masks import predict_suborgans
    from rsuper_tpu_torch.parallel import init_distributed
    from rsuper_tpu_torch.train.validation import validate_cases_2d

    vol = np.zeros((8, 8, 8), np.float32)

    def fn(x):
        raise AssertionError("the model must not run")

    for call in (
        lambda: sliding_window_probs_device(fn, vol, 2, window=(8, 8, 8)),
        lambda: sliding_window_inference(fn, vol, 2, window=(8, 8, 8)),
        lambda: predict_masks_volume([fn], vol, ["a", "b"], window=(8,) * 3),
        lambda: predict_folder([fn], str(tmp_path), str(tmp_path / "o"),
                               ["a"]),
        lambda: cli.main(["--input_dir", str(tmp_path), "--output_dir",
                          str(tmp_path / "o"), "--params_npz", "x.npz",
                          "--classes_json", "c.json"]),
        lambda: cli.main(["--input_dir", str(tmp_path), "--output_dir",
                          str(tmp_path / "o"), "--checkpoint", "run",
                          "--classes_json", "c.json"]),
        lambda: bench_infer.main(["--edge", "32", "--window", "32"]),
        lambda: profile_infer.main(["--edge", "32", "--window", "16",
                                    "--out", str(tmp_path / "t")]),
        lambda: bench_train.main(["--size", "32", "--steps", "1"]),
        lambda: bench_loop.main(["--size", "32", "--case_dir",
                                 str(tmp_path / "cases")]),
        lambda: train_cli.main(["--data_root", str(tmp_path)]),
        lambda: train_cli.main(["--data_root", str(tmp_path), "--preset",
                                "slices/resunet_2d"]),
        lambda: sliding_window_inference_2d(fn, vol, 2, window=(8, 8)),
        lambda: validate_cases_2d(fn, [(vol, np.ones((2, 8, 8, 8)))], 2,
                                  window=(8, 8)),
        lambda: predict_suborgans.main(["--pth", str(tmp_path), "--outdir",
                                        str(tmp_path / "o"),
                                        "--checkpoint", "c"]),
        lambda: train_cli.main(["--data_root", str(tmp_path),
                                "--dist_coordinator", "127.0.0.1:1",
                                "--dist_num_processes", "1",
                                "--dist_process_id", "0"]),
        lambda: init_distributed("127.0.0.1:1", 1, 0),
        lambda: phantom_benchmark.main(["--out", str(tmp_path / "p")]),
        lambda: phantom_benchmark.evaluate(None, {}, str(tmp_path)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
