"""``python -m rsuper_tpu_torch.bench_loop`` and ``profile_loader`` against
the JAX package's ``tools/bench_loop.py`` and ``tools/profile_loader.py``,
on the CPU, at a small crop (16³: cases of 60³).

* ``make_cases``: every array of every case bit-equal to the JAX tool's
  (its ``CASE_DIR`` pointed at a temporary directory);
* the loader's records (one worker, a seed): equal to the JAX
  ``RSuperDataset.sample`` + ``pack_record_cf`` on the same cases with the
  worker's generator; the ``off`` mode's transform equal to the JAX
  ``make_host_augment(affine_prob=0, intensity_prob=0)``;
* every ``profile_loader`` stage's output equal to the JAX function's on
  the same input and seed;
* a two-step ``--device cpu`` run of a small MedFormer prints the JSON
  line with every key and a finite loss.
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from rsuper_tpu.data import crops as jcrops
from rsuper_tpu.data.dataset import Case as JCase
from rsuper_tpu.data.dataset import RSuperDataConfig as JDataConfig
from rsuper_tpu.data.dataset import RSuperDataset as JDataset
from rsuper_tpu.data.dataset import to_channels_last as j_to_channels_last
from rsuper_tpu.data.host_augment import make_host_augment as j_host_augment
from rsuper_tpu.data.pipeline import pack_record_cf as j_pack_record_cf
from rsuper_tpu.data.preprocess import load_case as j_load_case
from rsuper_tpu_torch import bench_loop, profile_loader
from rsuper_tpu_torch.data.pipeline import PrefetchLoader

CROP = 16
SIZE = (CROP + bench_loop.MARGIN,) * 3
SMALL = dict(  # tests/test_torch_train.py's TINY widths (copied)
    base_chan=4, chan_num=(8, 16, 32, 40, 32, 16, 8, 4),
    conv_num=(2, 0, 0, 0, 0, 0, 2, 2), trans_num=(0, 1, 2, 1, 1, 1, 0, 0),
    num_heads=(1, 2, 2, 2, 2, 2, 1, 1), fusion_depth=1, fusion_dim=40,
    fusion_heads=2, expansion=2)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Several test processes share the machine, and the loader's threads
    run beside PyTorch's: one intra-op thread (as
    ``tests/test_torch_loop.py``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_tool():
    """``tools/bench_loop.py``, imported without the environment variable
    and the path entry its import sets for its own runs."""
    env, path = dict(os.environ), list(sys.path)
    try:
        return importlib.import_module("tools.bench_loop")
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The port's four cases at SIZE and the JAX tool's, each in a
    directory of its own."""
    jtool = _jax_tool()
    root = tmp_path_factory.mktemp("bench_cases")
    port = bench_loop.make_cases(4, SIZE, root / "port")
    saved, jtool.CASE_DIR = jtool.CASE_DIR, root / "jax"
    try:
        jax_paths = jtool.make_cases(4, SIZE)
    finally:
        jtool.CASE_DIR = saved
    return root / "port", port, jax_paths


def _jax_dataset(paths, crop=CROP):
    jtool = _jax_tool()
    dcfg = JDataConfig(
        classes=tuple(jtool.CLASSES),
        report_classes=tuple(c for c in jtool.CLASSES if "lesion" not in c),
        crop_size=(crop,) * 3, tumor_classes=("pancreas",))
    return JDataset([JCase(f"BDMAP_L{i}", p, False)
                     for i, p in enumerate(paths)], dcfg)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_make_cases_are_the_jax_tools_arrays(cases):
    jtool = _jax_tool()
    _, port, jax_paths = cases
    assert bench_loop.CLASSES == jtool.CLASSES
    for p, j in zip(port, jax_paths):
        with np.load(p) as a, np.load(j) as b:
            _same(dict(a.items()), dict(b.items()))
        assert json.loads(open(p[:-4] + ".json").read()) == \
            json.loads(open(j[:-4] + ".json").read())
    # written once, then reused
    again = bench_loop.make_cases(4, SIZE, cases[0].parent / "port")
    assert again == port


@pytest.mark.parametrize("seed", [0, 3])
def test_loader_records_are_jax_sample_and_pack(cases, seed):
    case_dir, port, jax_paths = cases
    ds = bench_loop.build_dataset(CROP, case_dir.parent / "port")
    indices = [i % 4 for i in range(6)]
    loader = PrefetchLoader(ds, 1, indices, num_workers=1, seed=seed)
    jds = _jax_dataset(jax_paths)
    rng = np.random.default_rng(seed * 10007)
    n = 0
    for i, batch in zip(indices, loader):
        want = j_pack_record_cf(jds.sample(i, rng), np.float16)
        _same({k: v[0] for k, v in batch.items()}, want)
        n += 1
    assert n == len(indices)


def test_off_transform_is_the_jax_centre_crop(cases):
    _, port, jax_paths = cases
    ds = bench_loop.build_dataset(CROP, cases[0].parent / "port")
    jds = _jax_dataset(jax_paths)
    off = bench_loop.host_transform("off", (CROP,) * 3)
    joff = j_host_augment((CROP,) * 3, affine_prob=0.0, intensity_prob=0.0)
    assert bench_loop.host_transform("device", (CROP,) * 3) is None
    for i in range(4):
        r1, r2 = np.random.default_rng(i), np.random.default_rng(i)
        got = off(ds.sample(i, r1), r1)
        want = joff(j_to_channels_last(jds.sample(i, r2)), r2)
        assert sorted(got) == sorted(want)
        for k in want:  # the JAX masks are float32 0/1, the port's uint8
            np.testing.assert_array_equal(
                np.asarray(got[k], np.float32), np.asarray(want[k],
                                                           np.float32), k)


def test_profile_loader_stages_are_the_jax_functions(cases):
    _, port, jax_paths = cases
    seed = 5
    parts = profile_loader.stages(port[0], seed)
    jds = _jax_dataset(jax_paths[:1])
    rng = lambda: np.random.default_rng(seed)  # noqa: E731
    img, lab = j_load_case(jax_paths[0], num_classes=16)
    dcfg = jds.cfg
    with np.load(jax_paths[0]) as z:
        arrays = dict(z.items())
    want = {
        "dataset.sample (total)": jds.sample(0, rng()),
        "np.load+read arrays": arrays,
        "  np.load image only": arrays["image"],
        "  unpackbits(labels)":
            np.unpackbits(arrays["labels"], axis=0)[:16],
        "load_case": (img, lab),
        "pad_pair": jcrops.pad_pair(img, lab, dcfg.load_size),
        "random_crop_on_tumor": jcrops.random_crop_on_tumor(
            img, lab, dcfg.lesion_class_indices(), dcfg.load_size, True,
            foreground_classes=dcfg.foreground_class_indices(), rng=rng()),
        "to_channels_last": j_to_channels_last(jds.sample(0, rng())),
        "sample+pack_record_cf (fast path)":
            j_pack_record_cf(jds.sample(0, rng()), np.float16),
    }
    assert list(parts) == list(want)
    for label, fn in parts.items():
        got, ref = fn(), want[label]
        if isinstance(ref, dict):
            _same(got, ref)
        elif isinstance(ref, tuple):
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                _same({"x": a}, {"x": b})
        else:
            _same({"x": got}, {"x": ref})


def test_profile_loader_prints_its_line(cases, capsys):
    out = profile_loader.main([str(s) for s in SIZE]
                              + ["--case_dir", str(cases[0].parent / "port")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert len(lines) == len(out["stages_ms"]) + 2
    assert out["host_cpus"] >= 1 and out["packed_mb"] > 0
    assert all(v >= 0 for v in out["stages_ms"].values())


KEYS = ("metric", "value", "unit", "loss", "h2d_ms_per_item",
        "h2d_mb_per_item", "card", "iter_ms_median", "iter_ms_p90",
        "wait_ms_median", "loader_item_ms_median", "host_cpus")


@pytest.mark.parametrize("mode", [[], ["--augment", "off", "--no-overlap"]])
def test_bench_loop_prints_its_line_on_the_cpu(cases, capsys, mode):
    out = bench_loop.main(["--device", "cpu", "--size", "32", "--steps", "2",
                           "--warmup", "1", "--workers", "2", "--case_dir",
                           str(cases[0].parent / "port")] + mode,
                          model_args=SMALL)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert all(k in line for k in KEYS)
    assert line["metric"] == "e2e_train_patches_per_sec_per_cpu_32" + (
        "_off_inline" if mode else "")
    assert line["value"] > 0 and np.isfinite(line["loss"])
    assert line["steps"] == 2 and line["card"] is None
    assert line["h2d_mb_per_item"] > 0 and line["iter_ms_p90"] >= \
        line["iter_ms_median"] > 0
