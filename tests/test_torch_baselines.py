"""The port's baselines and augmentation daemon against the JAX package, on
the CPU (host numpy: every comparison is bit for bit).

* Model-Genesis restoration pairs at 32³ from the same
  ``np.random.default_rng(seed)``: each corruption alone and the whole
  pair, over seeds and rates that reach every branch.
* Report-guided pseudo-labels: the masks and counts of
  ``extract_lesion_candidates`` and ``refine_with_report`` on seeded
  probability maps.
* The daemon: records saved by one package read back by the other,
  ``run_daemon`` over the synthetic cases of ``tests/test_torch_loop.py``
  (2 CT-Mask and 2 CT-Report cases, 32³ crops) writing the same arrays,
  ``AugmentedRecordDataset`` and its fallback, and the CLI.
"""

import numpy as np
import pytest

from rsuper_tpu.baselines import model_genesis as jmg
from rsuper_tpu.baselines import pseudo_labels as jpl
from rsuper_tpu.data import augment_daemon as jdaemon
from rsuper_tpu.data import dataset as jds
from rsuper_tpu.data import reports as jrep
from rsuper_tpu_torch import baselines
from rsuper_tpu_torch.baselines import model_genesis as tmg
from rsuper_tpu_torch.baselines import pseudo_labels as tpl
from rsuper_tpu_torch.data import augment_daemon as tdaemon
from rsuper_tpu_torch.data import dataset as tds
from rsuper_tpu_torch.data import reports as trep
from test_torch_loop import CLASSES, REPORT_CLASSES, _cases, _write_cases

CROP = (32, 32, 32)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _volume(seed, shape=(32, 32, 32)):
    return (np.random.default_rng(seed).normal(size=shape) * 50 + 10
            ).astype(np.float32)


# ---------------------------------------------------------- Model Genesis
@pytest.mark.parametrize("name", ["local_pixel_shuffling",
                                  "nonlinear_transformation",
                                  "image_in_painting", "image_out_painting"])
def test_each_corruption_is_bit_equal(name):
    for seed in range(3):
        y = _volume(seed)
        y = (y - y.min()) / (y.max() - y.min())
        got = getattr(tmg, name)(y.copy(), np.random.default_rng(seed + 10))
        want = getattr(jmg, name)(y.copy(), np.random.default_rng(seed + 10))
        _same(got, want)
    pts = np.random.default_rng(0).random((4, 2))
    for g, w in zip(tmg._bezier_curve(pts, 50), jmg._bezier_curve(pts, 50)):
        _same(g, w)


@pytest.mark.parametrize("rates", [
    {}, dict(flip_rate=1.0, local_rate=1.0, paint_rate=1.0, inpaint_rate=1.0),
    dict(flip_rate=0.9, local_rate=0.0, nonlinear_rate=1.0, paint_rate=1.0,
         inpaint_rate=0.0)])
def test_restoration_pairs_are_bit_equal(rates):
    for seed in range(4):
        img = _volume(seed, (32, 28, 24))
        got = tmg.generate_restoration_pair(img, np.random.default_rng(seed),
                                            **rates)
        want = jmg.generate_restoration_pair(img, np.random.default_rng(seed),
                                             **rates)
        for g, w in zip(got, want):
            _same(g, w)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[1].min()) - float(img.min())) < 1e-3


# ------------------------------------------------------------ pseudo labels
def _prob_map(seed, shape=(40, 40, 40)):
    """Gaussian blobs of random heights and widths, with noise."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in shape),
                                indexing="ij"), -1)
    prob = 0.02 * rng.random(shape)
    for _ in range(5):
        c = rng.uniform(5, np.array(shape) - 5)
        w = rng.uniform(1.0, 4.0)
        prob += rng.uniform(0.2, 0.9) * np.exp(
            -((grid - c) ** 2).sum(-1) / (2 * w * w))
    return np.clip(prob, 0, 1).astype(np.float32)


def test_pseudo_labels_are_bit_equal():
    assert baselines.__all__ == ["generate_restoration_pair",
                                 "extract_lesion_candidates",
                                 "refine_with_report"]
    for seed in range(3):
        prob = _prob_map(seed)
        for n in (1, 3, 6):
            for kw in ({}, dict(peak_cut=0.6, min_voxels=4, min_peak=0.3)):
                got = tpl.extract_lesion_candidates(prob, n, **kw)
                want = jpl.extract_lesion_candidates(prob, n, **kw)
                _same(got[0], want[0])
                assert got[1] == want[1] and got[0].any()
    maps = {"pancreas": _prob_map(4), "liver": _prob_map(5),
            "kidney": _prob_map(6)}
    organ = {"pancreas": (_prob_map(7) > 0.05).astype(np.uint8)}
    counts = {"pancreas": 2, "liver": 1, "kidney": 0}
    for masks in (None, organ):
        got = tpl.refine_with_report(maps, counts, masks, min_voxels=5)
        want = jpl.refine_with_report(maps, counts, masks, min_voxels=5)
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        assert not got["kidney"].any() and got["pancreas"].any()


# ------------------------------------------------------------------ daemon
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_cases(tmp_path_factory.mktemp("cases"))


def _datasets(root):
    tumor = ["pancreas"]
    rows_t, _, _ = trep.clean_reports(
        trep.load_reports(str(root / "reports.csv")), tumor)
    rows_j, _, _ = jrep.clean_reports(
        jrep.load_reports(str(root / "reports.csv")), tumor)
    out = []
    for mod, rows in ((tds, rows_t), (jds, rows_j)):
        cfg = mod.RSuperDataConfig(classes=tuple(CLASSES),
                                   report_classes=tuple(REPORT_CLASSES),
                                   crop_size=CROP, tumor_classes=tuple(tumor))
        out.append(mod.RSuperDataset(_cases(root, mod), cfg,
                                     report_rows=rows))
    return out


def _same_record(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        _same(np.asarray(a[k]), np.asarray(b[k]))


def test_records_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    rec = {"image": rng.normal(size=(9, 10, 11)).astype(np.float32),
           "label": (rng.random((3, 9, 10, 11)) > 0.5).astype(np.uint8),
           "unk": (rng.random((11, 9, 10, 11)) > 0.9).astype(np.uint8),
           "segment_mask": np.zeros((3, 9, 10, 11), np.uint8),
           "volumes": rng.random(10).astype(np.float32),
           "diameters": rng.random((10, 3)).astype(np.float32),
           "apply_affine": np.float32(0.0)}
    tdaemon.save_record(rec, str(tmp_path / "t"), "BDMAP_T")
    jdaemon.save_record(rec, str(tmp_path / "j"), "BDMAP_T")
    for d in ("t", "j"):
        back_t = tdaemon.load_record(str(tmp_path / d), "BDMAP_T")
        _same_record(back_t, jdaemon.load_record(str(tmp_path / d), "BDMAP_T"))
        _same(back_t["label"], rec["label"])
        _same(back_t["unk"], rec["unk"])
    # no temporary file is left beside the record
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["BDMAP_T.npz"]


def test_daemon_rounds_and_reader_match_jax(data, tmp_path):
    tset, jset = _datasets(data)
    tdaemon.run_daemon(tset, str(tmp_path / "t"), seed=3, max_rounds=1)
    jdaemon.run_daemon(jset, str(tmp_path / "j"), seed=3, max_rounds=1)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == len(tset.cases) == 4
    for i, case in enumerate(tset.cases):
        got = tdaemon.load_record(str(tmp_path / "t"), case.case_id)
        _same_record(got, jdaemon.load_record(str(tmp_path / "j"),
                                              case.case_id))
        reader = tdaemon.AugmentedRecordDataset(tset, str(tmp_path / "t"))
        assert len(reader) == 4
        _same_record(reader.sample(i), got)
    # the reader falls back to sampling online, with the same draws
    for i in range(2):
        got = tdaemon.AugmentedRecordDataset(tset, str(tmp_path / "none")) \
            .sample(i, np.random.default_rng(i))
        want = jdaemon.AugmentedRecordDataset(jset, str(tmp_path / "none")) \
            .sample(i, np.random.default_rng(i))
        _same_record(got, want)


def test_daemon_reports_a_failing_case_and_goes_on(data, tmp_path, capsys):
    tset, _ = _datasets(data)

    class Failing:
        cases = tset.cases

        def __len__(self):
            return len(tset)

        def sample(self, i, rng=None):
            if i == 1:
                raise OSError("torn file")
            return tset.sample(i, rng)

    tdaemon.run_daemon(Failing(), str(tmp_path / "t"), max_rounds=1,
                       sleep_on_error=0.0)
    assert "augment daemon error on" in capsys.readouterr().out
    assert len(list((tmp_path / "t").iterdir())) == 3


def test_daemon_cli_matches_jax(data, tmp_path):
    argv = ["--data_root", str(data / "masks"), "--report_root",
            str(data / "reports"), "--reports", str(data / "reports.csv"),
            "--crop_size", *map(str, CROP), "--tumor_classes", "pancreas",
            "--rounds", "1", "--seed", "1"]
    tdaemon.main(argv + ["--save_destination", str(tmp_path / "t")])
    jdaemon.main(argv + ["--save_destination", str(tmp_path / "j")])
    names = sorted(p.stem for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.stem for p in (tmp_path / "t").iterdir())
    assert len(names) == 4
    for n in names:
        _same_record(tdaemon.load_record(str(tmp_path / "t"), n),
                     jdaemon.load_record(str(tmp_path / "j"), n))
