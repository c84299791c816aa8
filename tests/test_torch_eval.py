"""The port's detection evaluation (``rsuper_tpu_torch/eval``,
``python -m rsuper_tpu_torch.evaluate``) against the JAX package's, on the
CPU: same prediction folders and per-CT CSVs on both sides.

The port has no pandas and no scikit-learn. Tolerances:
* detection volumes, maximum probabilities, ground truth, Sens/Spec/F1:
  equal (the same numpy and scipy arithmetic on both sides);
* AUROC: the port's Mann–Whitney formula (one correctly rounded division)
  against ``sklearn.metrics.roc_auc_score``'s trapezoids: within 1e-15
  relative, NaN where NaN;
* files: byte-equal to pandas' ``to_csv(index=False)``.
"""

import filecmp
import os

import numpy as np
import pytest

from rsuper_tpu.eval import detection as jdet
from rsuper_tpu.eval import sens_spec as jss
from rsuper_tpu_torch.data.nifti import read_nifti, write_nifti
from rsuper_tpu_torch.data.table import Table
from rsuper_tpu_torch.eval import detection as tdet
from rsuper_tpu_torch.eval import sens_spec as tss

ORGANS = ("liver", "pancreatic", "kidney")
AUC_RTOL = 1e-15


def _blob_probs(rng, shape, peak):
    """A smooth lesion-like blob with maximum `peak`, on a noise floor."""
    z, y, x = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    c = [rng.uniform(0.3, 0.7) * n for n in shape]
    r2 = sum((a - b) ** 2 for a, b in zip((z, y, x), c))
    p = np.exp(-r2 / (2 * rng.uniform(2.0, 5.0) ** 2))
    p = p * peak + rng.uniform(0, 0.05, shape)
    return np.clip(p, 0, peak).astype(np.float32)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Six predicted cases (``<id>/<organ>_lesion_prob.nii.gz``), one with
    1.5 × 0.8 × 2 mm voxels, one without a kidney map; maxima tied at 1.0
    and 0.0 across cases; and the per-CT CSV."""
    root = tmp_path_factory.mktemp("eval")
    preds = root / "preds"
    rng = np.random.default_rng(0)
    peaks = {"liver": [1.0, 1.0, 0.6, 0.3, 1.0, 0.0],
             "pancreatic": [0.95, 1.0, 1.0, 0.2, 0.0, 0.7],
             "kidney": [0.0, 0.8, 0.0, 0.8, 0.5, 0.1]}
    for i in range(6):
        case = preds / f"BDMAP_{i:08d}"
        case.mkdir(parents=True)
        affine = np.diag([1.5, 0.8, 2.0, 1.0]) if i == 2 else np.eye(4)
        for org in ORGANS:
            if org == "kidney" and i == 4:
                continue
            p = _blob_probs(rng, (20, 22, 18), peaks[org][i])
            write_nifti(str(case / f"{org}_lesion_prob.nii.gz"), p, affine)
    lesions = {"liver": ["1", "0", "2", "", "1", "0"],
               "pancreatic": ["1", "1", "0", "0", "nan", "1"],
               "kidney": ["0", "1", "0", "1", "0", "0"]}
    rows = ["BDMAP ID," + ",".join(f"number of {o} lesion instances"
                                   for o in ORGANS)]
    for i in list(range(5)) + [7]:  # case 5 absent, one unknown case
        rows.append(f"BDMAP_{i:08d}," + ",".join(
            lesions[o][min(i, 5)] for o in ORGANS))
    (root / "gt_space.csv").write_text("\n".join(rows) + "\n")
    (root / "gt.csv").write_text("\n".join(
        [rows[0].replace("BDMAP ID", "BDMAP_ID")] + rows[1:]) + "\n")
    return root


def _same_table(got: Table, ref):
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)
    for k in ref.columns:
        want = ref[k].tolist()
        have = got[k].values
        for a, b in zip(have, want):
            if isinstance(b, float) and np.isnan(b):
                assert isinstance(a, float) and np.isnan(a), (k, a, b)
            else:
                assert a == b, (k, a, b)


def _same_csv(got: Table, ref, tmp_path, name):
    a, b = tmp_path / f"{name}.port.csv", tmp_path / f"{name}.jax.csv"
    got.to_csv(str(a))
    ref.to_csv(b, index=False)
    assert a.read_bytes() == b.read_bytes(), name


@pytest.mark.parametrize("spacing", [(1.5, 0.8, 2.0), (0.7, 0.7, 1.25)])
def test_detect_volumes_on_non_1mm_spacing_match_jax(spacing):
    p = _blob_probs(np.random.default_rng(1), (24, 20, 16), 1.0)
    got = tdet.detect_volumes(p, spacing)
    ref = jdet.detect_volumes(p, spacing)
    assert got == ref
    assert got["volumes"][0.1] > got["volumes"][0.5] > 0
    assert tdet.detect_volume_from_mask(p > 0.5, spacing) == \
        jdet.detect_volume_from_mask(p > 0.5, spacing)


def test_detection_tables_match_jax(folder, tmp_path):
    preds = str(folder / "preds")
    got = tdet.detection_table(preds, parts=2, part=1)
    ref = jdet.detection_table(preds, parts=2, part=1)
    assert sorted(got) == sorted(ref) == list(tdet.THRESHOLDS)
    for th in ref:
        _same_table(got[th], ref[th])
        _same_csv(got[th], ref[th], tmp_path, f"det{th}")
    # binary masks, the `predict_folder` layout of masks (case 3's liver
    # mask absent)
    for case in sorted(os.listdir(preds)):
        (tmp_path / "m" / case).mkdir(parents=True)
        for org in ORGANS:
            src = folder / "preds" / case / f"{org}_lesion_prob.nii.gz"
            if src.exists() and (case, org) != ("BDMAP_00000003", "liver"):
                img = read_nifti(str(src))
                write_nifti(str(tmp_path / "m" / case / f"{org}_lesion.nii.gz"),
                            (img.data > 0.4).astype(np.uint8), img.affine)
    got = tdet.detection_table_from_masks(str(tmp_path / "m"))
    ref = jdet.detection_table_from_masks(str(tmp_path / "m"))
    _same_table(got, ref)
    _same_csv(got, ref, tmp_path, "masks")


def test_detection_table_nnunet_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for i in range(3):
        probs = rng.random((9, 6, 7, 5)).astype(np.float32)
        np.savez(tmp_path / f"BDMAP_{i:08d}.npz", probabilities=probs)
    assert tdet.NNUNET_TUMOUR_CH == jdet.NNUNET_TUMOUR_CH
    ids = ["BDMAP_00000000", "BDMAP_00000002"]
    got = tdet.detection_table_nnunet(str(tmp_path), case_ids=ids)
    ref = jdet.detection_table_nnunet(str(tmp_path), case_ids=ids)
    for th in ref:
        _same_table(got[th], ref[th])
        _same_csv(got[th], ref[th], tmp_path, f"nn{th}")


def test_parts_written_and_merged_as_jax(folder, tmp_path):
    preds = str(folder / "preds")
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_.mkdir()
    for part in (1, 0):  # the last part to land merges
        tdet.write_detection_parts(
            str(port), tdet.detection_table(preds, parts=2, part=part), 2,
            part)
        jdet.write_detection_parts(
            str(jax_), jdet.detection_table(preds, parts=2, part=part), 2,
            part)
        if part == 1:
            assert tdet.merge_detection_parts(str(port), 2) is None
    got = tdet.merge_detection_parts(str(port), 2)
    ref = jdet.merge_detection_parts(str(jax_), 2)
    names = sorted(os.listdir(jax_))
    assert sorted(os.listdir(port)) == names and len(names) == 27
    for name in names:
        assert filecmp.cmp(port / name, jax_ / name, shallow=False), name
    for th in ref:
        _same_table(got[th], ref[th])


@pytest.mark.parametrize("csv_name", ["gt.csv", "gt_space.csv"])
def test_load_ground_truth_matches_jax(folder, csv_name):
    got = tss.load_ground_truth(str(folder / csv_name))
    ref = jss.load_ground_truth(str(folder / csv_name))
    _same_table(got, ref)
    assert got["gt_liver"].values == [1.0, 0.0, 1.0, 0.0, 1.0, 0.0]


def _auc_tables(y, p):
    ids = [f"c{i}" for i in range(len(y))]
    gt = {"BDMAP_ID": ids, **{f"gt_{o}": [float(v) for v in y]
                              for o in ORGANS}}
    pr = {"BDMAP_ID": ids}
    for o in ORGANS:
        pr[f"{o} tumor maximum probability"] = list(p)
    return gt, pr


@pytest.mark.parametrize("y,p", [
    ([1, 0, 1, 0, 1, 0, 0], [1.0, 1.0, 0.5, 0.0, 1.0, 0.0, 0.25]),
    ([0, 1, 1, 0, 0], [0.2, 0.2, 0.2, 0.2, 0.9]),
    ([1, 0, 0, 1], [0.3, np.nan, 0.1, 0.7]),
    ([0, 0, 0], [0.1, 0.5, 0.9]),
    ([1, 0, 1], [np.nan, 0.5, 0.9]),
])
def test_prob_auc_matches_jax(y, p):
    import pandas as pd

    gt, pr = _auc_tables(y, p)
    got = tss.prob_auc(Table.from_rows([dict(zip(gt, r))
                                        for r in zip(*gt.values())]),
                       Table.from_rows([dict(zip(pr, r))
                                        for r in zip(*pr.values())]))
    ref = jss.prob_auc(pd.DataFrame(gt), pd.DataFrame(pr))
    for o in ORGANS:
        if np.isnan(ref[o]):
            assert np.isnan(got[o])
        else:
            assert abs(got[o] - ref[o]) <= AUC_RTOL * ref[o], (got, ref)


def test_evaluate_cli_files_match_jax(folder, tmp_path, capsys):
    import evaluate as jeval

    from rsuper_tpu_torch import evaluate as teval

    args = ["--pred_dir", str(folder / "preds"),
            "--ground_truth", str(folder / "gt_space.csv")]
    jeval.main(args + ["--out_dir", str(tmp_path / "jax")])
    ref_out = capsys.readouterr().out
    teval.main(args + ["--out_dir", str(tmp_path / "port")])
    got_out = capsys.readouterr().out
    assert got_out == ref_out
    assert "pancreatic {'f1': " in got_out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 18
    for name in names:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
