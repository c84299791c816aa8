"""The port's host data layer against the JAX package's, on the CPU.

Every comparison is exact (bit-equal arrays, equal lists), from the same
numpy seeds:

* the CSV column table (``data/table.py``) against ``pandas.read_csv`` on
  NaN and empty cells, numbers, booleans and text;
* ``clean_reports`` (the healthy-case subsample included),
  ``case_supervision``, ``estimate_tumor_volumes``, ``is_healthy`` and
  ``class_proportions`` on a seeded report table;
* ``build_case_list``, ``split_train_test``, ``kfold_split`` and
  ``ChunkedSampler.epoch_indices``;
* the crops, and ``RSuperDataset.sample`` records for mask and report cases
  (built as ``tests/test_data.py`` builds them), with and without class
  proportions;
* ``preprocess_case`` + ``load_case`` from NIfTI files;
* ``PrefetchLoader`` batches with one worker, and ``pack_masks_cl``
  native against numpy (skips only when ``g++`` is absent).
"""

import json
import shutil

import numpy as np
import pandas as pd
import pytest

from rsuper_tpu.data import crops as jcrops
from rsuper_tpu.data import dataset as jds
from rsuper_tpu.data import preprocess as jpre
from rsuper_tpu.data import reports as jrep
from rsuper_tpu.data.class_weights import class_proportions as jclass_props
from rsuper_tpu.data.pipeline import PrefetchLoader as JPrefetchLoader
from rsuper_tpu.data.sampler import ChunkedSampler as JChunkedSampler
from rsuper_tpu_torch.data import crops, native_io
from rsuper_tpu_torch.data import dataset as ds
from rsuper_tpu_torch.data import preprocess as pre
from rsuper_tpu_torch.data import reports as rep
from rsuper_tpu_torch.data.class_weights import class_proportions
from rsuper_tpu_torch.data.nifti import write_nifti
from rsuper_tpu_torch.data.pipeline import PrefetchLoader, pack_record_cf
from rsuper_tpu_torch.data.sampler import ChunkedSampler
from rsuper_tpu_torch.data.table import Column, Table, isna

CLASSES = ["background", "kidney_left", "kidney_right", "liver", "pancreas",
           "pancreas_body", "pancreas_head", "pancreas_tail",
           "pancreatic_lesion"]
REPORT_CLASSES = ["background", "kidney_left", "kidney_right", "liver",
                  "pancreas_body", "pancreas_head", "pancreas_tail"]
COLS = ["BDMAP_ID", "Standardized Organ", "Standardized Location",
        "Tumor Size (mm)", "Unknow Tumor Size", "no lesion"]


# ------------------------------------------------------------------ tables
def _reports_df():
    """``tests/test_data.py:_reports_df``, copied."""
    rows = [
        dict(BDMAP_ID="C1", **{"Standardized Organ": "pancreas",
             "Standardized Location": "head", "Tumor Size (mm)": "20.0",
             "Unknow Tumor Size": "no", "no lesion": 0}),
        dict(BDMAP_ID="C2", **{"Standardized Organ": "kidney",
             "Standardized Location": "u", "Tumor Size (mm)": "15.0",
             "Unknow Tumor Size": "no", "no lesion": 0}),
        dict(BDMAP_ID="C3", **{"Standardized Organ": "pancreas",
             "Standardized Location": "tail", "Tumor Size (mm)": "0.0 x 0.0",
             "Unknow Tumor Size": "no", "no lesion": 0}),
        dict(BDMAP_ID="C4", **{"Standardized Organ": np.nan,
             "Standardized Location": np.nan, "Tumor Size (mm)": np.nan,
             "Unknow Tumor Size": np.nan, "no lesion": 1}),
        dict(BDMAP_ID="C5", **{"Standardized Organ": "pancreas",
             "Standardized Location": "head / body",
             "Tumor Size (mm)": "30 x 20 x 10",
             "Unknow Tumor Size": "no", "no lesion": 0}),
    ]
    return pd.DataFrame(rows)


def _seeded_reports(n_cases=40, seed=11):
    """A report table with every encoding the cleaning code meets: healthy
    flags as 0/1, yes/no, True/False and empty; sizes as one diameter, a x b
    (x c), 'u', 'multiple', hallucinated 0.0, empty; laterality present or
    not; several rows per case."""
    rng = np.random.default_rng(seed)
    organs = ["pancreas", "kidney", "liver", "spleen", ""]
    locs = {"pancreas": ["head", "body", "tail", "head / body", "u", ""],
            "kidney": ["left", "right", "u", ""],
            "liver": ["segment 2", "segment 5 / segment 6", "u"],
            "spleen": ["u"], "": [""]}
    sizes = ["12", "20.0", "30 x 20", "25 x 15 x 10", "u", "multiple",
             "0.0 x 3", "", "7"]
    healthy = ["1", "yes", "True", "1.0", "y"]
    out = []
    for i in range(n_cases):
        cid = f"BDMAP_{i:04d}"
        if rng.random() < 0.35:
            out.append([cid, "", "", "", "", str(rng.choice(healthy))])
            continue
        for _ in range(int(rng.integers(1, 4))):
            o = str(rng.choice(organs))
            out.append([cid, o, str(rng.choice(locs[o])),
                        str(rng.choice(sizes)),
                        str(rng.choice(["no", "no", "no", "yes", ""])),
                        str(rng.choice(["0", "no", "False", ""]))])
    return out


def _write_csv(path, header, rows):
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(f'"{c}"' if "," in c else c for c in r) + "\n")
    return str(path)


def _same_cell(a, b):
    if isna(a) or (not isinstance(b, str) and pd.isna(b)):
        return isna(a) and pd.isna(b)
    return a == b and type(a) is type(b if not hasattr(b, "item") else b.item())


def test_table_matches_pandas_read_csv(tmp_path):
    path = str(tmp_path / "r.csv")
    _reports_df().to_csv(path, index=False)
    extra = _write_csv(tmp_path / "x.csv",
                       ["i", "f", "b", "bn", "t", "e", "n", "s"],
                       [["1", "20.0", "True", "True", "x", "", "3", " 2 "],
                        ["2", "", "False", "", "yes", "", "", "NA"],
                        ["3", "5", "True", "False", "1", "", "4", "1e3"]])
    for p in (path, extra):
        t, df = Table.read_csv(p), pd.read_csv(p)
        assert list(t.columns) == list(df.columns) and len(t) == len(df)
        for name in df.columns:
            col, ref = t[name], df[name]
            assert all(_same_cell(a, b) for a, b in zip(col, ref)), name
            assert col.astype_str() == [str(v) for v in ref.astype(str)], name
            got = np.asarray(col.to_numeric(), float)
            want = pd.to_numeric(ref, errors="coerce").to_numpy(float)
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert (col.kind == "bool") == pd.api.types.is_bool_dtype(ref)
            assert (col.kind == "int") == pd.api.types.is_integer_dtype(ref)
    kinds = {k: c.kind for k, c in Table.read_csv(extra).columns.items()}
    assert kinds == {"i": "int", "f": "float", "b": "bool", "bn": "object",
                     "t": "object", "e": "float", "n": "float", "s": "float"}


def test_table_filter_rename_rows():
    t = Table({"a": Column([1, 2, 3], "int"),
               "b": Column(["x", float("nan"), "z"], "object")})
    f = t.filter([True, False, True])
    assert f["a"].values == [1, 3] and f["a"].kind == "int"
    assert list(f.rows()) == [{"a": 1, "b": "x"}, {"a": 3, "b": "z"}]
    assert "c" in t.rename({"a": "c"}) and "a" not in t.rename({"a": "c"})
    assert t["b"].isin({"x"}) == [True, False, False]
    assert Column(["a", "b", "a", float("nan"), float("nan")],
                  "object").unique()[:2] == ["a", "b"]
    with pytest.raises(ValueError):
        t.filter([True])
    with pytest.raises(ValueError):
        Table({"a": Column([1], "int"), "b": Column([1, 2], "int")})


@pytest.mark.parametrize("values", [
    ["0", "1", "", "yes", "True", "t", "no", "1.0", " Y "],
    ["True", "False", "True"],
    ["1", "0", "1"],
    ["", "", ""],
])
def test_is_healthy_matches_jax(tmp_path, values):
    p = _write_csv(tmp_path / "h.csv", ["no lesion"], [[v] for v in values])
    assert rep.is_healthy(Table.read_csv(p)["no lesion"]) == \
        jrep.is_healthy(pd.read_csv(p)["no lesion"]).tolist()


@pytest.mark.parametrize("source", ["test_data", "seeded"])
def test_report_cleaning_and_supervision_match_jax(tmp_path, source):
    path = str(tmp_path / "r.csv")
    if source == "test_data":
        _reports_df().to_csv(path, index=False)
        tumors = ["pancreas", "kidney"]
    else:
        _write_csv(path, COLS, _seeded_reports())
        tumors = ["pancreas", "kidney", "liver"]
    table, frame = rep.load_reports(path), jrep.load_reports(path)
    rows, ids, per_organ = rep.clean_reports(table, tumors)
    jrows, jids, jper = jrep.clean_reports(frame, tumors)
    assert ids == [str(i) for i in jids]
    assert {k: [str(i) for i in v] for k, v in per_organ.items()} == \
        {k: [str(i) for i in v] for k, v in jper.items()}
    assert rows["BDMAP_ID"].values == jrows["BDMAP_ID"].tolist()
    if source == "seeded":  # the cap on healthy cases drew a subsample
        n_healthy = sum(rep.is_healthy(table["no lesion"]))
        assert 0 < len(per_organ["healthy"]) < n_healthy
    for cid in table["BDMAP_ID"].unique():
        sub = table.filter([i == cid for i in table["BDMAP_ID"].values])
        jsub = frame[frame["BDMAP_ID"] == cid]
        sup = rep.case_supervision(sub)
        assert sup == jrep.case_supervision(jsub), cid
        groups = sup["segment_groups"] + [[o] for o in sup["organs_known"]]
        for g in groups + [None, "random", ["tail"]]:
            v, d = rep.estimate_tumor_volumes(sub, g)
            jv, jd = jrep.estimate_tumor_volumes(jsub, g)
            np.testing.assert_array_equal(v, jv)
            np.testing.assert_array_equal(d, jd)
    assert rep.case_supervision(None) == jrep.case_supervision(None)


def test_parse_and_segment_helpers_match_jax():
    for s in ("10", "10 x 20", "30 x 20 x 10", "u", "4 x y", 12.0, "nan"):
        a, b = rep.parse_size_mm(s), jrep.parse_size_mm(s)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
            assert a[0] == b[0] or (np.isnan(a[0]) and np.isnan(b[0]))
    for seg in ("segment 3", "head", "left", "tail"):
        assert rep.segment_to_label(seg) == jrep.segment_to_label(seg)
    for g in (["pancreas"], ["liver"], ["kidney"], ["head", "body"]):
        assert rep.expand_segment_group(g) == jrep.expand_segment_group(g)
        for c in ("liver_lesion", "pancreatic_lesion", "kidney_lesion"):
            assert rep.lesion_class_for_segments(g, c) == \
                jrep.lesion_class_for_segments(g, c)


def test_class_proportions_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    rows = [[f"c{i}", str(int(rng.integers(0, 3))),
             "" if rng.random() < 0.2 else str(int(rng.integers(0, 2)))]
            for i in range(30)]
    p = _write_csv(tmp_path / "ct.csv",
                   ["BDMAP ID", "number of pancreatic lesion instances",
                    "number of kidney lesion instances"], rows)
    ids = [f"c{i}" for i in range(0, 30, 2)] + ["missing"]
    names = ["pancreatic_lesion", "kidney_lesion", "liver_lesion"]
    assert class_proportions(Table.read_csv(p), ids, names) == \
        jclass_props(pd.read_csv(p), ids, names)


# ------------------------------------------------------- splits and sampler
def _case_tuples(cases):
    return [(c.case_id, c.path, c.is_report) for c in cases]


@pytest.mark.parametrize("n_mask,n_report", [(5, 1), (2, 7), (4, 4), (3, 0)])
def test_case_lists_and_splits_match_jax(n_mask, n_report):
    mask = [(f"m{i}", f"m{i}.npz") for i in range(n_mask)]
    report = [(f"r{i}", f"r{i}.npz") for i in range(n_report)]
    for seed in (0, 3):
        cases = ds.build_case_list(mask, report, balance=True, seed=seed)
        jcases = jds.build_case_list(mask, report, balance=True, seed=seed)
        assert _case_tuples(cases) == _case_tuples(jcases)
        tr, te = ds.split_train_test(cases * 3, seed=seed)
        jtr, jte = jds.split_train_test(jcases * 3, seed=seed)
        assert _case_tuples(tr) == _case_tuples(jtr)
        assert _case_tuples(te) == _case_tuples(jte)
        for fold in range(3):
            a = ds.kfold_split(cases, 3, fold, seed=seed)
            b = jds.kfold_split(jcases, 3, fold, seed=seed)
            assert [_case_tuples(x) for x in a] == [_case_tuples(x) for x in b]


@pytest.mark.parametrize("items,per_epoch,shards", [(10, 6, 1), (7, 8, 2),
                                                     (3, 10, 1)])
def test_chunked_sampler_matches_jax(items, per_epoch, shards):
    for shard in range(shards):
        a = ChunkedSampler(items, per_epoch, shard, shards, seed=5)
        b = JChunkedSampler(items, per_epoch, shard, shards, seed=5)
        for e in range(5):
            np.testing.assert_array_equal(a.epoch_indices(e),
                                          b.epoch_indices(e))


# ---------------------------------------------------------------- crops
def test_crops_match_jax():
    rng0 = np.random.default_rng(3)
    img = rng0.normal(size=(50, 44, 40)).astype(np.float32)
    lab = np.zeros((3, 50, 44, 40), np.uint8)
    lab[1, 10:30, 8:30, 6:20] = 1
    lab[2, 20:24, 12:16, 10:13] = 1
    fg = lab[1].copy()
    fg[40:44, 2:5, 30:33] = 1  # a speck the denoise removes
    for seed in range(6):
        for fn, jfn, args in (
            (crops.crop_3d, jcrops.crop_3d, (img, lab, (16, 20, 24))),
            (crops.crop_around, jcrops.crop_around,
             (img, lab, (16, 20, 24), (25, 20, 10))),
            (crops.random_crop_on_tumor, jcrops.random_crop_on_tumor,
             (img, lab, [2], (16, 16, 16), seed % 2 == 0, [1])),
            (crops.crop_foreground, jcrops.crop_foreground,
             (img, lab, fg, (24, 26, 20))),
        ):
            a = fn(*args, rng=np.random.default_rng(seed))
            b = jfn(*args, rng=np.random.default_rng(seed))
            assert type(a) is type(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(crops.denoise_mask(fg), jcrops.denoise_mask(fg))
    for size in ((60, 40, 40), (48, 48, 48)):
        for x, y in zip(crops.pad_pair(img, lab, size),
                        jcrops.pad_pair(img, lab, size)):
            np.testing.assert_array_equal(x, y)


# -------------------------------------------------------------- dataset
def _make_mask_case(tmp_path, name="BDMAP_A"):
    """``tests/test_data.py:_make_mask_case``, copied."""
    rng = np.random.default_rng(5)
    img = rng.normal(size=(64, 64, 64)).astype(np.float32)
    labels = np.zeros((len(CLASSES), 64, 64, 64), bool)
    labels[CLASSES.index("pancreas"), 20:40, 20:40, 20:40] = True
    labels[CLASSES.index("pancreatic_lesion"), 28:34, 28:34, 28:34] = True
    path = str(tmp_path / f"{name}.npz")
    np.savez_compressed(path, image=img, labels=np.packbits(labels, axis=0),
                        num_classes=len(CLASSES))
    return name, path


def _make_report_case(tmp_path, name="BDMAP_R"):
    """``tests/test_data.py:_make_report_case``, copied."""
    rng = np.random.default_rng(6)
    img = rng.normal(size=(64, 64, 64)).astype(np.float32)
    labels = np.zeros((len(REPORT_CLASSES), 64, 64, 64), bool)
    labels[REPORT_CLASSES.index("pancreas_head"), 16:32, 16:32, 16:32] = True
    labels[REPORT_CLASSES.index("pancreas_body"), 32:44, 16:32, 16:32] = True
    labels[REPORT_CLASSES.index("liver"), 40:60, 40:60, 40:60] = True
    path = str(tmp_path / f"{name}.npz")
    np.savez_compressed(path, image=img, labels=np.packbits(labels, axis=0),
                        num_classes=len(REPORT_CLASSES))
    return name, path


REPORT_ROWS = [  # tests/test_data.py:_report_rows, and a two-segment tumour
    ["BDMAP_R", "pancreas", "head", "12.0", "no", "0"],
    ["BDMAP_S", "pancreas", "head / body", "30 x 20", "no", "0"],
]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("cases")
    p = _write_csv(d / "rows.csv", COLS, REPORT_ROWS)
    return dict(
        mask=ds.Case(*_make_mask_case(d), False),
        report=ds.Case(*_make_report_case(d), True),
        report2=ds.Case(*_make_report_case(d, "BDMAP_S"), True),
        rows=rep.load_reports(p), frame=jrep.load_reports(p))


def _datasets(cases, which, proportions=None, crop=(32, 32, 32)):
    kw = dict(classes=tuple(CLASSES), report_classes=tuple(REPORT_CLASSES),
              crop_size=crop, tumor_classes=("pancreas",))
    picked = [cases[w] for w in which]
    a = ds.RSuperDataset(picked, ds.RSuperDataConfig(**kw),
                         report_rows=cases["rows"],
                         class_proportions=proportions)
    b = jds.RSuperDataset([jds.Case(c.case_id, c.path, c.is_report)
                           for c in picked], jds.RSuperDataConfig(**kw),
                          report_rows=cases["frame"],
                          class_proportions=proportions)
    return a, b


def _assert_records_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("which", ["mask", "report", "report2"])
@pytest.mark.parametrize("props", [None, {"pancreatic_lesion": 0.3,
                                          "healthy": 0.6}])
def test_dataset_records_match_jax(cases, which, props):
    a, b = _datasets(cases, [which], props)
    kinds = set()
    for seed in range(8):
        ra = a.sample(0, np.random.default_rng(seed))
        rb = b.sample(0, np.random.default_rng(seed))
        _assert_records_equal(ra, rb)
        assert ra["image"].shape == (52, 72, 72)
        kinds.add((float(ra["apply_affine"]), bool(ra["segment_mask"].any())))
    if which != "mask":  # both the segment-targeted and the random crop ran
        assert (0.0, True) in kinds and (1.0, False) in kinds
    assert ("class_weights" in ra) == (props is not None)
    _assert_records_equal(ds.to_channels_last(dict(ra)),
                          jds.to_channels_last(dict(rb)))


def test_prefetch_loader_batches_match_jax(cases):
    a, b = _datasets(cases, ["mask", "report", "report2"], crop=(16, 16, 16))
    idx = [0, 1, 2, 1, 0, 2]
    got = list(PrefetchLoader(a, 2, idx, num_workers=1, seed=3))
    want = list(JPrefetchLoader(b, 2, idx, num_workers=1, seed=3,
                                pack_masks=True))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_records_equal(g, w)
    loader = PrefetchLoader(a, 2, idx, num_workers=2, seed=3)
    first = next(iter(loader))  # a consumer that stops early
    assert first["masks_packed"].shape == (2, 36, 56, 56, 4)


def test_pack_masks_cl_native_matches_numpy():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native host library cannot be built")
    assert native_io.path() == "native"
    rng = np.random.default_rng(3)
    for C in (16, 13, 5, 1):
        sh = (6, 7, 8)
        label = (rng.random((C,) + sh) < 0.4).astype(np.uint8)
        unk = (rng.random((C,) + sh) < 0.2).astype(np.uint8)
        seg = (rng.random((C,) + sh) < 0.1).astype(np.uint8)
        m = np.moveaxis(np.concatenate([label, unk, seg], axis=0), 0, -1)
        ref = np.packbits(m, axis=-1, bitorder="little")
        np.testing.assert_array_equal(
            native_io.pack_masks_cl(label, unk, seg), ref)
        m0 = np.moveaxis(
            np.concatenate([label, 0 * unk, 0 * seg], axis=0), 0, -1)
        np.testing.assert_array_equal(
            native_io.pack_masks_cl(label, None, None),
            np.packbits(m0, axis=-1, bitorder="little"))
        rec = {"image": rng.normal(size=sh).astype(np.float32),
               "label": label, "unk": unk, "segment_mask": seg}
        np.testing.assert_array_equal(pack_record_cf(dict(rec))["masks_packed"],
                                      ref)
    src = rng.random((10, 12, 14)).astype(np.float32)
    from scipy import ndimage as ndi

    np.testing.assert_allclose(native_io.resample(src, (20, 24, 28), order=1),
                               ndi.zoom(src, 2.0, order=1, mode="nearest",
                                        grid_mode=False), atol=1e-6)
    lab = (rng.random((10, 10, 10)) * 4).astype(np.uint8)
    np.testing.assert_array_equal(
        native_io.resample(lab, (15, 20, 20), order=0),
        ndi.zoom(lab, (1.5, 2.0, 2.0), order=0, mode="nearest",
                 grid_mode=False))


# ----------------------------------------------------------- preprocessing
def test_preprocess_case_and_load_case_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    ct = (rng.normal(size=(20, 18, 16)) * 100).astype(np.float32)
    aff = np.diag([1.5, 1.5, 2.0, 1.0])
    write_nifti(str(tmp_path / "ct.nii.gz"), ct, aff)
    organ = np.zeros((20, 18, 16), np.uint8)
    organ[5:15, 4:12, 3:11] = 1
    write_nifti(str(tmp_path / "organ.nii.gz"), organ, aff)
    labels = {"pancreas": str(tmp_path / "organ.nii.gz"), "liver": None,
              "background": None}
    classes = ["background", "liver", "pancreas"]
    kw = dict(classes=classes, min_size=(40, 36, 36))
    meta = pre.preprocess_case(str(tmp_path / "ct.nii.gz"), labels,
                               str(tmp_path / "a.npz"), **kw)
    jmeta = jpre.preprocess_case(str(tmp_path / "ct.nii.gz"), labels,
                                 str(tmp_path / "b.npz"), **kw)
    assert meta == jmeta
    assert json.load(open(tmp_path / "a.json")) == meta
    (img, lab), (jimg, jlab) = (pre.load_case(str(tmp_path / "a.npz")),
                                jpre.load_case(str(tmp_path / "b.npz")))
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(lab, jlab)
    assert lab.shape == (3, 40, 36, 36) and lab[2].sum() > 0
    assert lab[1].sum() == 0 and (lab[0] == 1 - lab[2]).all()
    # a case without labels
    pre.preprocess_case(str(tmp_path / "ct.nii.gz"), None,
                        str(tmp_path / "c.npz"), min_size=(8, 8, 8))
    img2, lab2 = pre.load_case(str(tmp_path / "c.npz"), num_classes=3)
    assert lab2 is None and img2.shape == (30, 27, 32)
