"""The port's organ-mask tools and sanity dumps against the JAX package, on
the CPU (host numpy: every comparison is exact).

* ``organ_masks/labels.py``: split and combined label maps of seeded maps.
* ``organ_masks/dataset_prep.py``: shape checks, ``dataset.json`` byte for
  byte, the nnU-Net layout.
* ``organ_masks/maintenance.py``: the bladder repair on volumes, NIfTI trees
  and packed stacks, the staging copy, the debug dump, id lists read from
  CSV (numeric ids, empty cells) and the CLI; NIfTI files compared after
  decompression, header and voxels byte for byte (the two packages gzip at
  other levels).
* ``organ_masks/predict_suborgans.py``: discovery, resume and sharding; its
  ``main`` raises without CUDA unless the CPU is asked for, fails without
  ``nnunetv2`` with the JAX package's message, and hands a stub predictor
  the JAX package's file lists.
* ``utils/debug_dumps.py``: ``SanityDumper`` on arrays and on tensors.
"""

import gzip
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from rsuper_tpu.data.nifti import write_nifti as jwrite_nifti
from rsuper_tpu.organ_masks import dataset_prep as jprep
from rsuper_tpu.organ_masks import labels as jlabels
from rsuper_tpu.organ_masks import maintenance as jmaint
from rsuper_tpu.organ_masks import predict_suborgans as jpred
from rsuper_tpu.utils import debug_dumps as jdumps
from rsuper_tpu_torch.organ_masks import dataset_prep as tprep
from rsuper_tpu_torch.organ_masks import labels as tlabels
from rsuper_tpu_torch.organ_masks import maintenance as tmaint
from rsuper_tpu_torch.organ_masks import predict_suborgans as tpred
from rsuper_tpu_torch.utils import debug_dumps as tdumps


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _nifti_bytes(path):
    raw = Path(path).read_bytes()
    return gzip.decompress(raw) if str(path).endswith(".gz") else raw


def _same_files(a, b):
    """Every file under `a` and `b`, by relative path: NIfTIs equal after
    decompression, the rest byte for byte."""
    fa = sorted(p.relative_to(a) for p in Path(a).rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in Path(b).rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        if rel.suffix == ".npz":
            with np.load(Path(a) / rel) as za, np.load(Path(b) / rel) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    _same(za[k], zb[k])
        else:
            assert _nifti_bytes(Path(a) / rel) == _nifti_bytes(Path(b) / rel)
    return fa


# ----------------------------------------------------------------- labels
def test_label_maps_match_jax():
    for name in ("SUBSEG_LABELS", "REGION_LABELS", "MERGED_ORGANS"):
        assert getattr(tlabels, name) == getattr(jlabels, name)
    rng = np.random.default_rng(0)
    m = rng.integers(0, 36, size=(12, 10, 9)).astype(np.int16)
    for merged in (True, False):
        got = tlabels.split_label_map(m, include_merged=merged)
        want = jlabels.split_label_map(m, include_merged=merged)
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    split = jlabels.split_label_map(m)
    for organ in ("liver", "pancreas", "aorta"):
        _same(tlabels.merged_organ(split, organ),
              jlabels.merged_organ(split, organ))
    names = list(jlabels.REGION_LABELS)[1:]
    masks = {n: (rng.random((12, 10, 9)) < 0.1).astype(np.uint8)
             for n in rng.choice(names, 20, replace=False)}
    for lesion, seg in (("kidney_lesion", "kidney_left"),
                        ("pancreatic_lesion", "pancreas_head"),
                        ("liver_lesion", "liver_segment_3")):
        masks[lesion] = (rng.random((12, 10, 9)) < 0.3).astype(np.uint8)
        masks[seg] = (rng.random((12, 10, 9)) < 0.3).astype(np.uint8)
    got = tlabels.combine_label_maps(masks)
    _same(got, jlabels.combine_label_maps(masks))
    assert len(np.unique(got)) > 10


# ------------------------------------------------------------ dataset prep
def test_dataset_prep_matches_jax(tmp_path):
    img_dir = tmp_path / "images"
    lab_dir = tmp_path / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    for case, ishape, lshape in (("A", (4, 4, 4), (4, 4, 4)),
                                 ("B", (4, 4, 4), (5, 4, 4))):
        jwrite_nifti(str(img_dir / f"{case}.nii.gz"), np.zeros(ishape))
        jwrite_nifti(str(lab_dir / f"{case}.nii.gz"),
                     np.zeros(lshape, np.int16))
    jwrite_nifti(str(img_dir / "C_0000.nii"), np.zeros((3, 3, 3)))
    jwrite_nifti(str(lab_dir / "C.nii"), np.zeros((3, 3, 3), np.int16))
    jwrite_nifti(str(lab_dir / "D.nii.gz"), np.zeros((3, 3, 3), np.int16))
    (lab_dir / "notes.txt").write_text("x")
    bad = tprep.verify_data(str(img_dir), str(lab_dir))
    assert bad == jprep.verify_data(str(img_dir), str(lab_dir))
    assert len(bad) == 2

    labels = {"background": 0, "aorta": 1, "liver_lesion": 23}
    for mod, name in ((tprep, "t"), (jprep, "j")):
        spec = mod.make_dataset_json(str(tmp_path / name / "dataset.json"),
                                     labels, 7, {"0": "CT", "1": "PET"})
        assert spec["numTraining"] == 7
    assert (tmp_path / "t" / "dataset.json").read_bytes() == \
        (tmp_path / "j" / "dataset.json").read_bytes()

    for copy in (False, True):
        n_t = tprep.link_cases(str(img_dir), str(tmp_path / f"lt{copy}"),
                               copy=copy)
        n_j = jprep.link_cases(str(img_dir), str(tmp_path / f"lj{copy}"),
                               copy=copy)
        assert n_t == n_j == 3
        _same_files(tmp_path / f"lt{copy}", tmp_path / f"lj{copy}")
    assert tprep.link_cases(str(img_dir), str(tmp_path / "ltFalse")) == 0


# ------------------------------------------------------------- maintenance
def _blobs(seed, shape=(14, 14, 14)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < 0.18).astype(np.uint8)


def test_bladder_repair_matches_jax():
    for seed in range(4):
        bladder, gall = _blobs(seed), _blobs(seed + 10)
        _same(tmaint.largest_component(bladder),
              jmaint.largest_component(bladder))
        for g in (gall, None, gall[:6]):
            _same(tmaint.fix_bladder_volume(bladder, g),
                  jmaint.fix_bladder_volume(bladder, g))
    empty = np.zeros((4, 4, 4), np.uint8)
    _same(tmaint.largest_component(empty), jmaint.largest_component(empty))


def _tree(root):
    """Cases of a ``.../<id>/segmentations/`` tree: with and without a
    gallbladder (under both of its names), one of another grid."""
    for k in range(5):
        seg = root / f"BDMAP_{k}" / "segmentations"
        seg.mkdir(parents=True)
        jwrite_nifti(str(seg / "bladder.nii.gz"), _blobs(k),
                     np.diag([0.8, 0.8, 1.5, 1.0]))
        if k % 3 == 0:
            continue
        name = "gall_bladder.nii.gz" if k % 2 else "gallbladder.nii.gz"
        gall = _blobs(k + 20) if k != 4 else _blobs(k + 20, (10, 14, 14))
        jwrite_nifti(str(seg / name), gall)
    (root / "BDMAP_0" / "other").mkdir()
    jwrite_nifti(str(root / "BDMAP_0" / "other" / "bladder.nii.gz"),
                 _blobs(9))


def _packed_case(path, seed, classes):
    rng = np.random.default_rng(seed)
    labels = np.stack([_blobs(seed + i) for i in range(len(classes))])
    np.savez_compressed(path, image=rng.normal(size=(14, 14, 14))
                        .astype(np.float32),
                        labels=np.packbits(labels, axis=0),
                        num_classes=np.int64(len(classes)))


def test_maintenance_matches_jax(tmp_path):
    for name in ("t", "j"):
        _tree(tmp_path / name / "tree")
    rows = {}
    for mod, name in ((tmaint, "t"), (jmaint, "j")):
        root = str(tmp_path / name / "tree")
        out = []
        for kw in (dict(dry_run=True), dict(ids={"BDMAP_1", "BDMAP_3"},
                                             part=1, parts=2),
                   dict(skip_no_gall=False)):
            out += [(Path(p).relative_to(root).as_posix(), s)
                    for p, s in mod.fix_bladder_tree(root, **kw)]
        rows[name] = out
    assert rows["t"] == rows["j"]
    assert {s for _, s in rows["t"]} == {"ok", "ok_no_gall",
                                         "skipped_no_gall"}
    _same_files(tmp_path / "t" / "tree", tmp_path / "j" / "tree")

    classes = ["background", "bladder", "gall_bladder", "liver"]
    for name in ("t", "j"):
        (tmp_path / name / "packed").mkdir()
        for k in range(3):
            _packed_case(tmp_path / name / "packed" / f"BDMAP_{k}.npz", k,
                         classes)
    for mod, name in ((tmaint, "t"), (jmaint, "j")):
        paths = sorted(str(p) for p in (tmp_path / name / "packed")
                       .glob("*.npz"))
        res = mod.fix_bladder_npz(paths, classes)
        assert [s for _, s in res] == ["ok"] * 3
        with pytest.raises(ValueError):
            mod.fix_bladder_npz(paths, ["background", "liver"])
        written = mod.npz_to_debug_niis(
            str(tmp_path / name / "packed"), classes, num=2, seed=1,
            out_root=str(tmp_path / name / "debug"))
        assert len(written) == 8
    _same_files(tmp_path / "t" / "packed", tmp_path / "j" / "packed")
    _same_files(tmp_path / "t" / "debug", tmp_path / "j" / "debug")

    src_ct, src_mask = tmp_path / "cts", tmp_path / "masks"
    for k in range(2):
        (src_ct / f"BDMAP_{k}").mkdir(parents=True)
        jwrite_nifti(str(src_ct / f"BDMAP_{k}" / "ct.nii.gz"), _blobs(k))
    (src_mask / "BDMAP_0").mkdir(parents=True)
    jwrite_nifti(str(src_mask / "BDMAP_0" / "combined_labels.nii.gz"),
                 _blobs(5))
    ids = ["BDMAP_0", "BDMAP_1", "BDMAP_MISSING"]
    msgs = [mod.copy_dataset(ids, str(src_ct), str(src_mask),
                             str(tmp_path / name / "nnraw"), workers=2)
            for mod, name in ((tmaint, "t"), (jmaint, "j"))]
    assert msgs[0] == msgs[1]
    assert any("not found" in m for m in msgs[0])
    _same_files(tmp_path / "t" / "nnraw", tmp_path / "j" / "nnraw")


@pytest.mark.parametrize("text", [
    "BDMAP ID,x\nBDMAP_1,1\n,2\nBDMAP_2,3\n",
    "BDMAP_ID\n12\n7\n",
    "ID,BDMAP_ID\n1.5,3\n,\n2,4\n",
    "x,y\n12\n\n7.0,2\n,3\n",
    "case\nTrue\nFalse\n",
])
def test_id_lists_read_as_pandas_reads_them(tmp_path, text):
    (tmp_path / "ids.csv").write_text(text)
    got = tmaint._read_id_list(str(tmp_path / "ids.csv"))
    assert got == jmaint._read_id_list(str(tmp_path / "ids.csv")) and got
    (tmp_path / "ids.txt").write_text("A\n\n B \n")
    assert tmaint._read_id_list(str(tmp_path / "ids.txt")) == {"A", "B"}


def test_maintenance_cli_matches_jax(tmp_path, capsys):
    classes = "background,bladder,gall_bladder"
    outs = {}
    for mod, name in ((tmaint, "t"), (jmaint, "j")):
        root = tmp_path / name
        _tree(root / "tree")
        (root / "packed").mkdir()
        _packed_case(root / "packed" / "BDMAP_9.npz", 9, classes.split(","))
        (root / "ids.csv").write_text("BDMAP ID\nBDMAP_1\nBDMAP_2\n")
        mod.main(["fix-bladder", "--root", str(root / "tree"), "--ids",
                  str(root / "ids.csv"), "--no-skip-no-gall-bladder"])
        mod.main(["fix-bladder-npz", str(root / "packed" / "BDMAP_9.npz"),
                  "--classes", classes])
        mod.main(["npz2nii-debug", "--root", str(root / "packed"),
                  "--classes", classes, "--num", "1", "--out",
                  str(root / "debug")])
        mod.main(["copy-dataset", "--ids", str(root / "ids.csv"),
                  "--source-ct-dir", str(root / "tree"), "--source-mask-dir",
                  str(root / "tree"), "--dest", str(root / "nnraw")])
        outs[name] = capsys.readouterr().out.replace(str(root), "ROOT")
    assert outs["t"] == outs["j"] and "ok" in outs["t"]
    _same_files(tmp_path / "t", tmp_path / "j")


# ------------------------------------------------------- predict_suborgans
def test_suborgan_discovery_and_sharding_match_jax(tmp_path):
    src = tmp_path / "cts"
    out = tmp_path / "preds"
    src.mkdir()
    out.mkdir()
    for i in (3, 0, 4, 1, 2):
        (src / f"BDMAP_{i}.nii.gz").write_bytes(b"x")
    (src / "AAA_straydir").mkdir()
    (src / "AAA_meta.csv").write_bytes(b"z")
    (src / ".hidden.nii.gz").write_bytes(b"z")
    (out / "BDMAP_1.nii.gz").write_bytes(b"y")
    bd = tmp_path / "bd"
    for c in ("BDMAP_B", "BDMAP_A", "notacase"):
        (bd / c).mkdir(parents=True)
    for ids in (None, ["BDMAP_4", "BDMAP_0", "BDMAP_9"]):
        for fmt, root in ((False, src), (True, bd)):
            got = tpred.collect_cases(str(root), str(out), fmt, ids)
            assert got == jpred.collect_cases(str(root), str(out), fmt, ids)
    fi, fo = tpred.collect_cases(str(src), str(out))
    assert len(fi) == 5
    assert tpred.filter_existing_outputs(fi, fo) == \
        jpred.filter_existing_outputs(fi, fo)
    for parts in (1, 2, 3, 7):
        for part in range(parts):
            assert tpred.split_files(fi, fo, parts, part) == \
                jpred.split_files(fi, fo, parts, part)
    argv = ["--pth", "a", "--outdir", "b", "--checkpoint", "c",
            "--num_parts", "3", "--part_id", "2", "--BDMAP_format"]
    got, want = vars(tpred.parse_args(argv)), vars(jpred.parse_args(argv))
    assert got.pop("device") == "cuda" and got == want


def test_suborgan_main_needs_cuda_then_nnunet(tmp_path, monkeypatch):
    argv = ["--pth", str(tmp_path), "--outdir", str(tmp_path / "o"),
            "--checkpoint", "c"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpred.main(argv)
    with pytest.raises(SystemExit) as got:
        tpred.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jpred.main(argv)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("nnunetv2 is required")


def test_suborgan_main_hands_the_predictor_the_jax_lists(tmp_path,
                                                         monkeypatch):
    """A stub ``nnunetv2`` records what each package's ``main`` asks of
    the predictor, with an ``--ids`` CSV read by each package's reader."""
    calls = []

    class Predictor:
        def __init__(self, **kw):
            calls.append(("init", {k: v for k, v in kw.items()
                                   if k != "device"}))

        def initialize_from_trained_model_folder(self, *a, **kw):
            calls.append(("load", a, kw))

        def predict_from_files(self, *a, **kw):
            calls.append(("predict", a, kw))

    leaf = types.ModuleType("nnunetv2.inference.predict_from_raw_data")
    leaf.nnUNetPredictor = Predictor
    for name in ("nnunetv2", "nnunetv2.inference"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, leaf.__name__, leaf)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "cts"
    src.mkdir()
    for i in range(6):
        (src / f"BDMAP_{i}.nii.gz").write_bytes(b"x")
    (tmp_path / "ids.csv").write_text("BDMAP ID,n\nBDMAP_5,1\nBDMAP_2,\n"
                                      "BDMAP_0,3\nBDMAP_4,4\n")
    got = {}
    for mod, extra in ((tpred, ["--device", "cpu"]), (jpred, [])):
        calls.clear()
        mod.main(["--pth", str(src), "--outdir", str(tmp_path / "o"),
                  "--checkpoint", "ck", "--ids", str(tmp_path / "ids.csv"),
                  "--num_parts", "2", "--part_id", "1"] + extra)
        got[mod] = list(calls)
    assert got[tpred] == got[jpred]
    assert got[tpred][-1][1][0] == [[str(src / "BDMAP_4.nii.gz")],
                                    [str(src / "BDMAP_5.nii.gz")]]


# --------------------------------------------------------- sanity dumps
def test_sanity_dumper_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    lab = (rng.random((2, 6, 7, 5, 3)) < 0.2).astype(np.float32)
    lab[1, ..., 1] = 0.0  # an empty channel of item 1: skipped
    bce = rng.random((2, 6, 7, 5)).astype(np.float32)
    names = ["bg", "organ"]  # fewer names than channels
    dumpers = {"t": tdumps.SanityDumper(str(tmp_path / "t"), limit=2),
               "j": jdumps.SanityDumper(str(tmp_path / "j"), limit=2),
               "tensor": tdumps.SanityDumper(str(tmp_path / "tensor"),
                                             limit=2)}
    for call in range(3):
        b = call % 2
        dumpers["t"].dump({"label": lab, "bce": bce}, names, batch_idx=b)
        dumpers["j"].dump({"label": lab, "bce": bce}, names, batch_idx=b)
        dumpers["tensor"].dump(
            {"label": torch.from_numpy(lab).bool(),
             "bce": torch.from_numpy(bce).requires_grad_(True)},
            names, batch_idx=b)
    assert [d.counter for d in dumpers.values()] == [2, 2, 2]
    files = _same_files(tmp_path / "t", tmp_path / "j")
    assert _same_files(tmp_path / "t", tmp_path / "tensor") == files
    assert sorted(str(f) for f in files if f.parts[0] == "1") == [
        "1/bce_bg.nii.gz", "1/label_2.nii.gz", "1/label_bg.nii.gz"]


def test_sanity_dumper_moves_bf16_tensors_to_the_host(tmp_path):
    x = torch.linspace(-2, 2, 2 * 4 * 4 * 4).reshape(2, 4, 4, 4)
    d = tdumps.SanityDumper(str(tmp_path / "t"))
    d.dump({"x": x.to(torch.bfloat16)})
    jdumps.SanityDumper(str(tmp_path / "j")).dump(
        {"x": x.to(torch.bfloat16).float().numpy()})
    assert _same_files(tmp_path / "t", tmp_path / "j") == \
        [Path("0/x_0.nii.gz")]
