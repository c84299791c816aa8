"""The phantom accuracy study on the port
(``rsuper_tpu_torch.phantom_benchmark``) against the JAX tool (``tools/phantom_benchmark.py``) on the CPU: the same
phantoms and CSVs, the same training configuration, the same evaluation of
the same parameters, the same aggregation; a tiny whole run; and the
R-Super mechanism (``tests/test_e2e.py::test_report_supervision_learns_tumor``)
on the port."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu_torch import phantom_benchmark as pb

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_phantom_benchmark", ROOT / "tools" / "phantom_benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtool = _jax_tool()
SMALL = dict(n_mask=2, n_report=3, n_test=1)
# a phantom side that keeps the tests' sliding windows few; at 32 and 40
# the tools' organ centres (24-40) leave the volume, at 48 the seeds used
# here place every tumour inside it
SMALL_SIZE = 48


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The training loop runs its loader thread beside PyTorch's pool of
    spinning intra-op threads; with several test processes on the machine
    that pool slows these tests tens of times, so they take one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seed 0's small study written by both tools, SMALL_SIZE³ phantoms."""
    out = {}
    sizes = jtool.SIZE, pb.SIZE
    jtool.SIZE = pb.SIZE = SMALL_SIZE
    try:
        for name, tool in (("jax", jtool), ("port", pb)):
            root = tmp_path_factory.mktemp(f"phantom_{name}")
            tool.generate(str(root), **SMALL, seed=0)
            out[name] = root
    finally:
        jtool.SIZE, pb.SIZE = sizes
    return out


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_equals_the_jax_tool(tmp_path, monkeypatch, seed):
    """(a) Every case's image and labels are bit-equal to the JAX tool's
    (SMALL_SIZE³ phantoms); ``classes.json``, ``per_tumor.csv`` and
    ``test_gt.csv`` are byte-equal (pandas' ``to_csv`` against
    ``data/table.py``'s)."""
    monkeypatch.setattr(jtool, "SIZE", SMALL_SIZE)
    monkeypatch.setattr(pb, "SIZE", SMALL_SIZE)
    kw = dict(SMALL, n_test=2, seed=seed, contrast_range=(0.25, 1.6),
              mask_contrast_range=(1.4, 1.6) if seed else None)
    for name, tool in (("jax", jtool), ("port", pb)):
        tool.generate(str(tmp_path / name), **kw)
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    assert sum(f.endswith(".npz") for f in files) == sum(kw[k] for k in SMALL)
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "port" / f
        if f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype, (f, k)
                    assert np.array_equal(za[k], zb[k]), (f, k)
        else:
            assert a.read_bytes() == b.read_bytes(), f
    rows = (tmp_path / "port" / "per_tumor.csv").read_text().splitlines()
    assert len(rows) > 1 and rows[0].startswith("BDMAP_ID,Standardized")


class _Captured(Exception):
    pass


@pytest.mark.parametrize("with_reports", [False, True])
def test_train_variant_config_equals_the_jax_tool(data, monkeypatch,
                                                  with_reports):
    """(b) Each arm's TrainConfig equals the JAX tool's field by field
    (the fields both packages have), and so do its dataset (cases, data
    configuration, report rows) and model arguments. Both training loops
    are stand-ins that keep what they are handed (the JAX loop's module
    imports orbax for seconds)."""
    seen = {}

    def capture(name):
        def train(cfg, model, dataset, *a, **k):
            seen[name] = (cfg, dataset)
            raise _Captured
        return train

    for name, module in (("jax", "rsuper_tpu.train.loop"),
                         ("port", "rsuper_tpu_torch.train.loop")):
        stand_in = types.ModuleType(module)
        stand_in.train = capture(name)
        monkeypatch.setitem(sys.modules, module, stand_in)
    root = str(data["port"])
    for fn in (jtool.train_variant, pb.train_variant):
        with pytest.raises(_Captured):
            fn(root, with_reports, 17, seed=3, crop=16, report_weight=0.2)
    (jc, jd), (tc, td) = seen["jax"], seen["port"]
    shared = ({f.name for f in dataclasses.fields(jc)}
              & {f.name for f in dataclasses.fields(tc)})
    assert len(shared) > 40

    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        return v

    for f in sorted(shared):
        assert norm(getattr(jc, f)) == norm(getattr(tc, f)), f
    assert tc.report_volume_loss_basic == (0.2 if with_reports else 0.0)
    assert [(c.case_id, c.path, c.is_report) for c in jd.cases] == \
        [(c.case_id, c.path, c.is_report) for c in td.cases]
    assert dataclasses.asdict(jd.cfg) == dataclasses.asdict(td.cfg)
    if with_reports:
        jrows = jd.report_rows.reset_index(drop=True)
        assert list(jrows.columns) == list(td.report_rows.columns)
        for name in jrows.columns:
            assert [str(v) for v in jrows[name]] == \
                [str(v) for v in td.report_rows[name].values], name
    else:
        assert jd.report_rows is None and td.report_rows is None


def _record_preds(monkeypatch, module, out):
    """Keep every (lesion mask, detection volume) `module` computes."""
    real = module.detect_volume_from_mask

    def record(pred, *a, **k):
        vol = real(pred, *a, **k)
        out.append((np.array(pred), float(vol)))
        return vol

    monkeypatch.setattr(module, "detect_volume_from_mask", record)


def test_evaluate_agrees_with_the_jax_tool(data, monkeypatch):
    """(c) The JAX ResUNet's seeded parameters (a flax tree), the final
    head's lesion channel made confident (its logits scaled to a standard
    deviation of 8 and shifted to a mean of -1 of them over a window of the
    test phantom, as ``chip_smoke.py``'s ``HEAD_SIGMAS`` shift them, so
    that few voxels sit near 0.5), go across through ``models/params.py``:
    on the same test phantom the two packages' lesion masks differ in at
    most 0.01 % of the voxels (measured: 0 of 110,592; 1 of 221,184 with a
    second test phantom), the detection volumes and case-level metrics are
    equal, and Dice and NSD lie within what the differing voxels allow."""
    import rsuper_tpu.eval.detection as jdet
    from rsuper_tpu.models import get_model as jget_model

    import rsuper_tpu_torch.eval.detection as tdet
    from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                         init_params, load_flax_params)

    args = pb.variant_config(".", True, 1).model_args
    jmodel = jget_model("resunet", 3, args, dtype=jnp.float32)
    # seeded parameters in the JAX tree's layout (flax's own init runs its
    # ops one by one for seconds on the CPU)
    tmodel = init_params(get_model("resunet", 3, args, dtype=torch.float32))
    params = {"params": {}}
    for key, value in flax_from_state_dict(tmodel.state_dict(),
                                           model=tmodel).items():
        *path, leaf = key.split("/")
        node = params["params"]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    with np.load(data["jax"] / "test_npz" / "BDMAP_T000.npz") as z:
        win = torch.from_numpy(z["image"][8:40, 8:40, 8:40])
    with torch.no_grad():
        logits = tmodel(win[None, ..., None])["segmentation"][..., 2]
    head = params["params"]["outc"]
    scale = 8.0 / float(logits.std())
    head["kernel"] = np.asarray(head["kernel"]).copy()
    head["bias"] = np.asarray(head["bias"]).copy()
    head["kernel"][..., 2] *= scale
    head["bias"][2] = head["bias"][2] * scale - float(logits.mean()) * scale \
        - 8.0
    load_flax_params(tmodel, params)
    tparams = {k: p.detach() for k, p in tmodel.named_parameters()}

    jpred, tpred = [], []
    _record_preds(monkeypatch, jdet, jpred)
    _record_preds(monkeypatch, tdet, tpred)
    jm = jtool.evaluate(jmodel, params, str(data["jax"]), crop=32)
    tm = pb.evaluate(tmodel, tparams, str(data["jax"]), crop=32,
                     device="cpu")
    assert len(jpred) == len(tpred) == SMALL["n_test"]
    assert [v for _, v in jpred] == [v for _, v in tpred]  # detection
    jmask, tmask = [m for m, _ in jpred], [m for m, _ in tpred]
    differ = sum(int((a != b).sum()) for a, b in zip(jmask, tmask))
    total = sum(a.size for a in jmask)
    assert differ <= 1e-4 * total, (differ, total)
    hot = [float(a.mean()) for a in jmask]
    assert all(0.001 < h < 0.5 for h in hot), hot  # neither empty nor full
    for k in ("sensitivity", "specificity", "f1", "volume_threshold"):
        assert json.dumps(tm[k]) == json.dumps(jm[k]), k  # NaN alike
    # a voxel moves a case's Dice by at most 2 / |its masks|, its NSD by
    # at most the surface voxels it touches (≤ 27) / |both surfaces|
    for k in ("lesion_dice", "lesion_nsd"):
        assert abs(tm[k] - jm[k]) <= 27.0 * differ / min(
            int(a.sum()) for a in jmask), k
    assert tm["cases"] == SMALL["n_test"]


FIXED = [
    {"mask_only": dict(lesion_dice=0.61, lesion_nsd=0.70, f1=0.90,
                       sensitivity=0.875, specificity=1.0),
     "report": dict(lesion_dice=0.65, lesion_nsd=0.74, f1=0.95,
                    sensitivity=0.9375, specificity=1.0)},
    {"mask_only": dict(lesion_dice=0.01, lesion_nsd=0.02, f1=0.0,
                       sensitivity=0.0, specificity=1.0),
     "report": dict(lesion_dice=0.03, lesion_nsd=0.05, f1=0.4,
                    sensitivity=0.25, specificity=0.5)},
    {"mask_only": dict(lesion_dice=0.72, lesion_nsd=0.81, f1=0.96,
                       sensitivity=1.0, specificity=0.75),
     "report": dict(lesion_dice=0.70, lesion_nsd=0.80, f1=0.91,
                    sensitivity=0.9375, specificity=0.5)},
]


@pytest.mark.parametrize("seeds", [1, 3])
def test_aggregation_equals_the_jax_tool(tmp_path, monkeypatch, seeds):
    """(d) ``main`` with ``run_one_seed`` patched to fixed rows writes the
    JAX tool's ``summary.json`` (``--exclude_degenerate 0.05``: the second
    seed's arms both score under it), and ``tools/summarize_phantom.py``
    reads the port's ``seed<k>/result.json`` files."""
    for tool in (jtool, pb):
        monkeypatch.setattr(tool, "run_one_seed",
                            lambda out, args, s: json.loads(json.dumps(
                                FIXED[(s - 4) % len(FIXED)])))
    argv = ["--seeds", str(seeds), "--seed", "4", "--exclude_degenerate",
            "0.05"]
    js = jtool.main(argv + ["--out", str(tmp_path / "jax")])
    ts = pb.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert json.dumps(ts) == json.dumps(js)
    assert (tmp_path / "port" / "summary.json").read_bytes() == \
        (tmp_path / "jax" / "summary.json").read_bytes()
    if seeds == 1:
        assert ts["f1_gain"] == FIXED[0]["report"]["f1"] - \
            FIXED[0]["mask_only"]["f1"]
        return
    assert ts["excluded_degenerate"]["n_excluded"] == 1
    for k in range(4, 7):
        assert (tmp_path / "port" / f"seed{k}" / "result.json").read_bytes() \
            == (tmp_path / "jax" / f"seed{k}" / "result.json").read_bytes()
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "summarize_phantom.py"),
         str(tmp_path / "port"), "--exclude_degenerate", "0.05"],
        capture_output=True, text=True, check=True).stdout
    agg = json.loads(out.splitlines()[0])
    assert (agg["seeds_found"], agg["seeds_kept"]) == (3, 2)
    for k in ("lesion_dice", "f1", "sensitivity"):
        assert agg["paired_gain"][k]["mean"] == pytest.approx(
            ts["filtered"]["paired_gain"][k]["mean"])
        assert agg["raw_all_seeds"]["paired_gain"][k]["mean"] == \
            pytest.approx(ts["paired_gain"][k]["mean"])


def test_tiny_whole_run_on_the_cpu(tmp_path, monkeypatch):
    """(e) The whole study at a tiny size (SMALL_SIZE³ phantoms) on the CPU
    completes; its summary has every key of the JAX tool's and metrics in
    [0, 1]; each arm's timing is written."""
    monkeypatch.setattr(pb, "SIZE", SMALL_SIZE)
    summary = pb.main(["--device", "cpu", "--n_mask", "1", "--n_report",
                       "2", "--n_test", "2", "--steps", "2", "--crop", "16",
                       "--out", str(tmp_path)])
    jkeys = {"metric", "seeds", "mask_only", "report", "paired_gain",
             "f1_gain", "dice_gain"}
    assert jkeys <= set(summary)
    for arm in ("mask_only", "report"):
        assert set(summary[arm]) == {"lesion_dice", "lesion_nsd",
                                     "sensitivity", "specificity", "f1",
                                     "volume_threshold", "cases"}
        for k in ("lesion_dice", "lesion_nsd", "f1"):
            assert 0.0 <= summary[arm][k] <= 1.0
    timing = json.loads((tmp_path / "timing.json").read_text())
    assert timing["device"] == "cpu" and timing["wall_s"] > 0
    arms = timing["seeds"]["0"]
    assert arms["report"]["steps"] == 2 and arms["report"]["step_median_ms"] > 0
    assert json.dumps(json.loads((tmp_path / "summary.json").read_text())) \
        == json.dumps(summary)  # NaN specificity alike


def test_device_defaults_to_cuda_and_never_falls_back(tmp_path):
    """Without a card the default device raises before anything is
    written; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.main(["--out", str(tmp_path / "x"), "--steps", "1"])
    assert not (tmp_path / "x").exists()


def test_report_supervision_learns_tumor():
    """The R-Super mechanism on the port (counterpart of
    ``tests/test_e2e.py::test_report_supervision_learns_tumor``, the same
    batch, model, optimizer, 60 ``ball`` steps and assertions): NO
    per-voxel tumour labels, only a report (volume + diameter in a
    segment); after training the lesion channel lights up inside the
    reported segment and stays dark outside."""
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.models import get_model, init_params
    from rsuper_tpu_torch.train import (build_train_step, create_train_state,
                                        make_optimizer)

    torch.manual_seed(0)
    classes = ["background", "pancreas", "pancreatic_lesion"]
    lmap = LesionChannelMap.from_classes(classes)
    B, S, C = 4, 24, 3
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, S, S, S, 1)).astype(np.float32) * 0.1
    img[:, 8:14, 8:14, 8:14, 0] += 2.0
    seg = np.zeros((B, S, S, S, C), np.float32)
    seg[:, 6:18, 6:18, 6:18, 2] = 1.0  # reported segment (lesion channel)
    lab = np.zeros_like(seg)
    lab[:, 6:18, 6:18, 6:18, 1] = 1.0  # organ label
    vols = np.zeros((B, 10), np.float32)
    vols[:, 0] = 200.0
    dias = np.zeros((B, 10, 3), np.float32)
    dias[:, 0] = [7.0, 7.0, 7.0]
    batch = {k: torch.from_numpy(v) for k, v in dict(
        image=img, label=lab, unk=seg.copy(), segment_mask=seg,
        volumes=vols, diameters=dias).items()}

    model = init_params(get_model("resunet", C, {"base_chan": 4},
                                  dtype=torch.float32), seed=0)
    opt = make_optimizer(model.parameters(), base_lr=3e-3, warmup_epochs=0,
                         max_epochs=100, steps_per_epoch=10)
    state = create_train_state(model, opt)
    step = build_train_step(lmap, LossConfig(loss="ball",
                                             ball_max_diameter=16))
    for _ in range(60):
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["overall"]))

    with torch.no_grad():
        out = state.model(batch["image"])["segmentation"]
        out = out[0] if isinstance(out, (list, tuple)) else out
    probs = torch.sigmoid(out[..., 2]).numpy()
    seg_sp = seg[..., 2] > 0
    inside_hot = int(((probs > 0.5) & seg_sp).sum()) / B
    total_hot = int((probs > 0.5).sum()) / B
    assert 60 <= inside_hot <= 900, f"hot voxels in segment: {inside_hot}"
    assert total_hot <= 2000, f"hot voxels exploded: {total_hot}"
    assert (probs[:, :3, :3, :3] > 0.5).sum() == 0
    assert probs[:, 6:18, 6:18, 6:18].mean() > \
        10 * probs[:, :3, :3, :3].mean()
