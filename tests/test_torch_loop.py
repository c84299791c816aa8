"""The port's training loop and CLI (``train/loop.py``,
``train/__main__.py``, ``train/checkpoint.py``, ``config/``) on the CPU.

* Against the JAX package: ``train(max_steps=2)`` of both packages on the
  same synthetic cases (two CT-Mask and two CT-Report cases, a per-tumour
  report table), a small MedFormer (the widths of
  ``tests/test_torch_train.py``), 32³ crops, batch 2, float32, the default
  ``ball_dice_last`` losses, one loader worker, the same initial parameters
  (``params_from_flax``) and the augmentation draws replayed from the JAX
  loop's key stream (``rsuper_tpu/train/loop.py:209,253,266-281``). The
  losses of each step agree within 1e-4 relative. The runs take no warm-up
  (lr = base_lr = 6e-4 from the first step), so each step moves the
  parameters by about lr. The parameters after the steps are held as in
  ``tests/test_torch_train.py``: |Δp| ≤ 2·Σ lr + one float32 spacing of p
  element by element, mean |Δp| ≤ 0.2·lr, and tensor by tensor the port's
  update u = p − p0 within UPDATE_TOL of JAX's in norm, with a floor of
  UPDATE_FLOOR·lr·√n for tensors that barely move (n elements). The updates
  differ by 3–6 % in norm (Adam's sign-like first steps flip on elements with
  gradients near zero); a skipped or sign-flipped update is off by 100 % or
  200 %.
* Port only: a checkpoint round trip is bit-equal; a run cut after one
  epoch, or in the middle of one, and resumed equals an uninterrupted one
  bit for bit; the CLI runs
  end to end with ``--device cpu`` and resumes, without importing pandas or
  PyYAML; the options of ``ROADMAP.md`` §1 items 8 and 10 take a step,
  item 10's (spatial sharding of the 2D pathway) on two ranks of the
  CLI's spawner (the 2D pathway is held in
  ``tests/test_torch_dim2_loop.py``; validation,
  warm starts, host augmentation and the prefetcher are held in
  ``tests/test_torch_{validation,pretrained,host_augment}.py``, CLIP
  pretraining in ``tests/test_torch_clip_loop.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.config import load_config as jload_config
from rsuper_tpu.data import augment as jaug
from rsuper_tpu.data import dataset as jds
from rsuper_tpu.data import reports as jrep
from rsuper_tpu.models import get_model as jget_model
from rsuper_tpu.train import loop as jloop
from rsuper_tpu_torch.config import DEFAULT_CONFIGS, load_config
from rsuper_tpu_torch.data import dataset as ds
from rsuper_tpu_torch.data import pipeline as pipe
from rsuper_tpu_torch.data import reports as rep
from rsuper_tpu_torch.models import get_model, init_params, load_flax_params
from rsuper_tpu_torch.train import __main__ as cli
from rsuper_tpu_torch.train import loop
from rsuper_tpu_torch.train.checkpoint import CheckpointManager
from rsuper_tpu_torch.train.optim import make_optimizer
from rsuper_tpu_torch.train.state import create_train_state

ROOT = Path(__file__).resolve().parent.parent
PRESET = "abdomenatlas_ufo/medformer_3d"
TINY = dict(
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
CLASSES = ["background", "kidney_left", "kidney_right", "liver", "pancreas",
           "pancreas_body", "pancreas_head", "pancreas_tail",
           "pancreatic_lesion"]
REPORT_CLASSES = ["background", "kidney_left", "kidney_right", "liver",
                  "pancreas_body", "pancreas_head", "pancreas_tail"]
REPORT_CSV = (
    "BDMAP_ID,Standardized Organ,Standardized Location,Tumor Size (mm),"
    "Unknow Tumor Size,no lesion\n"
    "BDMAP_R0,pancreas,head,12.0,no,0\n"
    "BDMAP_R1,pancreas,head / body,20 x 14,no,0\n")
LOSS_TOL = 1e-4
UPDATE_TOL, UPDATE_FLOOR = 0.1, 0.01  # the update bound of the docstring
OVERRIDES = dict(model_args=TINY, training_size=(32, 32, 32),
                 compute_dtype="float32", batch_size=2, num_workers=1,
                 iter_per_epoch=2, epochs=2, warmup_epochs=0,
                 classes=tuple(CLASSES),
                 report_classes=tuple(REPORT_CLASSES),
                 tumor_classes=("pancreas",))


def _write_cases(root: Path):
    """Two CT-Mask and two CT-Report cases at 64³ (as
    ``tests/test_data.py`` builds them), the class lists and the report
    CSV."""
    for sub, names in (("masks", CLASSES), ("reports", REPORT_CLASSES)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / "classes.json").write_text(json.dumps(names))
    for k in range(2):
        rng = np.random.default_rng(5 + k)
        img = rng.normal(size=(64, 64, 64)).astype(np.float32)
        lab = np.zeros((len(CLASSES), 64, 64, 64), bool)
        lab[CLASSES.index("pancreas"), 20:40, 20:40, 20 + k:40] = True
        lab[CLASSES.index("pancreatic_lesion"), 28:34, 28:34, 28:34] = True
        np.savez_compressed(root / "masks" / f"BDMAP_M{k}.npz", image=img,
                            labels=np.packbits(lab, axis=0),
                            num_classes=len(CLASSES))
        img = rng.normal(size=(64, 64, 64)).astype(np.float32)
        lab = np.zeros((len(REPORT_CLASSES), 64, 64, 64), bool)
        lab[REPORT_CLASSES.index("pancreas_head"), 16:32, 16:32, 16:32] = True
        lab[REPORT_CLASSES.index("pancreas_body"), 32:44, 16:32, 16:32] = True
        lab[REPORT_CLASSES.index("liver"), 40:60, 40:60, 40:60] = True
        np.savez_compressed(root / "reports" / f"BDMAP_R{k}.npz", image=img,
                            labels=np.packbits(lab, axis=0),
                            num_classes=len(REPORT_CLASSES))
    (root / "reports.csv").write_text(REPORT_CSV)
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_cases(tmp_path_factory.mktemp("cases"))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The loop runs its loader thread beside PyTorch's pool of spinning
    intra-op threads; with several test processes on the machine that pool
    slows these tests tens of times, so they take one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cases(root, module):
    mask = [(f"BDMAP_M{k}", str(root / "masks" / f"BDMAP_M{k}.npz"))
            for k in range(2)]
    report = [(f"BDMAP_R{k}", str(root / "reports" / f"BDMAP_R{k}.npz"))
              for k in range(2)]
    return module.build_case_list(mask, report, seed=0)


def _port_dataset(root, cfg):
    rows, _, _ = rep.clean_reports(rep.load_reports(str(root / "reports.csv")),
                                   list(cfg.tumor_classes))
    return ds.RSuperDataset(_cases(root, ds), ds.RSuperDataConfig(
        classes=cfg.classes, report_classes=cfg.report_classes,
        crop_size=cfg.training_size, tumor_classes=cfg.tumor_classes),
        report_rows=rows)


def _port_model(flat=None, seed=0):
    model = get_model("medformer", len(CLASSES), dict(TINY),
                      dtype=torch.float32)
    return load_flax_params(model, flat) if flat is not None else \
        init_params(model, seed=seed)


def _jax_draws(cfg):
    """The port's `draws` callable replaying the JAX loop's key stream:
    aug_key = PRNGKey(seed + 1); an epoch key a split of it; a batch key a
    split of that; one key an item; per item the affine, coin and intensity
    keys of ``_augment_items``."""

    def draws(epoch, index, B):
        key = jax.random.PRNGKey(cfg.seed + 1)
        for _ in range(epoch + 1):
            key, ekey = jax.random.split(key)
        for _ in range(index + 1):
            ekey, k = jax.random.split(ekey)
        out = {n: [] for n in ("theta", "affine_coin", "coins", "multiply",
                               "additive", "gamma", "contrast", "sigma",
                               "noise_std", "noise")}
        for item in jax.random.split(k, B):
            k_aff, k_coin, k_int = jax.random.split(item, 3)
            out["theta"].append(np.asarray(jaug._affine_theta(
                k_aff, cfg.scale, cfg.rotate, cfg.translate, (0.0,) * 3)))
            out["affine_coin"].append(np.float32(jax.random.uniform(k_coin)))
            ks = jax.random.split(k_int, 12)
            u = lambda i, lo, hi: np.float32(jax.random.uniform(  # noqa
                ks[i], (), minval=lo, maxval=hi))
            out["coins"].append(np.asarray(jax.random.uniform(ks[0], (6,))))
            out["multiply"].append(u(1, 0.7, 1.3))
            out["additive"].append(np.float32(
                jax.random.normal(ks[2], (), jnp.float32)))
            out["gamma"].append(u(3, 0.7, 1.5))
            out["contrast"].append(u(4, 0.7, 1.3))
            out["sigma"].append(u(5, 0.5, 1.5))
            out["noise_std"].append(u(6, 0.0, 0.2))
            out["noise"].append(torch.from_numpy(np.array(jax.random.normal(
                ks[7], tuple(cfg.training_size), jnp.float32))))
        noise = torch.stack(out.pop("noise"))
        return pipe.AugmentDraws(noise=noise,
                                 **{n: np.stack(v) for n, v in out.items()})

    return draws


def _record_losses(monkeypatch, module):
    """Wrap `module.build_train_step` so each step's losses are kept."""
    seen = []
    build = module.build_train_step

    def wrapped(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, batch):
            state, losses = step(state, batch)
            seen.append({k: float(v) for k, v in losses.items()})
            return state, losses

        return recorded

    monkeypatch.setattr(module, "build_train_step", wrapped)
    return seen


def _flat(tree):
    from flax.traverse_util import flatten_dict

    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def test_two_steps_match_jax_train(data, tmp_path, monkeypatch):
    jcfg = jload_config(PRESET, overrides=dict(OVERRIDES, cp_path=str(
        tmp_path / "jax")))
    cfg = load_config(PRESET, overrides=dict(OVERRIDES, cp_path=str(
        tmp_path / "port")))
    jmodel = jget_model("medformer", len(CLASSES), dict(TINY),
                        dtype=jnp.float32)
    init = jloop.init_params_on_host(
        jmodel, jax.random.PRNGKey(jcfg.seed),
        jnp.zeros((1, *jcfg.training_size, 1), jnp.float32))
    flat0 = _flat(init["params"])

    jrows, _, _ = jrep.clean_reports(jrep.load_reports(
        str(data / "reports.csv")), list(jcfg.tumor_classes))
    jdataset = jds.RSuperDataset(_cases(data, jds), jds.RSuperDataConfig(
        classes=jcfg.classes, report_classes=jcfg.report_classes,
        crop_size=jcfg.training_size, tumor_classes=jcfg.tumor_classes),
        report_rows=jrows)
    jlosses = _record_losses(monkeypatch, jloop)
    jstate = jloop.train(jcfg, jmodel, jdataset, max_steps=2)

    losses = _record_losses(monkeypatch, loop)
    state = loop.train(cfg, _port_model(flat0), _port_dataset(data, cfg),
                       max_steps=2, device="cpu", draws=_jax_draws(cfg))
    assert state.step == int(jstate.step) == 2
    assert len(losses) == len(jlosses) == 2
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert sorted(got) == sorted(want)
        assert "ball_loss_bce" in got  # the Ball Loss ran
        for k, v in want.items():
            assert abs(got[k] - v) <= LOSS_TOL * abs(v), (i, k, got[k], v)

    lr, params = _check_params(state, jstate, flat0, cfg, steps=2)
    moved = [np.abs(want - p0).ravel() for _, want, p0 in params.values()]
    assert np.concatenate(moved).mean() > 0.5 * lr[0]


def _check_params(state, jstate, flat0, cfg, steps):
    """The port's parameters after `steps` updates from `flat0` against the
    JAX loop's, at the bounds of the module docstring; returns
    (lr of each step, {name: (port, JAX, start)} as numpy)."""
    from rsuper_tpu_torch.models import params_from_flax

    lr = [state.optimizer.schedule(s) for s in range(steps)]
    assert min(lr) > 0.99 * cfg.base_lr  # no warm-up: each step moves p
    start = params_from_flax(flat0, state.model)
    final = params_from_flax(_flat(jstate.params["params"]), state.model)
    diffs, out = [], {}
    for k, p in state.model.named_parameters():
        got, want, p0 = p.detach().numpy(), final[k].numpy(), start[k].numpy()
        bound = 2 * sum(lr) + np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= bound).all(), k
        upd, jupd = got - p0, want - p0
        err, ref = np.linalg.norm(upd - jupd), np.linalg.norm(jupd)
        floor = UPDATE_FLOOR * lr[0] * np.sqrt(upd.size)
        assert err <= UPDATE_TOL * ref + floor, (k, err, ref)
        diffs.append(np.abs(got - want).ravel())
        out[k] = (got, want, p0)
    assert np.concatenate(diffs).mean() <= 0.2 * lr[0]
    return lr, out


def _state(seed=0):
    model = _port_model(seed=seed)
    return create_train_state(model, make_optimizer(model.parameters()))


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.opt.state_dict(), b.optimizer.opt.state_dict()
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert all(torch.equal(a.ema_params[k], b.ema_params[k])
               for k in a.ema_params)
    assert a.step == b.step


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    a = _state(0)
    for p in a.model.parameters():  # a state with moments and a moved EMA
        p.grad = torch.randn_like(p)
    a.apply_gradients()
    a.apply_gradients()
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_every=2)
    assert not ckpt.has("latest")
    ckpt.save_epoch(a, 1, metric=0.5)
    ckpt.wait()
    assert sorted(os.listdir(tmp_path / "ck")) == ["best", "epoch_2",
                                                   "latest"]
    b = ckpt.restore(_state(1), "latest")
    _same_state(a, b)
    ckpt.save_epoch(a, 2, metric=0.4)  # not better: best stays
    assert not os.path.exists(tmp_path / "ck" / "epoch_3")
    assert ckpt.best_metric == 0.5


def _train_port(data, cp, **kw):
    cfg = load_config(PRESET, overrides=dict(OVERRIDES, cp_path=str(cp),
                                             **kw.pop("cfg", {})))
    return loop.train(cfg, _port_model(seed=3), _port_dataset(data, cfg),
                      device="cpu", **kw)


def test_resumed_run_equals_uninterrupted(data, tmp_path):
    one = {"iter_per_epoch": 1}
    whole = _train_port(data, tmp_path / "a", cfg=one)
    assert whole.step == 2
    cut = _train_port(data, tmp_path / "b", max_steps=1, cfg=one)
    assert cut.step == 1
    resumed = _train_port(data, tmp_path / "b", max_steps=1,
                          cfg={"resume": True, **one})
    assert resumed.step == 2
    _same_state(whole, resumed)
    log = (tmp_path / "b" / "test" / "train.log").read_text()
    assert "resumed from step 1" in log


def test_resumed_in_the_middle_of_an_epoch_equals_uninterrupted(data,
                                                                 tmp_path):
    """Cut after step 1 of a 2-step epoch: the resumed run trains step 2 of
    that epoch on the records and draws of an uninterrupted run."""
    short = {"iter_per_epoch": 2, "epochs": 1}
    whole = _train_port(data, tmp_path / "a", cfg=short)
    assert whole.step == 2
    cut = _train_port(data, tmp_path / "b", max_steps=1, cfg=short)
    assert cut.step == 1
    resumed = _train_port(data, tmp_path / "b", cfg={"resume": True, **short})
    assert resumed.step == 2
    _same_state(whole, resumed)


def _cli_args(data, cp, *extra):
    return ["--data_root", str(data / "masks"), "--report_root",
            str(data / "reports"), "--reports", str(data / "reports.csv"),
            "--cp_path", str(cp), "--num_workers", "1", "--iter_per_epoch",
            "2", "--epochs", "3", "--all_train", "--device", "cpu", *extra]


def test_cli_trains_and_resumes_on_cpu_without_pandas_or_yaml(data, tmp_path):
    """``main`` end to end in a fresh interpreter, the preset's model cut to
    the small widths: 2 steps, then 1 more on --resume."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from rsuper_tpu_torch.config import config
from rsuper_tpu_torch.train.__main__ import main
p = config.DEFAULT_CONFIGS[{PRESET!r}]
p.update(model_args={TINY!r}, training_size=(32, 32, 32),
         compute_dtype="float32")
args = {_cli_args(data, tmp_path)!r}
first = main(args + ["--max_steps", "2", "--profile_steps", "1"])
second = main(args + ["--max_steps", "1", "--resume"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("pandas", "yaml", "jax", "rsuper_tpu"))
print(json.dumps([first.step, second.step, bad]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # as _one_intra_op_thread
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    steps_a, steps_b, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert (steps_a, steps_b, bad) == (2, 3, [])
    exp = tmp_path / "test"
    assert (exp / "latest").exists() and (exp / "config.txt").exists()
    assert any((exp / "tb").iterdir())
    trace = json.loads((exp / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    train_recs = [r for r in recs if "train/overall" in r]
    assert [r["step"] for r in train_recs] == [1, 3]
    assert all(np.isfinite(r["train/overall"]) for r in train_recs)
    phases = [r for r in recs if "phase/step_ms" in r]
    assert phases[-1]["phase/step_count"] == 1
    saved = torch.load(exp / "latest", weights_only=True)
    assert saved["step"] == 3
    assert all(float(s["step"]) == 3 for s in
               saved["opt_state"]["state"].values())


def test_cli_reads_a_yaml_config(data, tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({
        "model_args": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in TINY.items()},
        "training_size": [32, 32, 32], "compute_dtype": "float32"}))
    state = cli.main(_cli_args(data, tmp_path, "--config", str(path),
                               "--max_steps", "1", "--mask_only"))
    assert state.step == 1
    assert "training_size: (32, 32, 32)" in (
        tmp_path / "test" / "config.txt").read_text()


def test_load_config_without_pyyaml_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        load_config(PRESET, str(tmp_path / "x.yaml"))
    cfg = load_config(PRESET, overrides={"batch_size": 4, "rotate": [1, 2, 3]})
    assert cfg.batch_size == 4 and cfg.rotate == (1, 2, 3)
    assert cfg.loss_config().loss == "ball_dice_last"
    with pytest.raises(ValueError):
        load_config("nope")
    with pytest.raises(ValueError):
        load_config(PRESET, overrides={"not_a_field": 1})


def test_presets_and_class_lists_match_the_jax_package():
    from rsuper_tpu.config import DEFAULT_CONFIGS as JCONFIGS
    from rsuper_tpu.config import label_names as jnames
    from rsuper_tpu_torch.config import label_names as names

    for n in ("MASK_DATASET_PANCREAS_CLASSES", "REPORT_DATASET_CLASSES",
              "JOINT_CLASSES"):
        assert getattr(names, n) == getattr(jnames, n)
    assert DEFAULT_CONFIGS == JCONFIGS
    for name in DEFAULT_CONFIGS:
        a = dataclasses.asdict(load_config(name))
        b = dataclasses.asdict(jload_config(name))
        assert a == b


# the 2D pathway with spatial sharding (ROADMAP.md §1 item 10): the flag
# sets and the config field, each completed into a two-rank job of the
# CLI's local spawner on the CPU (a 1 × 2 grid)
ITEM_10 = {
    "arch_unet_2d": ["--arch", "unet_2d", "--dimension", "2d",
                     "--spatial_shard", "2"],
    "preset_resunet_2d": ["--preset", "slices/resunet_2d", "--spatial_shard",
                          "2"],
    "config_spatial_shard": [],  # the config file sets the field
}


@pytest.fixture(scope="module")
def item_10_runs(data, tmp_path_factory):
    """One step of each ITEM_10 case at 64² slices (base 4, two loader
    workers, whose records key on the record), the cases run at once."""
    yaml = pytest.importorskip("yaml")
    tmp = tmp_path_factory.mktemp("item_10")
    procs = []
    for name, flags in ITEM_10.items():
        cfg = {"model_args": {"base_chan": 4}, "training_size": [64, 64],
               "compute_dtype": "float32"}
        if not flags:
            cfg.update(arch="unet_2d", spatial_shard=2)
        path = tmp / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        argv = _cli_args(data, tmp / name, "--config", str(path),
                         "--max_steps", "1", "--mask_only", "--unique_name",
                         name, "--num_workers", "2", "--dist_num_processes",
                         "2", *flags)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rsuper_tpu_torch.train", *argv],
            env={**os.environ, "OMP_NUM_THREADS": "1"}, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return tmp


def _check_item_10_run(root: Path, name: str):
    """Both ranks logged the step's losses, finite and the same bits; the
    run's config has the field; rank 0 saved the step."""
    exp = root / name / name
    recs = [[json.loads(line) for line in
             (exp / f"metrics.rank{r}.jsonl").read_text().splitlines()
             if "train/overall" in line] for r in range(2)]
    for r in recs:
        for rec in r:
            del rec["time"]
    assert recs[0] and recs[0] == recs[1]
    assert np.isfinite([r["train/overall"] for r in recs[0]]).all()
    config = (exp / "config.txt").read_text()
    assert "spatial_shard: 2\n" in config and "_2d\n" in config
    assert torch.load(exp / "latest", weights_only=True)["step"] == 1


@pytest.mark.parametrize("name", ["arch_unet_2d", "preset_resunet_2d"])
def test_item_10_cli_options_run(item_10_runs, name):
    """The flag sets that raised ``NotImplementedError`` before the 2D
    pathway sharded its rows take a step on two ranks."""
    _check_item_10_run(item_10_runs, name)


@pytest.mark.parametrize("name", ["config_spatial_shard"])
def test_item_10_config_field_runs(item_10_runs, name):
    """The field on the 2D pathway (``spatial_shard: 2`` with ``unet_2d``
    at 64²) takes a step on two ranks."""
    _check_item_10_run(item_10_runs, name)


@pytest.mark.parametrize("flags", [
    ["--zero_opt"],
    ["--zero_ema"],
    ["--dist_coordinator"],
    ["--dist_num_processes", "1"],
    ["--dist_process_id", "0"],
    ["--local_device_ids", "0"],
    ["--preset", "slices/resunet_2d", "--zero_opt"],
], ids=lambda f: "_".join(a.strip("-") for a in f))
def test_item_8_cli_options_run(data, tmp_path, flags, monkeypatch):
    """The options of ROADMAP.md §1 item 8 but spatial sharding train: each
    flag set (these cases raised ``NotImplementedError`` before the port
    had them) is completed into a one-rank gloo job of the CLI on the CPU
    and takes a step; ``--zero_opt`` builds the ZeRO-1 optimizer and
    ``--zero_ema`` a split EMA copy, gathered whole when the run ends."""
    import socket

    from rsuper_tpu_torch.parallel import current
    from rsuper_tpu_torch.train.optim import ZeroOptimizer

    yaml = pytest.importorskip("yaml")
    two_d = "slices/resunet_2d" in flags
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(
        {"model_args": {"base_chan": 8}, "training_size": [64, 64]} if two_d
        else {"model_args": {k: list(v) if isinstance(v, tuple) else v
                             for k, v in TINY.items()},
              "training_size": [32, 32, 32], "compute_dtype": "float32"}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    job = {"--dist_coordinator": f"127.0.0.1:{port}",
           "--dist_num_processes": "1", "--dist_process_id": "0"}
    argv = [a for a in flags if a != "--dist_coordinator"]
    for flag, value in job.items():
        if flag not in argv:
            argv += [flag, value]
    split = []
    build = loop.create_train_state

    def recorded(*args, **kwargs):
        state = build(*args, **kwargs)
        split.append(state.ema_axes)
        return state

    monkeypatch.setattr(loop, "create_train_state", recorded)
    state = cli.main(_cli_args(data, tmp_path, "--config", str(path),
                               "--max_steps", "1", "--mask_only", *argv))
    assert current() is None  # the job ended with the run
    assert state.step == 1
    assert isinstance(state.optimizer, ZeroOptimizer) == ("--zero_opt" in
                                                          flags)
    assert (split[0] is not None) == ("--zero_ema" in flags)
    assert state.ema_axes is None and state.ema_params is not None
    recs = [json.loads(line) for line in
            (tmp_path / "test" / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([r["train/overall"] for r in recs
                        if "train/overall" in r]).all()


def test_an_empty_case_list_raises(tmp_path):
    (tmp_path / "classes.json").write_text(json.dumps(CLASSES))
    with pytest.raises(ValueError, match="no training cases"):
        cli.main(["--data_root", str(tmp_path), "--device", "cpu",
                  "--cp_path", str(tmp_path)])
