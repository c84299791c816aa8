"""The port's validation (``train/validation.py``), cross-validation files
(``train/crossval.py``), the loop's validation and the CLI's ``--k_fold``,
on the CPU.

* Against the JAX package: ``validate_cases`` and ``run_validation`` (EMA
  weights) on two small cases at a small MedFormer (the widths of
  ``tests/test_torch_predict.py``, 32³ windows, 4 classes, the same
  parameters carried across by ``params_from_flax``; the JAX package's
  validation at the EMA parameters for ``run_validation``). The blended
  float32
  probabilities agree within PROB_TOL = 1e-3 (the float32 logits agree to
  about 1e-4·(1 + max|logit|), and the sigmoid's slope is at most 1/4). Both
  packages threshold float16 probabilities; for every class whose
  thresholded masks are equal in every case, Dice, ASD and HD95 are equal
  (bit for bit), and the per-class case counts are always equal. The
  cross-validation files are byte-equal for the same results.
* Port only: validation leaves the training model's parameters as they
  were; a run that validates every epoch logs ``val/dice_mean`` each time
  and keeps ``best``; the CLI trains both folds of ``--k_fold 2`` and
  writes each fold's results and the summary.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.inference import sliding_window as jsw
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.train import crossval as jcv
from rsuper_tpu.train import validation as jval
from rsuper_tpu_torch.config import config, load_config
from rsuper_tpu_torch.data.preprocess import load_case
from rsuper_tpu_torch.inference import sliding_window as tsw
from rsuper_tpu_torch.models import get_model, load_flax_params
from rsuper_tpu_torch.models.params import params_from_flax
from rsuper_tpu_torch.train import __main__ as cli
from rsuper_tpu_torch.train import crossval, validation
from rsuper_tpu_torch.train.optim import make_optimizer
from rsuper_tpu_torch.train.state import create_train_state
from test_torch_loop import (PRESET, TINY, _cli_args, _one_intra_op_thread,  # noqa: F401
                             _train_port, _write_cases)
from test_torch_predict import _flax_params

C = 4
WINDOW = (32, 32, 32)
SHAPE = (40, 36, 32)  # 2 × 2 × 1 windows: one batch of 4
PROB_TOL = 1e-3


class Pair:
    """One small MedFormer in both packages (raw and EMA parameters) and two
    cases with labels: class 0 in both, class 1 in case 0 only, class 2 in
    case 1 only, class 3 in neither."""

    def __init__(self):
        from flax.traverse_util import unflatten_dict

        self.jm = JaxMedFormer(C, dtype=jnp.float32, **TINY)
        self.flat = _flax_params(self.jm, np.zeros((1, *WINDOW, 1),
                                                   np.float32))
        # confident heads: mostly-on, mostly-off and mixed classes
        self.flat["outc/bias"] = np.array([1.5, -1.5, 0.5, -3.0], np.float32)
        rng = np.random.default_rng(1)  # an EMA copy a little way off
        self.flat_ema = {k: (v + 0.3 * np.abs(v).mean()
                             * rng.normal(size=v.shape)).astype(np.float32)
                         for k, v in self.flat.items()}

        def tree(flat):
            return {"params": unflatten_dict(
                {tuple(k.split("/")): jnp.asarray(v)
                 for k, v in flat.items()})}

        self.jparams, self.jema = tree(self.flat), tree(self.flat_ema)
        self.apply_fn = lambda p, x: self.jm.apply(p, x)["segmentation"][0]
        model = get_model("medformer", C, dict(TINY), dtype=torch.float32)
        self.model = load_flax_params(model, self.flat).eval()
        rng = np.random.default_rng(7)
        self.cases = []
        for k in range(2):
            image = rng.normal(size=SHAPE).astype(np.float32)
            labels = np.zeros((C,) + SHAPE, np.uint8)
            labels[0, 4:30, 6:30, 2:28] = 1
            labels[1 + k] = rng.random(SHAPE) < 0.2
            self.cases.append((image, labels))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _recorded(monkeypatch, module):
    """Keep every blended float32 probability volume `module`'s
    ``sliding_window_probs_device`` returns to the validation above it."""
    seen = []
    inner = module.sliding_window_probs_device

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(np.array(out))
        return out

    monkeypatch.setattr(module, "sliding_window_probs_device", recording)
    return seen


def _masks(probs):
    """The masks ``validate_cases`` thresholds: float16 probabilities (the
    rounding of both packages' ``out_dtype=float16``) > 0.5."""
    return [p.astype(np.float16) > 0.5 for p in probs]


def _assert_agree(pair, got, want, masks, jmasks):
    """Counts equal; every metric equal for the classes whose masks agree
    in every case holding the class. Returns those classes."""
    assert np.array_equal(got["cases_per_class"], want["cases_per_class"])
    assert list(want["cases_per_class"]) == [2, 1, 1, 0]
    same = [c for c in range(C) if all(
        np.array_equal(m[..., c], j[..., c])
        for m, j, (_, lab) in zip(masks, jmasks, pair.cases) if lab[c].any())]
    for c in same:
        for k in ("dice", "asd", "hd95"):
            assert got[k][c] == want[k][c], (k, c, got[k][c], want[k][c])
    return same


def test_validate_cases_matches_jax(pair, monkeypatch):
    ref_p, got_p = _recorded(monkeypatch, jsw), _recorded(monkeypatch, tsw)
    want = jval.validate_cases(pair.apply_fn, pair.jparams, pair.cases, C,
                               window=WINDOW)
    timer = validation.PhaseTimer()
    got = validation.validate_cases(validation.head_fn(pair.model),
                                    pair.cases, C, window=WINDOW,
                                    device="cpu", timer=timer)
    assert len(got_p) == len(ref_p) == 2
    for g, r in zip(got_p, ref_p):
        assert g.shape == r.shape == (*SHAPE, C)
        assert float(np.abs(g - r).max()) <= PROB_TOL
    assert sorted(got) == sorted(want)
    same = _assert_agree(pair, got, want, _masks(got_p), _masks(ref_p))
    assert 0 in same and 3 in same  # the check bites on a present class
    assert timer.summary()["val_window_count"] == 2
    assert timer.summary()["val_metrics_count"] == 2


def test_run_validation_takes_the_ema_weights(pair, monkeypatch):
    """The port's ``run_validation`` with ``ema`` against the JAX package's
    validation at the EMA weights; the training model is left as it was,
    and the kept instance evaluates the parameters without ``ema``."""
    cfg = load_config(PRESET, overrides={"training_size": WINDOW,
                                         "ema": True})
    ref_p, got_p = _recorded(monkeypatch, jsw), _recorded(monkeypatch, tsw)
    want = jval.validate_cases(pair.apply_fn, pair.jema, pair.cases, C,
                               window=WINDOW)
    model = get_model("medformer", C, dict(TINY), dtype=torch.float32)
    load_flax_params(model, pair.flat)
    state = create_train_state(model, make_optimizer(model.parameters()))
    state.ema_params = params_from_flax(pair.flat_ema, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    val_model = validation.validation_model(model)
    got = validation.run_validation(val_model, state, cfg, pair.cases, C,
                                    device="cpu")
    for g, r in zip(got_p, ref_p):
        assert float(np.abs(g - r).max()) <= PROB_TOL
    assert _assert_agree(pair, got, want, _masks(got_p), _masks(ref_p))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.requires_grad for p in model.parameters())
    raw = validation.run_validation(
        val_model, state, load_config(PRESET, overrides={
            "training_size": WINDOW, "ema": False}), pair.cases[:1], C,
        device="cpu")
    assert not np.array_equal(got_p[-1], got_p[0])  # not the EMA copy
    direct = validation.validate_cases(validation.head_fn(pair.model),
                                       pair.cases[:1], C, window=WINDOW,
                                       device="cpu")
    for k in raw:
        assert np.array_equal(raw[k], direct[k]), k


def test_validate_cases_2d_raises_naming_its_item():
    """(Once a test that the 2D validation raised: it is ported, and
    ``tests/test_torch_dim2_loop.py`` holds it against JAX.) A 2D config's
    ``run_validation`` evaluates the parameters (no EMA here) with
    ``validate_cases_2d`` at the training slices' windows: the result of
    the direct call, a Dice for each class a case contains."""
    from rsuper_tpu_torch.models import get_model, init_params
    from rsuper_tpu_torch.train.optim import make_optimizer
    from rsuper_tpu_torch.train.state import create_train_state

    model = init_params(get_model("resunet_2d", 3, {"base_chan": 4},
                                  dtype=torch.float32), seed=2)
    rng = np.random.default_rng(2)
    labels = np.zeros((3, 3, 40, 36), np.uint8)
    labels[1, :, 8:20, 10:30] = 1
    cases = [(rng.normal(size=(3, 40, 36)).astype(np.float32), labels)]
    cfg = load_config("slices/resunet_2d", overrides={
        "training_size": (32, 32), "ema": False})
    state = create_train_state(model, make_optimizer(model.parameters()),
                               ema=False)
    got = validation.run_validation(validation.validation_model(model),
                                    state, cfg, cases, 3, device="cpu")
    direct = validation.validate_cases_2d(validation.head_fn(model), cases,
                                          3, window=(32, 32), device="cpu")
    assert sorted(got) == ["cases_per_class", "dice"]
    for k in got:
        np.testing.assert_array_equal(got[k], direct[k])
    np.testing.assert_array_equal(got["cases_per_class"], [0, 1, 0])


def test_cross_validation_files_are_byte_equal(tmp_path):
    classes = ["liver", "pancreas", "pancreatic_lesion"]
    rng = np.random.default_rng(0)
    k = 3
    for fold in range(k):
        results = {m: rng.random(len(classes)) * s for m, s in
                   (("dice", 1.0), ("asd", 20.0), ("hd95", 60.0))}
        results["cases_per_class"] = np.ones(len(classes))
        assert crossval.fold_dir_name("cv", fold) == jcv.fold_dir_name(
            "cv", fold)
        for root, mod in ((tmp_path / "port", crossval),
                          (tmp_path / "jax", jcv)):
            d = root / mod.fold_dir_name("cv", fold)
            d.mkdir(parents=True)
            mod.write_fold_results(str(d), fold, k, classes, results)
        name = f"{crossval.fold_dir_name('cv', fold)}/fold_results.json"
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
        got = crossval.summarize_cross_validation(str(tmp_path / "port"),
                                                  "cv", k, classes)
        want = jcv.summarize_cross_validation(str(tmp_path / "jax"), "cv", k,
                                              classes)
        assert (got is None) == (want is None) == (fold < k - 1)
    assert ((tmp_path / "port" / "cv_cross_validation.txt").read_bytes()
            == (tmp_path / "jax" / "cv_cross_validation.txt").read_bytes())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_cases(tmp_path_factory.mktemp("cases"))


def test_loop_validates_every_val_freq_epoch_and_keeps_best(data, tmp_path):
    """val_freq = 1 over 2 epochs of 1 step: two validations logged, their
    phases timed, and `best` kept at the better one."""
    cases = [load_case(str(data / "masks" / "BDMAP_M0.npz"), num_classes=9)]
    state = _train_port(data, tmp_path, test_cases=cases,
                        cfg={"iter_per_epoch": 1, "val_freq": 1})
    assert state.step == 2
    exp = tmp_path / "test"
    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    vals = [r["val/dice_mean"] for r in recs if "val/dice_mean" in r]
    assert len(vals) == 2 and all(math.isfinite(v) for v in vals)
    phases = [r for r in recs if "phase/val_window_ms" in r][-1]
    assert phases["phase/val_window_count"] == 2
    best = torch.load(exp / "best", weights_only=True)
    assert best["step"] == 1 + int(vals[1] > vals[0])


def test_cli_k_fold_trains_validates_and_summarises(data, tmp_path,
                                                   monkeypatch):
    monkeypatch.setitem(config.DEFAULT_CONFIGS, PRESET, dict(
        config.DEFAULT_CONFIGS[PRESET], model_args=TINY,
        training_size=(32, 32, 32), compute_dtype="float32"))
    args = [a for a in _cli_args(data, tmp_path) if a != "--all_train"]
    summary = tmp_path / "test_cross_validation.txt"
    for fold in range(2):
        state = cli.main(args + ["--k_fold", "2", "--fold", str(fold),
                                 "--max_steps", "1"])
        assert state.step == 1
        exp = tmp_path / f"test_fold{fold}"
        assert (exp / "latest").exists()
        res = json.loads((exp / "fold_results.json").read_text())
        assert (res["fold"], res["k_fold"]) == (fold, 2)
        assert res["classes"] == json.loads(
            (data / "masks" / "classes.json").read_text())
        for m in ("dice", "asd", "hd95"):
            assert len(res[m]) == 9 and all(math.isfinite(v) for v in res[m])
        assert summary.exists() == (fold == 1)
    text = summary.read_text().splitlines()
    assert text[0] == "2-fold cross validation — test"
    assert text[-1].startswith("mean")
