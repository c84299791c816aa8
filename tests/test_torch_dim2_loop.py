"""The port's 2D pathway data, inference, validation, training loop and
CLI against the JAX package, on the CPU.

* ``SliceDataset`` records are bit-equal to the JAX package's from the
  same ``np.random.Generator`` (the foreground-biased slice pick, the crop
  with its padding, the flips and the intensity draws), also for a crop
  larger than the slice.
* ``sliding_window_inference_2d`` and ``validate_cases_2d`` against the
  JAX functions on the same small UNet2D (its parameters carried over
  with ``params_from_flax``): probabilities within PROB_TOL (float32 models
  on both sides, sums in another order), the thresholded predictions and
  so the Dice values equal.
* ``train(max_steps=2)`` of the ``slices/resunet_2d`` preset in both
  packages (UNet2D at base 4, 32² slices, batch 2, float32, ``dice``, EMA,
  one loader worker, the same initial parameters): the losses of each
  step within 1e-4 relative and the parameters after them at the bounds
  of ``tests/test_torch_loop.py``.
* The CLI trains the preset, validates, resumes, and refuses CT-Report
  cases with the JAX CLI's message.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.config import load_config as jload_config
from rsuper_tpu.data import dataset as jds
from rsuper_tpu.data import dataset2d as jds2
from rsuper_tpu.inference.sliding_window2d import \
    sliding_window_inference_2d as jsw2d
from rsuper_tpu.models import get_model as jget_model
from rsuper_tpu.train import loop as jloop
from rsuper_tpu.train import validation as jval
from rsuper_tpu_torch.config import config as pconfig
from rsuper_tpu_torch.config import load_config
from rsuper_tpu_torch.data import dataset as ds
from rsuper_tpu_torch.data import dataset2d as ds2
from rsuper_tpu_torch.inference import sliding_window_inference_2d
from rsuper_tpu_torch.models import get_model, load_flax_params
from rsuper_tpu_torch.train import __main__ as cli
from rsuper_tpu_torch.train import loop, validation
from test_torch_loop import (_check_params, _flat, _one_intra_op_thread,  # noqa: F401
                             _record_losses, _write_cases)
from test_torch_medformer import flax_params

PRESET = "slices/resunet_2d"
CLASSES = ["background", "kidney_left", "kidney_right", "liver", "pancreas",
           "pancreas_body", "pancreas_head", "pancreas_tail",
           "pancreatic_lesion"]
SMALL = dict(model_args={"base_chan": 4}, training_size=(32, 32),
             compute_dtype="float32", batch_size=2, num_workers=1,
             iter_per_epoch=2, epochs=2, warmup_epochs=0,
             classes=tuple(CLASSES))
LOSS_TOL = 1e-4
PROB_TOL = 1e-4  # a quarter of the logits' 1e-3·(1 + max|ref|) at |ref| < 1


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_cases(tmp_path_factory.mktemp("cases2d"))


def _mask_cases(root, module):
    return [module.Case(f"BDMAP_M{k}", str(root / "masks" / f"BDMAP_M{k}.npz"),
                        False) for k in range(2)]


@pytest.mark.parametrize("crop,fg_bias,augment", [
    ((32, 32), 0.9, True), ((72, 48), 0.9, True), ((40, 40), 0.0, True),
    ((32, 32), 1.0, False)])
def test_slice_dataset_records_are_bit_equal(data, crop, fg_bias, augment):
    jset = jds2.SliceDataset(_mask_cases(data, jds), jds2.SliceDataConfig(
        classes=tuple(CLASSES), crop_size=crop, fg_bias=fg_bias,
        augment=augment))
    pset = ds2.SliceDataset(_mask_cases(data, ds), ds2.SliceDataConfig(
        classes=tuple(CLASSES), crop_size=crop, fg_bias=fg_bias,
        augment=augment))
    assert len(pset) == len(jset) == 2
    jrng, prng = np.random.default_rng(4), np.random.default_rng(4)
    for i in range(6):
        want, got = jset.sample(i, jrng), pset.sample(i, prng)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["image"].shape == crop
    assert prng.random() == jrng.random()  # the same number of draws


@pytest.fixture(scope="module")
def unet(data):
    """A UNet2D at base 4: the JAX model and its parameters, and the port
    model carrying them."""
    jm = jget_model("resunet_2d", len(CLASSES), {"base_chan": 4},
                    dtype=jnp.float32)
    flat = flax_params(jm, np.zeros((1, 32, 32, 1), np.float32), seed=2)
    from flax.traverse_util import unflatten_dict

    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    model = load_flax_params(get_model("resunet_2d", len(CLASSES),
                                       {"base_chan": 4},
                                       dtype=torch.float32), flat).eval()
    return jm, params, model


def _jax_apply(jm):
    return lambda p, x: jm.apply(p, x)["segmentation"]


def test_sliding_window_inference_2d_matches_jax(unet):
    jm, params, model = unet
    vol = np.random.default_rng(3).normal(size=(3, 40, 50)).astype(
        np.float32)
    want = jsw2d(_jax_apply(jm), params, vol, len(CLASSES), window=(32, 32),
                 batch=4)
    got = sliding_window_inference_2d(
        validation.head_fn(model), vol, len(CLASSES), window=(32, 32),
        batch=4, device="cpu")
    assert got.shape == want.shape == (3, 40, 50, len(CLASSES))
    assert got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= PROB_TOL
    # a slice smaller than the window is padded, then cropped back
    small = vol[:, :20, :24]
    got = sliding_window_inference_2d(validation.head_fn(model), small,
                                      len(CLASSES), window=(32, 32),
                                      device="cpu")
    want = jsw2d(_jax_apply(jm), params, small, len(CLASSES),
                 window=(32, 32))
    assert got.shape == (3, 20, 24, len(CLASSES))
    assert float(np.abs(got - want).max()) <= PROB_TOL


def _val_cases(data):
    from rsuper_tpu_torch.data.preprocess import load_case

    return [load_case(str(data / "masks" / f"BDMAP_M{k}.npz"),
                      num_classes=len(CLASSES)) for k in range(2)]


def test_validate_cases_2d_matches_jax(unet, data, monkeypatch):
    """``validate_cases_2d`` gives the JAX function's case counts and its
    Dice values within the bound of the module docstring."""
    import rsuper_tpu.inference.sliding_window2d as jsw_mod

    jm, params, model = unet
    cases = _val_cases(data)
    jax_probs = []

    def recorded(*args, **kwargs):
        jax_probs.append(jsw2d(*args, **kwargs))
        return jax_probs[-1]

    monkeypatch.setattr(jsw_mod, "sliding_window_inference_2d", recorded)
    want = jval.validate_cases_2d(_jax_apply(jm), params, cases,
                                  len(CLASSES), window=(32, 32))
    assert len(jax_probs) == len(cases)
    got = validation.validate_cases_2d(validation.head_fn(model), cases,
                                       len(CLASSES), window=(32, 32),
                                       device="cpu")
    assert sorted(got) == sorted(want) == ["cases_per_class", "dice"]
    np.testing.assert_array_equal(got["cases_per_class"],
                                  want["cases_per_class"])
    bound = np.zeros(len(CLASSES))
    for (image, labels), probs in zip(cases, jax_probs):
        near = np.abs(probs - 0.5) <= PROB_TOL
        for c in range(len(CLASSES)):
            if labels[c].any():
                bound[c] += 2 * near[..., c].sum() / labels[c].sum()
    bound /= np.maximum(want["cases_per_class"], 1)
    assert (np.abs(got["dice"] - want["dice"]) <= bound + 1e-12).all()
    assert got["dice"].max() > 0


def test_two_steps_of_the_2d_preset_match_jax_train(data, tmp_path,
                                                    monkeypatch):
    jcfg = jload_config(PRESET, overrides=dict(SMALL, cp_path=str(
        tmp_path / "jax")))
    cfg = load_config(PRESET, overrides=dict(SMALL, cp_path=str(
        tmp_path / "port")))
    assert cfg.is_2d and cfg.loss == "dice" and cfg.ema
    jmodel = jget_model(cfg.arch, len(CLASSES), {"base_chan": 4},
                        dtype=jnp.float32)
    init = jloop.init_params_on_host(
        jmodel, jax.random.PRNGKey(jcfg.seed),
        jnp.zeros((1, *jcfg.training_size, 1), jnp.float32))
    flat0 = _flat(init["params"])
    jset = jds2.SliceDataset(_mask_cases(data, jds), jds2.SliceDataConfig(
        classes=tuple(CLASSES), crop_size=jcfg.training_size))
    jlosses = _record_losses(monkeypatch, jloop)
    jstate = jloop.train(jcfg, jmodel, jset, max_steps=2)

    pset = ds2.SliceDataset(_mask_cases(data, ds), ds2.SliceDataConfig(
        classes=tuple(CLASSES), crop_size=cfg.training_size))
    model = load_flax_params(get_model(cfg.arch, len(CLASSES),
                                       {"base_chan": 4},
                                       dtype=torch.float32), flat0)
    losses = _record_losses(monkeypatch, loop)
    state = loop.train(cfg, model, pset, max_steps=2, device="cpu")
    assert state.step == int(jstate.step) == 2
    assert len(losses) == len(jlosses) == 2
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= LOSS_TOL * abs(v), (i, k, got[k], v)
    _check_params(state, jstate, flat0, cfg, steps=2)


def _cli(data, cp, *extra):
    return ["--preset", PRESET, "--data_root", str(data / "masks"),
            "--cp_path", str(cp), "--num_workers", "1", "--iter_per_epoch",
            "2", "--device", "cpu", *extra]


def test_cli_trains_validates_resumes_and_refuses_report_cases(
        data, tmp_path, monkeypatch):
    """Fold 0 of 2 (one case trains, one validates): 2 epochs of 2 steps
    with the held-out case validated after each and at the fold's end,
    then one more step on --resume; CT-Report cases are refused."""
    monkeypatch.setitem(pconfig.DEFAULT_CONFIGS, PRESET, dict(
        pconfig.DEFAULT_CONFIGS[PRESET], model_args={"base_chan": 4},
        training_size=(32, 32), compute_dtype="float32", val_freq=1,
        batch_size=2))
    fold = ["--k_fold", "2", "--fold", "0"]
    first = cli.main(_cli(data, tmp_path, "--epochs", "2", *fold))
    assert first.step == 4
    exp = tmp_path / "test_fold0"
    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    val = [r["val/dice_mean"] for r in recs if "val/dice_mean" in r]
    assert len(val) == 2 and all(np.isfinite(val))
    assert (exp / "best").exists()
    results = json.loads((exp / "fold_results.json").read_text())
    assert results["fold"] == 0
    second = cli.main(_cli(data, tmp_path, "--epochs", "3", "--max_steps",
                           "1", "--resume", "--dimension", "2d", *fold))
    assert second.step == 5
    assert "resumed from step 4" in (exp / "train.log").read_text()
    with pytest.raises(SystemExit, match="CT-Mask slices only"):
        cli.main(_cli(data, tmp_path, "--report_root",
                      str(data / "reports"), "--reports",
                      str(data / "reports.csv"), "--all_train"))
