"""The ``abdomenatlas/resunet_3d`` preset end to end in the port, on the
CPU, at a small ResUNet (base 4 channels, the preset's blocks and norm).

* Against the JAX package: ``train(max_steps=2)`` of both packages on the
  synthetic cases of ``tests/test_torch_loop.py`` (32³ crops, batch 2,
  float32, one loader worker, the same initial parameters and the JAX
  loop's augmentation draws, here with the preset's scaling of ±0.3), with
  the preset's default ``ball_dice_last`` losses on the ResUNet's one
  head. The losses of each step agree within LOSS_TOL relative and the
  parameters after the steps within that file's update bounds.
* The CLI: ``python -m rsuper_tpu_torch.train --preset
  abdomenatlas/resunet_3d`` trains fold 0 of 2, validates it, saves, and
  resumes; ``python -m rsuper_tpu_torch.predict --arch resunet
  --checkpoint`` serves what it wrote, with masks and lesion
  probabilities bit-equal to ``--params_npz`` of the same weights.
* Warm starts across class lists on ``resunet`` with ``aux_head``: the
  port's class surgery of ``outc`` and ``aux_out`` equals the JAX
  package's on the same trees, bit for bit, also through ``--pretrained``
  with a flax ``.npz`` donor.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.config import load_config as jload_config
from rsuper_tpu.data import dataset as jds
from rsuper_tpu.data import reports as jrep
from rsuper_tpu.models import get_model as jget_model
from rsuper_tpu.models import surgery as jsurgery
from rsuper_tpu.train import loop as jloop
from rsuper_tpu_torch import predict as predict_cli
from rsuper_tpu_torch.config import config as port_config
from rsuper_tpu_torch.config import load_config
from rsuper_tpu_torch.data.nifti import read_nifti, write_nifti
from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                     load_flax_params, params_from_flax,
                                     surgery)
from rsuper_tpu_torch.train import __main__ as train_cli
from rsuper_tpu_torch.train import checkpoint as ckpt
from rsuper_tpu_torch.train import loop
from rsuper_tpu_torch.train.optim import make_optimizer
from rsuper_tpu_torch.train.state import create_train_state
from test_torch_loop import (CLASSES, LOSS_TOL, OVERRIDES,  # noqa: F401
                             _cases, _check_params, _flat, _jax_draws,
                             _one_intra_op_thread, _port_dataset,
                             _record_losses, _write_cases)
from test_torch_medformer import _unflatten, flax_params

PRESET = "abdomenatlas/resunet_3d"
RES_TINY = dict(base_chan=4, block="BasicBlock", norm="in")
ZOO_OVERRIDES = dict(OVERRIDES, model_args=RES_TINY)
OLD = ["kidney_left", "liver", "pancreas", "pancreatic_lesion", "spleen"]
NEW = ["aorta", "kidney_left", "liver", "pancreatic_lesion"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_cases(tmp_path_factory.mktemp("cases"))


def test_two_resunet_steps_match_jax_train(data, tmp_path, monkeypatch):
    jcfg = jload_config(PRESET, overrides=dict(ZOO_OVERRIDES, cp_path=str(
        tmp_path / "jax")))
    cfg = load_config(PRESET, overrides=dict(ZOO_OVERRIDES, cp_path=str(
        tmp_path / "port")))
    assert cfg.arch == "resunet" and cfg.scale == (0.3, 0.3, 0.3)
    assert cfg.loss_config().loss == "ball_dice_last"
    jmodel = jget_model("resunet", len(CLASSES), dict(RES_TINY),
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
    model = load_flax_params(get_model("resunet", len(CLASSES),
                                       dict(RES_TINY), dtype=torch.float32),
                             flat0)
    state = loop.train(cfg, model, _port_dataset(data, cfg), max_steps=2,
                       device="cpu", draws=_jax_draws(cfg))
    assert state.step == int(jstate.step) == 2
    assert len(losses) == len(jlosses) == 2
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert sorted(got) == sorted(want)
        assert "ball_loss_bce" in got  # the Ball Loss ran
        for k, v in want.items():
            assert abs(got[k] - v) <= LOSS_TOL * abs(v), (i, k, got[k], v)
    _check_params(state, jstate, flat0, cfg, steps=2)


def _tiny_preset(monkeypatch):
    monkeypatch.setitem(port_config.DEFAULT_CONFIGS, PRESET, dict(
        port_config.DEFAULT_CONFIGS[PRESET], model_args=RES_TINY,
        training_size=(32, 32, 32), compute_dtype="float32"))


def _serve(root, name, source):
    out = root / "out" / name
    done = predict_cli.main([
        "--input_dir", str(root / "in"), "--output_dir", str(out), *source,
        "--classes_json", str(root / "classes.json"), "--arch", "resunet",
        "--model_args_json", json.dumps(RES_TINY), "--window", "32", "32",
        "32", "--batch_windows", "2", "--save_probabilities", "--prob_wire",
        "f16", "--device", "cpu"])
    assert done == ["case_a"]
    names = CLASSES + ["pancreatic_lesion_prob"]
    return {c: read_nifti(str(out / "case_a" / f"{c}.nii.gz")).data
            for c in names}


def test_resunet_cli_trains_validates_resumes_and_is_served(data, tmp_path,
                                                           monkeypatch):
    _tiny_preset(monkeypatch)
    args = ["--preset", PRESET, "--data_root", str(data / "masks"),
            "--report_root", str(data / "reports"), "--reports",
            str(data / "reports.csv"), "--cp_path", str(tmp_path / "cp"),
            "--num_workers", "1", "--iter_per_epoch", "2", "--epochs", "3",
            "--k_fold", "2", "--fold", "0", "--device", "cpu"]
    first = train_cli.main(args + ["--max_steps", "2"])
    second = train_cli.main(args + ["--max_steps", "1", "--resume"])
    assert (first.step, second.step) == (2, 3)
    run = tmp_path / "cp" / "test_fold0"
    assert "arch: resunet" in (run / "config.txt").read_text()
    results = json.loads((run / "fold_results.json").read_text())
    assert (results["fold"], results["classes"]) == (0, CLASSES)
    assert len(results["dice"]) == len(CLASSES)
    saved = torch.load(run / "latest", weights_only=True)
    assert saved["step"] == 3

    (tmp_path / "in").mkdir()
    ct = (np.random.default_rng(6).normal(size=(30, 34, 20)) * 200.0
          ).astype(np.float32)
    write_nifti(str(tmp_path / "in" / "case_a.nii.gz"), ct, np.eye(4))
    (tmp_path / "classes.json").write_text(json.dumps(CLASSES))
    np.savez(tmp_path / "params.npz", **flax_from_state_dict(
        ckpt.load_params(str(run), "latest")))
    got = _serve(tmp_path, "ckpt", ["--checkpoint", str(run), "--tag",
                                    "latest"])
    want = _serve(tmp_path, "npz", ["--params_npz",
                                    str(tmp_path / "params.npz")])
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[c], want[c]) for c in got)
    assert np.ptp(got["pancreatic_lesion_prob"]) > 0


@pytest.fixture(scope="module")
def aux_flats():
    """(donor's flax parameters at OLD, fresh ones at NEW) of a ResUNet with
    the aux head."""
    x = np.zeros((1, 16, 16, 16, 1), np.float32)
    args = dict(RES_TINY, aux_head=True)
    return tuple(flax_params(jget_model("resunet", len(classes), args,
                                        dtype=jnp.float32), x, seed=seed)
                 for classes, seed in ((OLD, 1), (NEW, 2)))


def _model(n):
    return get_model("resunet", n, dict(RES_TINY, aux_head=True),
                     dtype=torch.float32)


@pytest.mark.parametrize("path", ["surgery", "pretrained_npz"])
def test_resunet_aux_class_surgery_matches_jax(aux_flats, tmp_path, path):
    old, new = aux_flats
    want = jsurgery.update_output_layers(
        {"params": _unflatten(new)}, {"params": _unflatten(old)}, OLD, NEW)
    want = params_from_flax(_flat(want["params"]), _model(len(NEW)))
    if path == "surgery":
        got = surgery.update_output_layers(
            params_from_flax(new, _model(len(NEW))),
            params_from_flax(old, _model(len(OLD))), OLD, NEW)
    else:
        np.savez(tmp_path / "donor.npz", **old)
        model = load_flax_params(_model(len(NEW)), new)
        state = create_train_state(model, make_optimizer(model.parameters()))
        ckpt.load_pretrained_params(state, str(tmp_path / "donor.npz"),
                                    old_classes=OLD, new_classes=NEW)
        got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    heads = [k for k in got if k.split(".")[0] in surgery.HEADS]
    assert sorted(heads) == ["aux_out.bias", "aux_out.weight", "outc.bias",
                             "outc.weight"]
    donor = params_from_flax(old, _model(len(OLD)))
    shared = NEW.index("liver"), OLD.index("liver")
    assert torch.equal(got["outc.weight"][shared[0]],
                       donor["outc.weight"][shared[1]])
