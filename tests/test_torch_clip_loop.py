"""CLIP pretraining through the port's loop and CLI against the JAX package,
on the CPU (the cases, model widths and draws of ``tests/test_torch_loop.py``:
two CT-Mask and two CT-Report cases, batch 2, float32, the JAX loop's
augmentation draws replayed).

* One step of ``loop.train`` with ``clip_pretrain`` against the JAX loop's
  from the same parameters, on the first organ batch (the two report cases,
  with their seeded embeddings), at 64³ crops, where the CLIP head's patch
  merge leaves 8 voxels, so the loss depends on the images, their
  augmentation and the encoder. Every loss term within 1e-4 relative (the
  tolerance of ``tests/test_torch_loop.py``). The parameters after the step
  within the bounds of ``tests/test_torch_loop.py``, and every parameter the
  CLIP loss does not reach (the decoder and the part of the semantic-map
  path only the decoder reads) moved by AdamW's weight decay alone,
  p·(1 − lr·wd), as in JAX, to two float32 spacings. The parameters are seeded with non-zero biases (``flax_params``
  of ``tests/test_torch_medformer.py``).
* The JAX reference's own float32 rounding on the CPU bounds how close the
  two can be at 64³. Its instance-norm statistics are float32 sums of 2^18
  voxels that XLA:CPU accumulates with more error than PyTorch, and the
  encoder and InfoNCE at T = 0.1 amplify that; against a float64 run of
  the JAX model the port's float32 loss is the closer of the two in most
  cases (``tools/clip_rounding_witness.py``, ``ROADMAP.md`` §3).
* A run cut after step 1 of a 2-step epoch and resumed draws the batches of
  an uninterrupted one and ends in the same state, bit for bit; every batch
  holds one crop organ; the report embeddings reach the step as float32
  (B, clip_feats) tensors (32³ crops, port only).
* ``data_shards`` > 1 on one process raises, as the JAX loop does.
* The CLI: ``--clip_pretrain`` without ``--clip_source`` exits with the JAX
  CLI's message; with a source, one step runs on ``--device cpu``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jtrain
from rsuper_tpu.config import load_config as jload_config
from rsuper_tpu.data import clip as jclip
from rsuper_tpu.data import dataset as jds
from rsuper_tpu.data import reports as jrep
from rsuper_tpu.models import get_model as jget_model
from rsuper_tpu.train import loop as jloop
from rsuper_tpu_torch.config import config, load_config
from rsuper_tpu_torch.data import clip
from rsuper_tpu_torch.data.sampler import OrganBatchSampler
from rsuper_tpu_torch.models import get_model, init_params, load_flax_params
from rsuper_tpu_torch.train import __main__ as cli
from rsuper_tpu_torch.train import loop
from test_torch_loop import (CLASSES, LOSS_TOL, OVERRIDES, PRESET, TINY,
                             _cases, _check_params, _cli_args, _jax_draws,
                             _one_intra_op_thread, _port_dataset,  # noqa: F401
                             _record_losses, _same_state, _write_cases)
from test_torch_medformer import _unflatten, flax_params

FEATS = 16
MODEL_ARGS = {**TINY, "clip_branch": True, "clip_feats": FEATS}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The cases of ``tests/test_torch_loop.py`` and an embedding directory
    with the two report cases' (the CT-Mask cases take zeros)."""
    root = _write_cases(tmp_path_factory.mktemp("clip_cases"))
    emb = root / "embeddings"
    emb.mkdir()
    rng = np.random.default_rng(0)
    for k in range(2):
        np.save(emb / f"BDMAP_R{k}.npy",
                rng.normal(size=FEATS).astype(np.float32))
    return root


def _overrides(data, cp, **kw):
    return dict(OVERRIDES, model_args=MODEL_ARGS, clip_pretrain=True,
                clip_source=str(data / "embeddings"), cp_path=str(cp), **kw)


def _port_clip_dataset(data, cfg):
    return clip.ClipRecordAdapter(_port_dataset(data, cfg),
                                  clip.ReportEmbeddingStore(cfg.clip_source),
                                  dim=FEATS)


def test_one_clip_step_matches_jax_train(data, tmp_path, monkeypatch):
    size = dict(training_size=(64, 64, 64))  # 8 voxels in the CLIP head
    jcfg = jload_config(PRESET, overrides=_overrides(data, tmp_path / "jax",
                                                     **size))
    cfg = load_config(PRESET, overrides=_overrides(data, tmp_path / "port",
                                                   **size))
    jmodel = jget_model("medformer", len(CLASSES), dict(MODEL_ARGS),
                        dtype=jnp.float32)
    # seeded parameters with non-zero biases; the JAX loop starts from them
    flat0 = flax_params(jmodel, np.zeros((1, 32, 32, 32, 1), np.float32))
    init = {"params": _unflatten(flat0)}
    monkeypatch.setattr(jloop, "init_params_on_host", lambda *a: init)
    jrows, _, _ = jrep.clean_reports(jrep.load_reports(
        str(data / "reports.csv")), list(jcfg.tumor_classes))
    jdataset = jclip.ClipRecordAdapter(
        jds.RSuperDataset(_cases(data, jds), jds.RSuperDataConfig(
            classes=jcfg.classes, report_classes=jcfg.report_classes,
            crop_size=jcfg.training_size, tumor_classes=jcfg.tumor_classes),
            report_rows=jrows),
        jclip.ReportEmbeddingStore(jcfg.clip_source), dim=FEATS)
    jlosses = _record_losses(monkeypatch, jloop)
    jstate = jloop.train(jcfg, jmodel, jdataset, max_steps=1)

    dataset = _port_clip_dataset(data, cfg)
    organs = dataset.crop_organs()
    first = OrganBatchSampler(organs, cfg.batch_size, seed=cfg.seed).batch(0)
    assert {organs[i] for i in first} == {"pancreas"}  # the report cases
    model = load_flax_params(get_model("medformer", len(CLASSES),
                                       dict(MODEL_ARGS), dtype=torch.float32),
                             flat0)
    losses = _record_losses(monkeypatch, loop)
    state = loop.train(cfg, model, dataset, max_steps=1, device="cpu",
                       draws=_jax_draws(cfg))
    assert state.step == int(jstate.step) == 1
    assert len(losses) == len(jlosses) == 1
    got, want = losses[0], jlosses[0]
    assert sorted(got) == sorted(want) == ["contrastive_loss", "overall"]
    for k, v in want.items():
        assert np.isfinite(got[k])
        assert abs(got[k] - v) <= LOSS_TOL * abs(v), (k, got[k], v)

    lr, params = _check_params(state, jstate, flat0, cfg, steps=1)
    # where the loss does not reach, JAX's gradient is zero and AdamW's
    # update is the weight decay alone: the port must decay those too
    decay = 1 - np.float32(lr[0] * cfg.weight_decay)
    unreached = []
    for k, (got_p, want_p, p0) in params.items():
        spacing = np.spacing(np.abs(want_p).astype(np.float32))
        if (np.abs(want_p - p0 * decay) <= 2 * spacing).all():
            unreached.append(k)
            assert (np.abs(got_p - want_p) <= 2 * spacing).all(), k
            assert (got_p != p0).any(), k
    decoder = [k for k in params if k.startswith(
        ("UpBlockMF", "outc", "aux_out", "SemanticMapFusion"))]
    assert decoder and set(decoder) <= set(unreached)
    assert not any(k.startswith("clip_branch") for k in unreached)


class _Recorded:
    """A dataset wrapper that keeps the indices it was asked for."""

    def __init__(self, dataset):
        self.dataset, self.seen = dataset, []

    def __len__(self):
        return len(self.dataset)

    def crop_organs(self):
        return self.dataset.crop_organs()

    def sample(self, index, rng=None):
        self.seen.append(int(index))
        return self.dataset.sample(index, rng)


def _train_clip(data, cp, **kw):
    cfg = load_config(PRESET, overrides=_overrides(
        data, cp, seed=2, iter_per_epoch=2, epochs=1, **kw.pop("cfg", {})))
    dataset = _Recorded(_port_clip_dataset(data, cfg))
    model = init_params(get_model("medformer", len(CLASSES),
                                  dict(MODEL_ARGS), dtype=torch.float32),
                        seed=3)
    with torch.no_grad():  # a non-zero CLIP vector at 32³
        model.clip_branch.Conv_0.bias.copy_(torch.randn(
            model.clip_branch.Conv_0.bias.shape,
            generator=torch.Generator().manual_seed(1)))
    return loop.train(cfg, model, dataset, device="cpu", **kw), dataset


def test_resumed_clip_run_draws_the_uninterrupted_batches(data, tmp_path,
                                                         monkeypatch):
    layouts = []
    build = loop.build_train_step

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, batch):
            emb = batch["report_embedding"]
            layouts.append((emb.dtype, tuple(emb.shape), emb.device.type))
            return step(state, batch)

        return recorded

    monkeypatch.setattr(loop, "build_train_step", recording)
    whole, seen = _train_clip(data, tmp_path / "a")
    # the embeddings reach the step in float32, past the augmentation
    assert layouts == [(torch.float32, (2, FEATS), "cpu")] * 2
    assert whole.step == 2
    cut, _ = _train_clip(data, tmp_path / "b", max_steps=1)
    resumed, seen_again = _train_clip(data, tmp_path / "b",
                                      cfg={"resume": True})
    assert (cut.step, resumed.step) == (1, 2)
    _same_state(whole, resumed)
    # the resumed run loads the epoch's batches again (and drops the first)
    assert seen_again.seen == seen.seen and len(seen.seen) == 4
    organs = seen.crop_organs()
    for b in range(2):
        assert len({organs[i] for i in seen.seen[2 * b:2 * b + 2]}) == 1


def test_clip_pretraining_with_data_shards_raises(data, tmp_path):
    cfg = load_config(PRESET, overrides=_overrides(data, tmp_path,
                                                   data_shards=2))
    with pytest.raises(ValueError, match="data_shards"):
        loop._epoch_indices(cfg, _port_clip_dataset(data, cfg), 0)


def _jax_cli_args(data, cp, *extra):
    """The same flags without the port's own (``train.py`` has neither)."""
    args = _cli_args(data, cp, *extra)
    for flag in ("--device", "--num_workers"):
        i = args.index(flag)
        args = args[:i] + args[i + 2:]
    return args


def test_clip_pretrain_needs_a_source_as_in_jax(data, tmp_path):
    with pytest.raises(SystemExit) as got:
        cli.main(_cli_args(data, tmp_path, "--clip_pretrain"))
    with pytest.raises(SystemExit) as want:
        jtrain.main(_jax_cli_args(data, tmp_path, "--clip_pretrain"))
    assert str(got.value) == str(want.value)
    assert "--clip_source" in str(got.value)


def test_cli_clip_pretrain_trains_a_step_on_cpu(data, tmp_path, monkeypatch):
    preset = dict(config.DEFAULT_CONFIGS[PRESET], training_size=(32, 32, 32),
                  compute_dtype="float32",
                  model_args=dict(TINY, clip_feats=FEATS))
    monkeypatch.setitem(config.DEFAULT_CONFIGS, PRESET, preset)
    state = cli.main(_cli_args(data, tmp_path, "--clip_pretrain",
                               "--clip_source", str(data / "embeddings"),
                               "--max_steps", "1"))
    assert state.step == 1
    assert state.model.heads == ("clip",)  # the CLI adds the CLIP head
    assert state.model.clip_branch.Dense_0.weight.shape[0] == FEATS
    recs = [json.loads(line) for line in
            (tmp_path / "test" / "metrics.jsonl").read_text().splitlines()]
    logged = [r for r in recs if "train/contrastive_loss" in r]
    assert logged and np.isfinite(logged[0]["train/contrastive_loss"])
