"""The port's Model-Genesis mode, legacy losses and matcher against the JAX
package, on the CPU.

* ``model_genesis_loss`` and ``calculate_loss(model_genesis=True)``: float32
  MSE, 1e-6 relative (sums in another order); with auxiliary heads both
  packages raise (JAX: a list has no ``astype``; the port: ``ValueError``).
* ``softmax_dice_loss`` and ``focal_loss``: values and gradients at the
  logits within 1e-6 relative (of the largest gradient for gradients).
* The matcher: cost matrices equal to 1e-12, assignments equal.
* One step of ``build_train_step(model_genesis=True)`` on a tiny single-head
  MedFormer (``aux_loss=False``) at 16³, from the same parameters
  (``models/params.py``): the loss within 1e-4 relative, the parameters
  after the step within the bounds of ``tests/test_torch_train.py``
  (max|Δp| ≤ 2·lr, mean|Δp| ≤ 0.2·lr: Adam's first update is about
  lr·sign(g)). The JAX step is the file's one compile.
* The port's loop trains the mode (port only).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
from rsuper_tpu.losses import LossConfig as JLossConfig
from rsuper_tpu.losses import dispatcher as jdisp
from rsuper_tpu.losses import genesis as jgen
from rsuper_tpu.losses import legacy as jleg
from rsuper_tpu.losses import matcher as jmatch
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.train import build_train_step as jax_build_train_step
from rsuper_tpu.train import make_optimizer as jax_make_optimizer
from rsuper_tpu.train.state import TrainState as JaxTrainState
from rsuper_tpu_torch.config import load_config
from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
from rsuper_tpu_torch.losses import dispatcher, genesis, legacy, matcher
from rsuper_tpu_torch.models import get_model, init_params, load_flax_params
from rsuper_tpu_torch.models import params_from_flax
from rsuper_tpu_torch.train import build_train_step, loop
from rsuper_tpu_torch.train import create_train_state, make_optimizer
from test_torch_loop import (OVERRIDES, PRESET, _one_intra_op_thread,  # noqa: F401
                             _port_dataset, _write_cases)
from test_torch_train import (CLASSES, LR, OPT, TINY, _flat_np, _flax_params,
                              _unflatten)

SIZE = 16
LMAP_T = LesionChannelMap.from_classes(CLASSES)
LMAP_J = JLesionChannelMap.from_classes(CLASSES)


def _rel(got, ref):
    return abs(float(got) - float(ref)) / abs(float(ref))


# ------------------------------------------------------------ genesis loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_genesis_loss_matches_jax(dtype):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 6, 7, 5, 3)).astype(np.float32)
    b = rng.normal(size=a.shape).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ta, tb = (torch.from_numpy(v).to(tdt) for v in (a, b))
    ja, jb = (jnp.asarray(v).astype(jdt) for v in (a, b))
    got = genesis.model_genesis_loss(ta, tb)
    ref = jgen.model_genesis_loss(ja, jb)
    assert sorted(got) == sorted(ref) == ["genesis_loss", "overall"]
    for k in ref:
        assert got[k].dtype == torch.float32
        assert _rel(got[k], ref[k]) <= 1e-6, (k, float(got[k]), float(ref[k]))
    # the dispatcher's branch reads the head and the label alone
    out = dispatcher.calculate_loss({"segmentation": ta}, tb, None, None,
                                    None, None, LMAP_T, model_genesis=True)
    assert float(out["overall"]) == float(got["overall"])


def test_aux_heads_raise_in_both_packages():
    x = np.ones((1, 4, 4, 4, 2), np.float32)
    with pytest.raises(ValueError, match="single-head model"):
        dispatcher.calculate_loss(
            {"segmentation": [torch.from_numpy(x)] * 2}, torch.from_numpy(x),
            None, None, None, None, LMAP_T, model_genesis=True)
    with pytest.raises(AttributeError):
        jdisp.calculate_loss({"segmentation": [jnp.asarray(x)] * 2},
                             jnp.asarray(x), None, None, None, None, LMAP_J,
                             model_genesis=True)


# ----------------------------------------------------------- legacy losses
def _value_and_grad(fn_t, fn_j, logits, *rest):
    x = torch.from_numpy(logits.copy()).requires_grad_(True)
    v = fn_t(x, *(torch.from_numpy(r) for r in rest))
    v.backward()
    jv, jg = jax.value_and_grad(fn_j)(jnp.asarray(logits),
                                      *(jnp.asarray(r) for r in rest))
    return float(v.detach()), x.grad.numpy(), float(jv), np.asarray(jg)


@pytest.mark.parametrize("seed", [0, 1])
def test_legacy_losses_match_jax_with_gradients(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(2, 5, 6, 4, 4)) * 3).astype(np.float32)
    idx = rng.integers(0, 4, size=logits.shape[:-1])
    idx[0, 0, 0, :2] = [-1, 4]  # outside [0, C): one-hot of zeros in both
    targets = (rng.random(logits.shape) < 0.3).astype(np.float32)
    cases = [
        (legacy.softmax_dice_loss, jleg.softmax_dice_loss, (idx,)),
        (lambda x, t: legacy.focal_loss(x, t, gamma=1.5, alpha=0.4),
         lambda x, t: jleg.focal_loss(x, t, gamma=1.5, alpha=0.4), (targets,)),
        (legacy.focal_loss, jleg.focal_loss, (targets,)),
    ]
    for fn_t, fn_j, rest in cases:
        v, g, jv, jg = _value_and_grad(fn_t, fn_j, logits, *rest)
        assert _rel(v, jv) <= 1e-6, (v, jv)
        assert np.abs(g - jg).max() <= 1e-6 * np.abs(jg).max()


# ------------------------------------------------------------------ matcher
def test_matcher_matches_jax():
    rng = np.random.default_rng(2)
    S = 8
    labels = np.zeros((S, S, S, 2), np.float32)
    labels[1:4, 1:4, 1:4, 0] = 1
    labels[5:7, 5:7, 5:7, 1] = 1
    swapped = labels[..., ::-1].copy()
    for pred, lab in ((swapped, labels),
                      (rng.random((6, 5, 7, 4)), rng.random((6, 5, 7, 4)) > 0.7),
                      (rng.random((6, 5, 7, 3)), rng.random((6, 5, 7, 3)))):
        np.testing.assert_allclose(matcher.dice_cost_matrix(pred, lab),
                                   jmatch.dice_cost_matrix(pred, lab),
                                   rtol=0, atol=1e-12)
        got, want = (m.hungarian_match(pred, lab) for m in (matcher, jmatch))
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert [list(v) for v in matcher.hungarian_match(swapped, labels)] == \
        [[0, 1], [1, 0]]
    pred = rng.random((3, 4, 4, 4, 3))
    lab = rng.random((3, 4, 4, 4, 3)) > 0.5
    for g, w in zip(matcher.match_batch(pred, lab),
                    jmatch.match_batch(pred, lab)):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------- one training step
@pytest.fixture(scope="module")
def ref():
    """One JAX genesis step of the single-head tiny MedFormer: the loss
    and the parameters after it."""
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(1, SIZE, SIZE, SIZE, 1)),
             "label": rng.random((1, SIZE, SIZE, SIZE, len(CLASSES)))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    model = JaxMedFormer(len(CLASSES), dtype=jnp.float32, remat=False,
                         aux_loss=False, **TINY)
    flat = _flax_params(model, batch["image"])
    params = {"params": _unflatten(flat)}
    tx = jax_make_optimizer(**OPT)
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          ema_params=jax.tree.map(jnp.copy, params),
                          step=jnp.zeros((), jnp.int32), tx=tx)
    step = jax_build_train_step(model, LMAP_J, JLossConfig(),
                                model_genesis=True)
    state, losses = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(batch=batch, flat=flat,
                losses={k: float(v) for k, v in losses.items()},
                after=_flat_np(state.params["params"]))


def _genesis_state(flat, aux_loss):
    model = get_model("medformer", len(CLASSES),
                      {**TINY, "remat": False, "aux_loss": aux_loss},
                      dtype=torch.float32)
    load_flax_params(model, flat).train()
    return create_train_state(model, make_optimizer(model.parameters(), **OPT))


def test_genesis_step_matches_jax(ref):
    state = _genesis_state(ref["flat"], aux_loss=False)
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    state, losses = build_train_step(LMAP_T, LossConfig(),
                                     model_genesis=True)(state, batch)
    assert sorted(losses) == sorted(ref["losses"]) == ["genesis_loss",
                                                       "overall"]
    for k, v in ref["losses"].items():
        assert _rel(losses[k], v) <= 1e-4, (k, float(losses[k]), v)
    after = params_from_flax(ref["after"], state.model)
    diffs = torch.cat([(p.detach() - after[k]).abs().flatten()
                       for k, p in state.model.named_parameters()])
    assert float(diffs.max()) <= 2 * LR
    assert float(diffs.mean()) <= 0.2 * LR
    moved = torch.cat([(p.detach() - start[k]).abs().flatten()
                       for k, p in state.model.named_parameters()])
    assert float(moved.mean()) > 0.5 * LR


def test_genesis_step_with_aux_heads_raises(ref):
    model = get_model("medformer", len(CLASSES), {**TINY, "aux_loss": True},
                      dtype=torch.float32)
    state = create_train_state(init_params(model, seed=0),
                               make_optimizer(model.parameters(), **OPT))
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    step = build_train_step(LMAP_T, LossConfig(), model_genesis=True)
    with pytest.raises(ValueError, match="aux_loss=False"):
        step(state, batch)


def test_loop_trains_the_genesis_mode(tmp_path):
    """``model_genesis_pretrain`` through ``loop.train``: two steps of MSE
    between the single-head model's logits and the labels, logged as
    ``train/genesis_loss``."""
    data = _write_cases(tmp_path / "cases")
    cfg = load_config(PRESET, overrides=dict(
        OVERRIDES, cp_path=str(tmp_path / "cp"), model_genesis_pretrain=True,
        model_args=dict(TINY, aux_loss=False), iter_per_epoch=1))
    model = init_params(get_model("medformer", len(cfg.classes),
                                  cfg.model_args, dtype=torch.float32), seed=0)
    state = loop.train(cfg, model, _port_dataset(data, cfg), device="cpu",
                       max_steps=1)
    assert state.step == 1
    logged = [json.loads(line) for line in
              (tmp_path / "cp" / cfg.unique_name / "metrics.jsonl")
              .read_text().splitlines()]
    first = next(r for r in logged if "train/genesis_loss" in r)
    assert first["train/genesis_loss"] == first["train/overall"] > 0
    assert not any(k.startswith("train/segmentation") for r in logged
                   for k in r)
