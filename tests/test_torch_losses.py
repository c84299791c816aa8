"""The PyTorch port's losses against the JAX package, on the CPU: values and
gradients at the logits, same numpy inputs on both sides.

Tolerances:
* float32: values 1e-5 relative; gradients max|Δ| ≤ 1e-5·max|ref| + 1e-9
  (the same formulas; sums over the volume run in another order);
* bfloat16 (the training type: logits and masks in bf16, reductions in
  float32): values 1e-2 relative; gradients max|Δ| ≤ 3e-2·max|ref|. Both
  sides round every elementwise result to bf16 (2^-8 relative), and XLA may
  keep a fused chain in float32 where PyTorch rounds each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.losses import ball as jball
from rsuper_tpu.losses import dispatcher as jdisp
from rsuper_tpu.losses import lesions as jles
from rsuper_tpu.losses import seg as jseg
from rsuper_tpu.losses import volume as jvol
from rsuper_tpu_torch.losses import (BallLossConfig, LesionChannelMap,
                                     LossConfig, ball_loss, calculate_loss)
from rsuper_tpu_torch.losses import ball, dispatcher, seg, volume

CLASSES = ["background", "liver", "liver_lesion", "liver_lesion_b",
           "liver_cyst", "pancreas", "pancreatic_pdac", "kidney_left"]
C, B, S = len(CLASSES), 2, 14
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VAL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    d = {}
    d["logits"] = rng.normal(size=(B, S, S, S, C)).astype(np.float32) * 2.0
    d["aux"] = rng.normal(size=(B, S, S, S, C)).astype(np.float32) * 2.0
    d["label"] = (rng.random((B, S, S, S, C)) < 0.2).astype(np.float32)
    d["label"][0, ..., 2:5] = 0.0  # item 0: report-only lesions
    unk = np.zeros((B, S, S, S, C), np.float32)
    unk[0, 3:6, 4:7, 2:9, 2] = 1.0
    unk[1, 8:10, 1:3, 5:8, 6] = 1.0
    d["unk"] = unk
    segm = np.zeros((B, S, S, S, C), np.float32)
    segm[0, 2:8, 3:9, 2:10, 2] = 1.0
    segm[1, 6:12, 0:5, 4:9, 6] = 1.0
    d["segment_mask"] = segm
    # far outside the Volume Loss's dead zone around the predicted volume
    # (about half the dilated segment: ~1400 voxels), so its gradient is not 0
    d["volumes"] = np.array([[300.0, 100.0, 0.0], [6000.0, 0.0, 0.0]],
                            np.float32)
    d["diameters"] = np.zeros((B, 3, 3), np.float32)
    d["class_weights"] = (0.5 + rng.random((B, C))).astype(np.float32)
    return d


DATA = _data()
LMAP_T = LesionChannelMap.from_classes(CLASSES)
LMAP_J = jles.LesionChannelMap.from_classes(CLASSES)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, copy=True)).to(TDT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(JDT[dtype])


def _check_value(got, ref, dtype, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.all(np.abs(got - ref) <= VAL_TOL[dtype] * np.abs(ref) + 1e-7), \
        f"{what}: {got} vs {ref}"


def _check_grad(got, ref, dtype, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    mx = float(np.abs(ref).max())
    assert mx > 0, f"{what}: the reference gradient is zero"
    err = float(np.abs(got - ref).max())
    assert err <= GRAD_TOL[dtype] * mx + 1e-9, f"{what}: {err} vs max {mx}"


def _both(tfn, jfn, dtype, what):
    """Value and gradient at the logits of a scalar loss on both sides."""
    x = _t(DATA["logits"], dtype).requires_grad_()
    val = tfn(x)
    (g,) = torch.autograd.grad(val, x)
    rv, rg = jax.value_and_grad(jfn)(_j(DATA["logits"], dtype))
    assert val.dtype == torch.float32 and g.dtype == TDT[dtype]
    _check_value(val.detach().numpy(), rv, dtype, what)
    _check_grad(g.float().numpy(), rg, dtype, what)


def test_lesion_channel_map_matches_jax():
    assert LMAP_T.lesion_names == LMAP_J.lesion_names
    assert LMAP_T.groups == LMAP_J.groups == ((2, 3), (4,), (6,))
    assert LMAP_T.num_lesion_channels == 3
    assert LMAP_T.lesion_class_indices() == LMAP_J.lesion_class_indices()
    got = LMAP_T.merge(_t(DATA["logits"]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(LMAP_J.merge(jnp.asarray(DATA["logits"]))))
    with pytest.raises(ValueError):
        LMAP_T.merge(torch.zeros(2, 3))


def test_lesion_merge_splits_the_gradient_among_ties():
    x = np.zeros((1, C), np.float32)  # both members of group 0 tie
    xt = _t(x).requires_grad_()
    (g,) = torch.autograd.grad(LMAP_T.merge(xt).sum(), xt)
    rg = jax.grad(lambda a: LMAP_J.merge(a).sum())(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg))
    assert g[0, 2] == g[0, 3] == 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bce_with_logits_matches_jax(dtype):
    w = DATA["class_weights"][:, None, None, None, :]
    got = seg.bce_with_logits(_t(DATA["logits"], dtype), _t(DATA["label"]),
                              _t(w))
    ref = jseg.bce_with_logits(_j(DATA["logits"], dtype),
                               jnp.asarray(DATA["label"]), jnp.asarray(w))
    assert got.dtype == TDT[dtype]
    tol = 1e-6 if dtype == "float32" else 2e-2
    r = np.asarray(ref, np.float32)
    assert np.abs(got.float().numpy() - r).max() <= tol * (1 + np.abs(r).max())


def test_bce_probs_matches_jax():
    p = 1.0 / (1.0 + np.exp(-DATA["logits"]))
    p[0, 0, 0, 0, :2] = [0.0, 1.0]  # the clip at eps
    got = seg.bce_probs(_t(p), _t(DATA["label"]))
    ref = jseg.bce_probs(jnp.asarray(p), jnp.asarray(DATA["label"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dilation", [0, 5])
def test_get_known_voxels_matches_jax(dilation):
    got = seg.get_known_voxels(_t(DATA["unk"], "bfloat16"), dilation)
    ref = jseg.get_known_voxels(_j(DATA["unk"], "bfloat16"), dilation)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.0 < got.mean() < 1.0


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_bce_matches_jax(dtype, weights):
    known = np.asarray(jseg.get_known_voxels(jnp.asarray(DATA["unk"])))
    cw = DATA["class_weights"] if weights else None
    _both(lambda x: seg.masked_bce_with_logits(
              x, _t(DATA["label"], dtype), _t(known),
              None if cw is None else _t(cw)),
          lambda x: jseg.masked_bce_with_logits(
              x, _j(DATA["label"], dtype), jnp.asarray(known),
              None if cw is None else jnp.asarray(cw)),
          dtype, "masked BCE")


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaptive_tversky_dice_matches_jax(dtype, weights):
    known = np.asarray(jseg.get_known_voxels(jnp.asarray(DATA["unk"])))
    cw = DATA["class_weights"] if weights else None
    _both(lambda x: seg.adaptive_tversky_dice(
              x, _t(DATA["label"], dtype), _t(known),
              class_weights=None if cw is None else _t(cw)),
          lambda x: jseg.adaptive_tversky_dice(
              x, _j(DATA["label"], dtype), jnp.asarray(known),
              class_weights=None if cw is None else jnp.asarray(cw)),
          dtype, "Tversky Dice")


def test_adaptive_tversky_dice_unreduced_on_probabilities():
    p = 1.0 / (1.0 + np.exp(-DATA["logits"]))
    known = np.ones_like(p)
    got = seg.adaptive_tversky_dice(_t(p), _t(DATA["label"]), _t(known),
                                    sigmoid=False, reduce=False)
    ref = jseg.adaptive_tversky_dice(jnp.asarray(p),
                                     jnp.asarray(DATA["label"]),
                                     jnp.asarray(known), sigmoid=False,
                                     reduce=False)
    assert tuple(got.shape) == (B, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_dice_based_volume_loss_matches_jax():
    rng = np.random.default_rng(1)
    pred = (rng.random((5, 7)) * 5000).astype(np.float32)
    tgt = np.array([0.0, 40.0, 100.0, 900.0, 4000.0, 250.0, 1e4], np.float32)
    for tol in (0.1, 0.2):
        got = volume.dice_based_volume_loss(_t(pred), _t(tgt), tolerance=tol)
        ref = jvol.dice_based_volume_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                          tolerance=tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-7)
    assert (got.numpy() == 0).any() and (got.numpy() > 0).any()


def test_lesion_masks_cf_matches_jax():
    got = ball.lesion_masks_cf(_t(DATA["label"], "bfloat16"),
                               _t(DATA["unk"], "bfloat16"),
                               _t(DATA["segment_mask"], "bfloat16"), LMAP_T)
    ref = jball.lesion_masks_cf(_j(DATA["label"], "bfloat16"),
                                _j(DATA["unk"], "bfloat16"),
                                _j(DATA["segment_mask"], "bfloat16"), LMAP_J)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == (B, 3, S, S, S)
        assert not g.requires_grad
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_volume_loss_matches_jax(dtype, precomputed, weights):
    cw = DATA["class_weights"] if weights else None
    pre_t = pre_j = None
    if precomputed:
        pre_t = ball.lesion_masks_cf(_t(DATA["label"]), _t(DATA["unk"]),
                                     _t(DATA["segment_mask"]), LMAP_T)
        pre_j = jball.lesion_masks_cf(
            jnp.asarray(DATA["label"]), jnp.asarray(DATA["unk"]),
            jnp.asarray(DATA["segment_mask"]), LMAP_J)
    _both(lambda x: volume.volume_loss(
              x, _t(DATA["segment_mask"], dtype), _t(DATA["volumes"]),
              _t(DATA["label"], dtype), None, LMAP_T, tolerance=0.2,
              class_weights=None if cw is None else _t(cw),
              precomputed=pre_t),
          lambda x: jvol.volume_loss(
              x, _j(DATA["segment_mask"], dtype),
              jnp.asarray(DATA["volumes"]), _j(DATA["label"], dtype), None,
              LMAP_J, tolerance=0.2,
              class_weights=None if cw is None else jnp.asarray(cw),
              precomputed=pre_j),
          dtype, "Volume Loss")


def _calc(side, dtype, heads, weights, unk, cfg_kw):
    """(losses, gradients at every head) of calculate_loss on one side."""
    names = ["logits", "aux"][:heads]
    cw = DATA["class_weights"] if weights else None
    keys = ("label", "unk", "segment_mask")
    if side == "torch":
        xs = [_t(DATA[n], dtype).requires_grad_() for n in names]
        m = {k: _t(DATA[k], dtype) for k in keys}
        losses = calculate_loss(
            {"segmentation": xs if heads > 1 else xs[0]}, m["label"],
            m["unk"] if unk else None, m["segment_mask"],
            _t(DATA["volumes"]), _t(DATA["diameters"]), LMAP_T,
            LossConfig(loss="dice", **cfg_kw),
            class_weights=None if cw is None else _t(cw))
        grads = torch.autograd.grad(losses["overall"], xs)
        return ({k: v.detach().numpy() for k, v in losses.items()},
                [g.float().numpy() for g in grads])
    m = {k: _j(DATA[k], dtype) for k in keys}

    def f(xs):
        losses = jdisp.calculate_loss(
            {"segmentation": list(xs) if heads > 1 else xs[0]}, m["label"],
            m["unk"] if unk else None, m["segment_mask"],
            jnp.asarray(DATA["volumes"]), jnp.asarray(DATA["diameters"]),
            LMAP_J, jdisp.LossConfig(loss="dice", **cfg_kw),
            class_weights=None if cw is None else jnp.asarray(cw))
        return losses["overall"], losses

    xs = tuple(_j(DATA[n], dtype) for n in names)
    (_, losses), grads = jax.value_and_grad(f, has_aux=True)(xs)
    return ({k: np.asarray(v) for k, v in losses.items()},
            [np.asarray(g, np.float32) for g in grads])


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calculate_loss_dice_matches_jax(dtype, heads, weights):
    got, g = _calc("torch", dtype, heads, weights, True, {})
    ref, rg = _calc("jax", dtype, heads, weights, True, {})
    assert sorted(got) == sorted(ref) == ["dice_volume_loss", "overall",
                                          "segmentation"]
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ()
        _check_value(got[k], ref[k], dtype, k)
    assert ref["dice_volume_loss"] > 0
    for i in range(heads):
        _check_grad(g[i], rg[i], dtype, f"head {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calculate_loss_without_unk_and_report_matches_jax(dtype):
    """No unknown voxels (known = 1 everywhere) and the report loss off; a
    non-default seg weight and aux weights."""
    kw = dict(report_volume_loss_basic=0.0, seg_loss=0.7,
              aux_weight=(0.8, 0.2))
    got, g = _calc("torch", dtype, 2, False, False, kw)
    ref, rg = _calc("jax", dtype, 2, False, False, kw)
    assert sorted(got) == sorted(ref) == ["overall", "segmentation"]
    for k in ref:
        _check_value(got[k], ref[k], dtype, k)
    for i in range(2):
        _check_grad(g[i], rg[i], dtype, f"head {i}")


def test_loss_config_matches_jax_defaults():
    a, b = LossConfig(), jdisp.LossConfig()
    assert {f: getattr(a, f) for f in a.__dataclass_fields__} == \
        {f: getattr(b, f) for f in b.__dataclass_fields__}
    assert tuple(a.ball_config()) == tuple(b.ball_config())
    assert BallLossConfig._fields == jball.BallLossConfig._fields
    assert tuple(BallLossConfig()) == tuple(jball.BallLossConfig())
    for loss in ("dice", "ball_dice_last", "ball_dice", "dynamic", "both"):
        for j in (0, 1):
            cfg = LossConfig(loss=loss)
            assert dispatcher._head_uses_ball(cfg, j) == \
                jdisp._head_uses_ball(jdisp.LossConfig(loss=loss), j)


@pytest.mark.parametrize("loss", ["ball_dice_last", "ball_dice", "ball",
                                  "dynamic_dice", "dll"])
def test_ball_routes_raise(loss):
    x = _t(DATA["logits"])
    args = (_t(DATA["label"]), _t(DATA["unk"]), _t(DATA["segment_mask"]),
            _t(DATA["volumes"]), _t(DATA["diameters"]), LMAP_T)
    with pytest.raises(NotImplementedError, match="Ball Loss"):
        calculate_loss({"segmentation": [x, x]}, *args, LossConfig(loss=loss))
    with pytest.raises(NotImplementedError, match="Ball Loss"):
        ball_loss(x, *args)


@pytest.mark.parametrize("mode", ["model_genesis", "clip_only",
                                  "classification_branch"])
def test_unported_modes_raise(mode):
    x = _t(DATA["logits"])
    args = (_t(DATA["label"]), _t(DATA["unk"]), _t(DATA["segment_mask"]),
            _t(DATA["volumes"]), _t(DATA["diameters"]), LMAP_T)
    cfg = LossConfig(loss="dice",
                     classification_branch=mode == "classification_branch")
    kw = {} if mode == "classification_branch" else {mode: True}
    with pytest.raises(NotImplementedError, match=mode):
        calculate_loss({"segmentation": x}, *args, cfg, **kw)
