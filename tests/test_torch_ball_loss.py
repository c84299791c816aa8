"""The port's Ball Loss against the JAX package, on the CPU: tumour
isolation, the loss and its gradient, the dispatcher's Ball routes, and one
whole training step with ``loss="ball_dice_last"``.

The ball's centre is the argmax of an FFT convolution, and the two FFT
libraries differ in the last bits: on a flat response two voxels can swap and
every later mask moves with the ball. So the inputs here have one clear peak
per tumour (a Gaussian blob well above the background, off the grid's
symmetry axes); with the same centre the masks are integer and threshold
arithmetic and must be equal.

Tolerances:
* pseudo-masks: equal;
* ``ball_loss`` and ``calculate_loss`` values, float32: 1e-5 relative;
  gradients at the logits: max|Δ| ≤ 1e-4·max|ref| (the same formulas, the
  volume sums in another order); bfloat16 logits: values 1e-2 relative (the
  loss runs in float32 on the bf16 logits; the segmentation terms round
  elementwise to bf16 on both sides);
* the whole step at a small MedFormer, float32: loss terms 1e-4 relative, as
  ``tests/test_torch_train.py`` states it; per parameter ‖Δg‖ ≤ 6e-3·(‖g‖ +
  1e-3·max‖g‖), the form of that file's bound at three times its factor.
  The two packages' logits differ by 2e-5 relative (XLA's CPU math against
  PyTorch's), and this randomly initialised model amplifies a perturbation
  about a hundredfold on the way to the gradients: 1.5e-3 is observed with
  ``loss="dice"`` (bound 2e-3 there) and 4.6e-3 here, where the Ball Loss
  concentrates the logits' gradient on the few hundred voxels of the
  pseudo-mask. On identical logits the loss's gradient agrees to 1e-6, and
  the pseudo-masks built from either package's logits are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
from rsuper_tpu.losses import ball as jball
from rsuper_tpu.losses import dispatcher as jdisp
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.train import build_train_step as jax_build_train_step
from rsuper_tpu.train import make_optimizer as jax_make_optimizer
from rsuper_tpu.train.state import TrainState as JaxTrainState
from rsuper_tpu.train.step import loss_fn as jax_loss_fn
from rsuper_tpu_torch import bench_train
from rsuper_tpu_torch.losses import (BallLossConfig, LesionChannelMap,
                                     LossConfig, ball_loss, calculate_loss,
                                     isolate_tumor)
from rsuper_tpu_torch.losses import ball
from rsuper_tpu_torch.models import params_from_flax, train_state_from_jax
from rsuper_tpu_torch.ops import balls
from rsuper_tpu_torch.train import build_train_step, loss_fn
from tests.test_torch_loop import _one_intra_op_thread  # noqa: F401
from tests.test_torch_train import CLASSES as STEP_CLASSES
from tests.test_torch_train import (GRAD_FLOOR, OPT, TINY,
                                    _adam_state, _flat_np, _flax_params,
                                    _port_state, _unflatten)

CLASSES = ["background", "liver", "liver_lesion", "kidney_lesion",
           "pancreas", "pancreatic_lesion"]
LMAP_T = LesionChannelMap.from_classes(CLASSES)
LMAP_J = JLesionChannelMap.from_classes(CLASSES)
S = 32
STEP_GRAD_TOL = 6e-3


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _blob(shape, center, sigma, peak=0.9, floor=0.0, seed=0):
    """A Gaussian blob of height `peak` over a little seeded noise."""
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                    indexing="ij")
    d2 = sum((a - c) ** 2 for a, c in zip(g, center))
    x = peak * np.exp(-d2 / (2.0 * sigma ** 2)) + floor
    return (x + 0.01 * rng.random(shape)).astype(np.float32)


def _fallback_case():
    """Positive only in a 5³ corner of the blob: far fewer positive voxels
    in the ball than 0.7 × the reported volume, so the dilation fall-back
    runs (to its last round: the ball caps what dilation can reach)."""
    x = np.zeros((S, S, S), np.float32)
    x[13:18, 14:19, 12:17] = _blob((S, S, S), (15, 16, 14), 2.0)[13:18, 14:19,
                                                                12:17]
    return x


ISOLATE = {  # name: (x, diameter, volume, max_diameter)
    "central_blob": (_blob((S, S, S), (15, 17, 13), 4.0), 9.0, 400.0, 96),
    "central_blob_padding_64": (_blob((S, S, S), (15, 17, 13), 4.0), 9.0,
                                400.0, 64),
    "corner_clipped": (_blob((S, S, S), (1, 2, 3), 3.0), 9.0, 300.0, 96),
    "volume_raised_to_the_ball": (_blob((S, S, S), (18, 12, 16), 3.0), 11.0,
                                  50.0, 64),
    "fallback_dilation": (_fallback_case(), 8.0, 300.0, 64),
    "other_shape": (_blob((24, 36, 28), (10, 20, 9), 3.0), 7.4, 150.0, 64),
}


@pytest.mark.parametrize("case", ISOLATE)
def test_isolate_tumor_matches_jax(case):
    x, dia, vol, max_d = ISOLATE[case]
    cfg = BallLossConfig(max_diameter=max_d)
    reads = ball.host_reads()
    got = isolate_tumor(_t(x), dia, vol, cfg)
    rounds = ball.host_reads() - reads  # one read a fall-back check
    ref = jball.isolate_tumor(jnp.asarray(x), jnp.float32(dia),
                              jnp.float32(vol),
                              jball.BallLossConfig(max_diameter=max_d))
    for g, r, name in zip(got, ref, ("normal", "small", "big")):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    m, ms, mb = (g.numpy() for g in got)
    assert m.sum() > 0 and ms.sum() <= m.sum() <= mb.sum()
    if case == "fallback_dilation":  # at least one round of dilation ran
        assert rounds >= 2 and m.sum() > (x > 0).sum()
    else:
        assert rounds == 1
    if case == "corner_clipped":
        # the border clips the first rung's ball (diameter·1.2 at the blob's
        # centre) below the volume that was selected: the ball grew
        centre = tuple(torch.tensor(c) for c in (1, 2, 3))
        first = balls.ball_count_clipped(x.shape, centre, dia * 1.2)
        assert float(first) < m.sum()


def test_isolate_tumor_batched_freezes_converged_items():
    """Two items in one call, one of which runs the fall-back: each equals
    its single-item result and the JAX package's batched one."""
    names = ("central_blob_padding_64", "fallback_dilation")
    x = np.stack([ISOLATE[n][0] for n in names])
    dia = np.array([ISOLATE[n][1] for n in names], np.float32)
    vol = np.array([ISOLATE[n][2] for n in names], np.float32)
    cfg = BallLossConfig(max_diameter=64)
    got = ball.isolate_tumor_batched(_t(x), _t(dia), _t(vol), cfg)
    ref = jball.isolate_tumor_batched(jnp.asarray(x), jnp.asarray(dia),
                                      jnp.asarray(vol),
                                      jball.BallLossConfig(max_diameter=64))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for b in range(2):
        one = isolate_tumor(_t(x[b]), float(dia[b]), float(vol[b]), cfg)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


def _ball_batch(seed=0, tumors=True):
    """Item 0: two reported tumours (two blobs of logits in the pancreas
    segment, listed smaller first so the sort matters); item 1: no report."""
    C = len(CLASSES)
    rng = np.random.default_rng(seed)
    ci = CLASSES.index("pancreatic_lesion")
    logits = rng.normal(size=(2, S, S, S, C)).astype(np.float32) - 3.0
    aux = rng.normal(size=(2, S, S, S, C)).astype(np.float32) - 3.0
    for arr, scale in ((logits, 9.0), (aux, 8.0)):
        arr[0, ..., ci] += scale * _blob((S, S, S), (13, 15, 12), 3.5, 1.0)
        arr[0, ..., ci] += scale * _blob((S, S, S), (22, 21, 23), 2.0, 0.8,
                                         seed=1)
    label = np.zeros((2, S, S, S, C), np.float32)
    label[1, 4:14, 6:20, 10:28, CLASSES.index("liver")] = 1.0
    seg = np.zeros((2, S, S, S, C), np.float32)
    vols = np.zeros((2, 4), np.float32)
    dias = np.zeros((2, 4, 3), np.float32)
    if tumors:
        seg[0, 8:28, 8:28, 6:28, ci] = 1.0
        vols[0, :2] = [60.0, 350.0]
        dias[0, 0] = [4.0, 5.0, 3.0]
        dias[0, 1] = [9.0, 8.0, 7.0]
    cw = (0.5 + rng.random((2, C))).astype(np.float32)
    return dict(logits=logits, aux=aux, label=label, unk=seg.copy(),
                segment_mask=seg, volumes=vols, diameters=dias,
                class_weights=cw)


def _check(got, ref, rtol, what):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= rtol * abs(ref) + 1e-8, f"{what}: {got} vs {ref}"


def _check_grad(got, ref, rtol, what):
    ref = np.asarray(ref, np.float32)
    mx = float(np.abs(ref).max())
    assert mx > 0, f"{what}: the reference gradient is zero"
    err = float(np.abs(np.asarray(got, np.float32) - ref).max())
    assert err <= rtol * mx, f"{what}: {err} vs max {mx}"


@pytest.mark.parametrize("variant", ["default", "dice_and_weights",
                                     "standard_ce", "no_gwrp_normal_mask",
                                     "no_report_in_the_batch"])
def test_ball_loss_matches_jax(variant):
    d = _ball_batch(tumors=variant != "no_report_in_the_batch")
    kw = {"default": {}, "no_report_in_the_batch": dict(apply_dice_loss=True),
          "dice_and_weights": dict(apply_dice_loss=True),
          "standard_ce": dict(standard_ce=True, apply_dice_loss=True),
          "no_gwrp_normal_mask": dict(gwrp=False, use_small_pseudo_mask=False,
                                      dilation_for_background=0)}[variant]
    kw["max_diameter"] = 64
    cw = d["class_weights"] if variant == "dice_and_weights" else None
    keys = ("label", "unk", "segment_mask", "volumes", "diameters")

    def total(out):
        return out["ball_loss_bce"] + 0.5 * out["ball_loss_dice"]

    x = _t(d["logits"]).requires_grad_()
    reads = ball.host_reads()
    out = ball_loss(x, *(_t(d[k]) for k in keys), LMAP_T,
                    BallLossConfig(**kw),
                    class_weights=None if cw is None else _t(cw))
    reads = ball.host_reads() - reads
    (g,) = torch.autograd.grad(total(out), x)

    def f(xx):
        o = jball.ball_loss(xx, *(jnp.asarray(d[k]) for k in keys), LMAP_J,
                            jball.BallLossConfig(**kw),
                            class_weights=None if cw is None
                            else jnp.asarray(cw))
        return total(o), o

    (_, ref), rg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(d["logits"]))
    assert sorted(out) == sorted(ref) == ["ball_loss_bce", "ball_loss_dice"]
    for k in ref:
        assert out[k].dtype == torch.float32 and out[k].shape == ()
        _check(out[k].detach(), ref[k], 1e-5, f"{variant} {k}")
    assert float(ref["ball_loss_bce"]) > 0
    _check_grad(g.numpy(), rg, 1e-4, variant)
    if variant == "no_report_in_the_batch":
        assert reads == 1  # which branches the batch needs, nothing else
    else:  # + the live slots, + one fall-back check a slot at least
        assert reads >= 1 + 1 + 2
        # only the active lesion channel and, for the item without a report,
        # the lesion channels carry a gradient
        lesion = [i for i, c in enumerate(CLASSES) if "lesion" in c]
        other = [i for i in range(len(CLASSES)) if i not in lesion]
        assert not g[..., other].any() and g[0, ..., lesion[-1]].any()


def test_ball_loss_builds_its_own_masks_and_takes_bf16():
    d = _ball_batch()
    keys = ("label", "unk", "segment_mask", "volumes", "diameters")
    cfg = BallLossConfig(max_diameter=64, apply_dice_loss=True)
    args = [_t(d[k]) for k in keys]
    pre = ball.lesion_masks_cf(*args[:3], LMAP_T)
    a = ball_loss(_t(d["logits"]), *args, LMAP_T, cfg)
    b = ball_loss(_t(d["logits"]), *args, LMAP_T, cfg, precomputed=pre)
    for k in a:
        assert torch.equal(a[k], b[k])
    x16 = _t(d["logits"], torch.bfloat16)
    got = ball_loss(x16, *(t.to(torch.bfloat16) if t.dim() == 5 else t
                           for t in args), LMAP_T, cfg)
    ref = jball.ball_loss(
        jnp.asarray(d["logits"]).astype(jnp.bfloat16),
        *(jnp.asarray(d[k]).astype(jnp.bfloat16) if d[k].ndim == 5
          else jnp.asarray(d[k]) for k in keys), LMAP_J,
        jball.BallLossConfig(max_diameter=64, apply_dice_loss=True))
    for k in ref:
        assert got[k].dtype == torch.float32
        _check(got[k], ref[k], 1e-2, f"bf16 {k}")


def _calc(side, d, loss, heads, cfg_kw, weights):
    names = ["logits", "aux"][:heads]
    keys = ("label", "unk", "segment_mask", "volumes", "diameters")
    cw = d["class_weights"] if weights else None
    if side == "torch":
        xs = [_t(d[n]).requires_grad_() for n in names]
        losses = calculate_loss(
            {"segmentation": xs if heads > 1 else xs[0]},
            *(_t(d[k]) for k in keys), LMAP_T, LossConfig(loss=loss, **cfg_kw),
            class_weights=None if cw is None else _t(cw))
        grads = torch.autograd.grad(losses["overall"], xs)
        return ({k: float(v.detach()) for k, v in losses.items()},
                [g.numpy() for g in grads])

    def f(xs):
        losses = jdisp.calculate_loss(
            {"segmentation": list(xs) if heads > 1 else xs[0]},
            *(jnp.asarray(d[k]) for k in keys), LMAP_J,
            jdisp.LossConfig(loss=loss, **cfg_kw),
            class_weights=None if cw is None else jnp.asarray(cw))
        return losses["overall"], losses

    xs = tuple(jnp.asarray(d[n]) for n in names)
    (_, losses), grads = jax.value_and_grad(f, has_aux=True)(xs)
    return ({k: float(v) for k, v in losses.items()},
            [np.asarray(g) for g in grads])


_BALL = {"ball_loss_bce", "ball_loss_dice"}
ROUTES = {  # loss: the terms beside 'segmentation' and 'overall'
    "ball_dice_last": _BALL | {"dice_volume_loss"},  # head 1: Volume Loss
    "ball_dice": _BALL,
    "ball_both_dice": _BALL | {"dice_volume_loss"},  # both on both heads
    "ball": _BALL,
    "dynamic_dice": _BALL,
    "dll": _BALL,
}


@pytest.mark.parametrize("loss", ROUTES)
def test_ball_routes_match_jax(loss):
    """Every loss string that routes a head to the Ball Loss: the terms, the
    weights and the gradient at both heads, with non-default weights."""
    d = _ball_batch()
    kw = dict(ball_bce_weight=0.7, ball_dice_weight=0.3,
              report_volume_loss_basic=0.5, aux_weight=(0.6, 0.4))
    got, g = _calc("torch", d, loss, 2, kw, weights=True)
    ref, rg = _calc("jax", d, loss, 2, kw, weights=True)
    terms = ROUTES[loss]
    assert set(got) == set(ref) == terms | {"segmentation", "overall"}
    for k in ref:
        _check(got[k], ref[k], 1e-5, f"{loss} {k}")
    assert got["ball_loss_bce"] > 0
    assert (got["ball_loss_dice"] > 0) == ("dice" in loss)
    for j in range(2):
        _check_grad(g[j], rg[j], 1e-4, f"{loss} head {j}")
    _check(got["overall"], sum(v for k, v in got.items() if k != "overall"),
           1e-6, "overall is the sum of the terms")


def test_ball_weights_scale_their_terms():
    d = _ball_batch()
    base, _ = _calc("torch", d, "ball_dice_last", 2, {}, weights=False)
    half, _ = _calc("torch", d, "ball_dice_last", 2,
                    dict(ball_bce_weight=0.5, ball_dice_weight=2.0),
                    weights=False)
    _check(half["ball_loss_bce"], 0.5 * base["ball_loss_bce"], 1e-6, "bce")
    _check(half["ball_loss_dice"], 2.0 * base["ball_loss_dice"], 1e-6, "dice")
    one, _ = _calc("torch", d, "ball_dice_last", 1, {}, weights=False)
    # a single head has weight 1 and is head 0: Ball Loss, no Volume Loss
    assert "dice_volume_loss" not in one
    _check(one["ball_loss_bce"], 2.0 * base["ball_loss_bce"], 1e-6, "head 0")
    off, _ = _calc("torch", d, "ball_dice_last", 2,
                   dict(report_volume_loss_basic=0.0), weights=False)
    assert sorted(off) == ["overall", "segmentation"]


# ---------------------------------------------------------- the whole step
def _step_batch():
    rng = np.random.default_rng(0)
    C = len(STEP_CLASSES)
    seg = np.zeros((1, S, S, S, C), np.float32)
    seg[0, 8:24, 8:24, 8:24, STEP_CLASSES.index("pancreatic_lesion")] = 1.0
    lab = np.zeros_like(seg)
    lab[0, 4:14, 6:20, 10:28, STEP_CLASSES.index("liver")] = 1.0
    vols = np.zeros((1, 10), np.float32)
    vols[0, :2] = [500.0, 120.0]
    dias = np.zeros((1, 10, 3), np.float32)
    dias[0, 0] = [10.0, 9.0, 8.0]
    dias[0, 1] = [6.0, 6.0, 5.0]
    return {
        "image": rng.normal(size=(1, S, S, S, 1)).astype(np.float32),
        "label": lab, "unk": seg.copy(), "segment_mask": seg,
        "volumes": vols, "diameters": dias,
    }


@pytest.fixture(scope="module")
def ref_step():
    """JAX side: losses and gradients at the start, then two steps of
    build_train_step with the default LossConfig (ball_dice_last)."""
    batch = _step_batch()
    model = JaxMedFormer(len(STEP_CLASSES), dtype=jnp.float32, remat=False,
                         **TINY)
    flat = _flax_params(model, batch["image"])
    params = {"params": _unflatten(flat)}
    lmap = JLesionChannelMap.from_classes(STEP_CLASSES)
    cfg = jdisp.LossConfig()
    assert cfg.loss == "ball_dice_last"
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, losses0), grads = jax.jit(
        jax.value_and_grad(jax_loss_fn, has_aux=True),
        static_argnums=(1, 3, 4))(params, model, jbatch, lmap, cfg)
    tx = jax_make_optimizer(**OPT)
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          ema_params=jax.tree.map(jnp.copy, params),
                          step=jnp.zeros((), jnp.int32), tx=tx)
    step = jax_build_train_step(model, lmap, cfg)
    state, out1 = step(state, jbatch)
    adam = _adam_state(state.opt_state)
    after1 = dict(params=_flat_np(state.params["params"]),
                  ema=_flat_np(state.ema_params["params"]),
                  mu=_flat_np(adam.mu["params"]),
                  nu=_flat_np(adam.nu["params"]),
                  count=int(adam.count), step=int(state.step))
    state, out2 = step(state, jbatch)
    return dict(batch=batch, flat=flat, grads=_flat_np(grads["params"]),
                losses0={k: float(v) for k, v in losses0.items()},
                losses1={k: float(v) for k, v in out1.items()},
                losses2={k: float(v) for k, v in out2.items()},
                after1=after1)


STEP_LMAP = LesionChannelMap.from_classes(STEP_CLASSES)


def test_ball_dice_last_step_gradients_match_jax(ref_step):
    state = _port_state(ref_step["flat"])
    batch = {k: _t(v) for k, v in ref_step["batch"].items()}
    state.model.zero_grad(set_to_none=True)
    overall, losses = loss_fn(state.model, batch, STEP_LMAP, LossConfig())
    overall.backward()
    assert set(losses) == set(ref_step["losses0"]) == {
        "ball_loss_bce", "ball_loss_dice", "dice_volume_loss", "segmentation",
        "overall"}
    for k, v in ref_step["losses0"].items():
        _check(losses[k].detach(), v, 1e-4, k)
    assert ref_step["losses0"]["ball_loss_bce"] > 0
    assert ref_step["losses0"]["ball_loss_dice"] > 0
    want = params_from_flax(ref_step["grads"], state.model)
    top = max(float(w.norm()) for w in want.values())
    for k, p in state.model.named_parameters():
        err = float((p.grad - want[k]).norm())
        bound = STEP_GRAD_TOL * (float(want[k].norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{k}: ‖Δ‖ {err} > {bound}"


def test_ball_dice_last_step_carries_over_from_jax(ref_step):
    """The port's first step gives JAX's first losses; from JAX's state
    after that step (``train_state_from_jax``) the port's next step gives
    JAX's second losses."""
    batch = {k: _t(v) for k, v in ref_step["batch"].items()}
    step = build_train_step(STEP_LMAP)  # the default LossConfig
    state = _port_state(ref_step["flat"])
    state, losses = step(state, batch)
    for k, v in ref_step["losses1"].items():
        _check(losses[k], v, 1e-4, f"step 1 {k}")
    a = ref_step["after1"]
    state = _port_state(ref_step["flat"])
    train_state_from_jax(state, a["params"], a["ema"], a["mu"], a["nu"],
                         a["count"], a["step"])
    state, losses = step(state, batch)
    assert state.step == 2
    for k, v in ref_step["losses2"].items():
        _check(losses[k], v, 1e-4, f"step 2 {k}")


@pytest.mark.parametrize("loss,suffix", [(None, ""), ("dice", "_dice")])
def test_bench_train_metric_follows_the_loss(capsys, loss, suffix):
    import json

    argv = ["--device", "cpu", "--size", "32", "--steps", "2"]
    out = bench_train.main(argv + (["--loss", loss] if loss else []),
                           model_args=TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == f"train_patches_per_sec_per_cpu_32{suffix}"
    assert line["loss"] == (loss or "ball_dice_last") == out["loss"]
    assert np.isfinite(line["loss_first"]) and np.isfinite(line["loss_last"])
