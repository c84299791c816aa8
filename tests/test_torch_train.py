"""The PyTorch port's training step against the JAX package, on the CPU.

One small MedFormer (the widths of ``tests/test_torch_medformer.py``, every
block kind of the default model, float32, ``remat`` off) and one 32³ batch
made with numpy go through ``rsuper_tpu.train.build_train_step`` and through
the port's, from the same parameters (``params_from_flax``). One
module-scoped fixture holds the JAX results; its two jitted graphs are the
file's whole compile cost.

Tolerances:
* optimizer on GIVEN gradients against optax, 3 updates: parameters and EMA
  max|Δ| ≤ 1e-6·(1 + max|ref|) (the same float32 formulas);
* gradients of the whole step, float32 on both sides: per parameter
  ‖Δ‖ ≤ 2e-3·(‖ref‖ + 1e-3·max over parameters of ‖ref‖) — sums in another
  order through forward and backward; the second term gives a scale to
  gradients that are zero but for rounding (a bias in front of a norm);
* loss of 3 consecutive steps: |Δ| ≤ 1e-4·|ref| at the first step (before
  any update) and ≤ 2e-3·|ref| after updates. Adam's first updates are
  lr·g/(|g| + eps): where |g| is near eps a rounding-sized gradient
  difference changes the update by a fraction of lr, so the parameters after
  whole steps are held in units of the learning rate: max|Δp| ≤ 2·lr per
  step taken and mean|Δp| ≤ 0.2·lr after 3 steps (0.07·lr observed).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
from rsuper_tpu.losses import LossConfig as JLossConfig
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.train import build_train_step as jax_build_train_step
from rsuper_tpu.train import make_optimizer as jax_make_optimizer
from rsuper_tpu.train.state import TrainState as JaxTrainState
from rsuper_tpu.train.step import loss_fn as jax_loss_fn
from rsuper_tpu_torch import bench_train
from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                     load_flax_params, params_from_flax,
                                     train_state_from_jax)
from rsuper_tpu_torch.train import (build_eval_step, build_train_step,
                                    create_train_state, loss_fn,
                                    make_optimizer, warmup_poly_schedule)
from rsuper_tpu_torch.train.optim import clip_by_global_norm

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
CLASSES = ["background", "liver", "liver_lesion", "pancreatic_lesion"]
SIZE, LR = 32, 6e-4
OPT = dict(base_lr=LR, warmup_epochs=0, max_epochs=100, steps_per_epoch=1000)
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-3


def _batch():
    rng = np.random.default_rng(0)
    C = len(CLASSES)
    seg = np.zeros((1, SIZE, SIZE, SIZE, C), np.float32)
    seg[0, 8:24, 8:24, 8:24, CLASSES.index("pancreatic_lesion")] = 1.0
    lab = np.zeros_like(seg)
    lab[0, 4:14, 6:20, 10:28, CLASSES.index("liver")] = 1.0
    vols = np.zeros((1, 10), np.float32)
    vols[0, :2] = [900.0, 300.0]  # outside the Volume Loss's dead zone
    return {
        "image": rng.normal(size=(1, SIZE, SIZE, SIZE, 1)).astype(np.float32),
        "label": lab, "unk": seg.copy(), "segment_mask": seg,
        "volumes": vols, "diameters": np.zeros((1, 10, 3), np.float32),
    }


def _flax_params(module, x, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        if key.endswith("bias"):
            a = rng.normal(size=leaf.shape) * 0.1
        elif key.endswith("scale"):
            a = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            a = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        flat[key] = a.astype(np.float32)
    return flat


def _unflatten(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _flat_np(tree):
    from flax.traverse_util import flatten_dict

    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return adam


@pytest.fixture(scope="module")
def ref():
    """JAX side: gradients at the start, then 3 steps of build_train_step;
    the state after the first step is kept for the carry-over test."""
    batch = _batch()
    model = JaxMedFormer(len(CLASSES), dtype=jnp.float32, remat=False, **TINY)
    flat = _flax_params(model, batch["image"])
    params = {"params": _unflatten(flat)}
    lmap = JLesionChannelMap.from_classes(CLASSES)
    cfg = JLossConfig(loss="dice")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, losses0), grads = jax.jit(
        jax.value_and_grad(jax_loss_fn, has_aux=True),
        static_argnums=(1, 3, 4))(params, model, jbatch, lmap, cfg)
    tx = jax_make_optimizer(**OPT)
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          ema_params=jax.tree.map(jnp.copy, params),
                          step=jnp.zeros((), jnp.int32), tx=tx)
    step = jax_build_train_step(model, lmap, cfg)
    losses, after1 = [], None
    for i in range(3):
        state, out = step(state, jbatch)
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            adam = _adam_state(state.opt_state)
            after1 = dict(params=_flat_np(state.params["params"]),
                          ema=_flat_np(state.ema_params["params"]),
                          mu=_flat_np(adam.mu["params"]),
                          nu=_flat_np(adam.nu["params"]),
                          count=int(adam.count), step=int(state.step))
    return dict(batch=batch, flat=flat,
                grads=_flat_np(grads["params"]),
                losses0={k: float(v) for k, v in losses0.items()},
                losses=losses, after1=after1,
                final=_flat_np(state.params["params"]))


def _port_state(flat, remat=False):
    model = get_model("medformer", len(CLASSES), {**TINY, "remat": remat},
                      dtype=torch.float32)
    load_flax_params(model, flat).train()
    return create_train_state(model, make_optimizer(model.parameters(), **OPT))


def _tbatch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


LMAP = LesionChannelMap.from_classes(CLASSES)
CFG = LossConfig(loss="dice")


def _port_grads(state, batch):
    state.model.zero_grad(set_to_none=True)
    overall, losses = loss_fn(state.model, batch, LMAP, CFG)
    overall.backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: p.grad.clone() for k, p in state.model.named_parameters()})


def test_step_gradients_match_jax(ref):
    state = _port_state(ref["flat"])
    losses, grads = _port_grads(state, _tbatch(ref["batch"]))
    for k, v in ref["losses0"].items():
        assert abs(losses[k] - v) <= 1e-4 * abs(v), (k, losses[k], v)
    # the JAX gradient tree crosses over by the parameters' own re-layout
    want = params_from_flax(ref["grads"], state.model)
    assert sorted(want) == sorted(grads)
    top = max(float(w.norm()) for w in want.values())
    assert top > 0
    for k, w in want.items():
        assert grads[k].dtype == torch.float32
        err = float((grads[k] - w).norm())
        bound = GRAD_TOL * (float(w.norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{k}: ‖Δ‖ {err} > {bound}"


def test_three_steps_match_build_train_step(ref):
    state = _port_state(ref["flat"])
    step = build_train_step(LMAP, CFG)
    batch = _tbatch(ref["batch"])
    for i, want in enumerate(ref["losses"]):
        state, losses = step(state, batch)
        assert state.step == i + 1
        tol = 1e-4 if i == 0 else 2e-3
        for k, v in want.items():
            assert not losses[k].requires_grad
            assert abs(float(losses[k]) - v) <= tol * abs(v), \
                (i, k, float(losses[k]), v)
    final = params_from_flax(ref["final"], state.model)
    diffs = torch.cat([(p.detach() - final[k]).abs().flatten()
                       for k, p in state.model.named_parameters()])
    assert float(diffs.max()) <= 2 * LR * 3
    assert float(diffs.mean()) <= 0.2 * LR
    # the parameters did move, by about lr a step
    start = params_from_flax(ref["flat"], state.model)
    moved = torch.cat([(p.detach() - start[k]).abs().flatten()
                       for k, p in state.model.named_parameters()])
    assert float(moved.mean()) > 0.5 * LR


def test_train_state_from_jax_carries_the_next_step(ref):
    """Parameters, EMA, Adam moments and counters after JAX's first step are
    carried over; the port's next step then gives JAX's second loss and
    JAX's step counters."""
    a = ref["after1"]
    state = _port_state(ref["flat"])
    train_state_from_jax(state, a["params"], a["ema"], a["mu"], a["nu"],
                         a["count"], a["step"])
    assert state.step == 1
    opt = state.optimizer.opt
    name_of = {p: k for k, p in state.model.named_parameters()}
    mu = params_from_flax(a["mu"], state.model)
    for p, st in opt.state.items():
        assert float(st["step"]) == 1.0
        torch.testing.assert_close(st["exp_avg"], mu[name_of[p]])
    ema = params_from_flax(a["ema"], state.model)
    for k, v in state.ema_params.items():
        torch.testing.assert_close(v, ema[k])
    state, losses = build_train_step(LMAP, CFG)(state, _tbatch(ref["batch"]))
    assert state.step == 2
    for k, v in ref["losses"][1].items():
        assert abs(float(losses[k]) - v) <= 1e-4 * abs(v), (k, v)


def test_remat_on_equals_off(ref):
    batch = _tbatch(ref["batch"])
    off = _port_grads(_port_state(ref["flat"], remat=False), batch)
    on_state = _port_state(ref["flat"], remat=True)
    assert sorted(dict(on_state.model.named_parameters())) == sorted(off[1])
    on = _port_grads(on_state, batch)
    assert on[0] == off[0]
    for k in off[1]:
        torch.testing.assert_close(on[1][k], off[1][k], rtol=1e-5, atol=1e-7)


def test_eval_step_uses_the_ema_copy(ref):
    state = _port_state(ref["flat"])
    image = torch.from_numpy(ref["batch"]["image"].copy())
    p0 = build_eval_step()(state, image)
    assert tuple(p0.shape) == (1, SIZE, SIZE, SIZE, len(CLASSES))
    assert 0.0 <= float(p0.min()) and float(p0.max()) <= 1.0
    torch.testing.assert_close(build_eval_step(use_ema=True)(state, image), p0)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.05)
    assert not torch.allclose(build_eval_step()(state, image), p0)
    torch.testing.assert_close(build_eval_step(use_ema=True)(state, image), p0)


def test_flax_round_trips(ref):
    model = get_model("medformer", len(CLASSES), dict(TINY))
    sd = params_from_flax(ref["flat"], model)
    back = flax_from_state_dict(sd)
    assert sorted(back) == sorted(ref["flat"])
    for k, v in ref["flat"].items():
        np.testing.assert_array_equal(back[k], v)
    again = params_from_flax(back, model)
    for k in sd:
        assert torch.equal(again[k], sd[k])
    # a gradient tree is re-laid-out like the parameters
    g = params_from_flax(ref["grads"], model)
    assert {k: tuple(v.shape) for k, v in g.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    # under remat flax prefixes the rematerialised blocks
    rem = flax_from_state_dict(sd, remat=True)
    jm = JaxMedFormer(len(CLASSES), dtype=jnp.float32, remat=True, **TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(ref["batch"]["image"]))["params"]
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: v.shape for k, v in rem.items()} == want


# ------------------------------------------------ optimizer on given grads
SHAPES = {"a/kernel": (3, 4), "a/bias": (4,), "b/scale": (5,)}


def _given(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax_on_given_gradients(name, scale, clip):
    """3 updates across an epoch boundary of the schedule (2 steps an epoch,
    1 warm-up epoch), gradients below and above the clip norm, EMA ramp."""
    kw = dict(name=name, base_lr=1e-2, warmup_epochs=1, max_epochs=4,
              steps_per_epoch=2, clip_norm=clip)
    p0 = _given(0, 1.0)
    tx = jax_make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = JaxTrainState(params=jp, opt_state=tx.init(jp),
                           ema_params=jax.tree.map(jnp.copy, jp),
                           step=jnp.zeros((), jnp.int32), tx=tx)
    params = torch.nn.ParameterDict(
        {k.replace("/", "_"): torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    state = create_train_state(params, make_optimizer(params.parameters(),
                                                      **kw))
    for i in range(3):
        g = _given(10 + i, scale)
        jstate = jstate.apply_gradients(
            {k: jnp.asarray(v) for k, v in g.items()}, ema_alpha=0.6)
        for k, v in g.items():
            params[k.replace("/", "_")].grad = torch.from_numpy(v.copy())
        state.apply_gradients(ema_alpha=0.6)
        assert state.step == int(jstate.step) == i + 1
        for k in p0:
            for got, want in ((params[k.replace("/", "_")],
                               jstate.params[k]),
                              (state.ema_params[k.replace("/", "_")],
                               jstate.ema_params[k])):
                want = np.asarray(want)
                err = np.abs(got.detach().numpy() - want).max()
                assert err <= 1e-6 * (1 + np.abs(want).max()), (i, k, err)
    moved = np.abs(params["a_kernel"].detach().numpy() - p0["a/kernel"]).max()
    assert moved > 0


@pytest.mark.parametrize("warmup", [0, 2])
def test_schedule_matches_jax(warmup):
    from rsuper_tpu.train.optim import warmup_poly_schedule as jsched

    a = warmup_poly_schedule(6e-4, warmup, 5, 3)
    b = jsched(6e-4, warmup, 5, 3)
    for step in range(0, 20):
        np.testing.assert_allclose(a(step), float(b(jnp.asarray(step))),
                                   rtol=1e-5, atol=1e-12)
    assert a(15) == 0.0


def test_clip_follows_optax_not_torch():
    g = [torch.full((4,), 3.0), torch.full((9,), -4.0)]
    norm = float(torch.cat(g).norm())
    got = clip_by_global_norm([t.clone() for t in g], 100.0)
    assert abs(float(got) - norm) < 1e-5
    same = [t.clone() for t in g]
    clip_by_global_norm(same, 100.0)  # below the norm: untouched
    assert all(torch.equal(a, b) for a, b in zip(same, g))
    cut = [t.clone() for t in g]
    clip_by_global_norm(cut, 1.0)
    assert abs(float(torch.cat(cut).norm()) - 1.0) < 1e-6  # no 1e-6 in the denominator


def test_make_optimizer_raises_on_unknown_name():
    with pytest.raises(ValueError):
        make_optimizer([torch.nn.Parameter(torch.zeros(1))], name="lion")


def test_loss_fn_refuses_2d_input():
    with pytest.raises(NotImplementedError):
        loss_fn(None, {"image": torch.zeros(1, 8, 8, 1)}, LMAP, CFG)


def test_synthetic_batch_matches_bench_py():
    """bench_train's batch against the arrays bench.py builds (its recipe,
    repeated here with numpy from the same seed)."""
    b = bench_train.synthetic_batch(96, 1)
    C = len(bench_train.CLASSES)
    rng = np.random.default_rng(0)
    image = rng.normal(size=(1, 96, 96, 96, 1)).astype(np.float32)
    assert b["image"].dtype == torch.bfloat16
    assert torch.equal(b["image"], torch.from_numpy(image).bfloat16())
    seg = np.zeros((1, 96, 96, 96, C), np.float32)
    seg[0, 24:72, 24:72, 24:72,
        bench_train.CLASSES.index("pancreatic_lesion")] = 1.0
    for k in ("unk", "segment_mask"):
        assert torch.equal(b[k].float(), torch.from_numpy(seg))
    assert float(b["label"].float().abs().sum()) == 0.0
    assert b["volumes"][0, :2].tolist() == [4000.0, 900.0]
    assert b["diameters"][0, 1].tolist() == [12.0, 12.0, 10.0]


def test_bench_train_prints_its_line_on_the_cpu(capsys):
    out = bench_train.main(["--device", "cpu", "--size", "32", "--steps", "2"],
                           model_args=TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "train_patches_per_sec_per_cpu_32_dice"
    assert line["value"] > 0 and line["device"] == "cpu"
    assert "vs_baseline" not in line
    assert np.isfinite(line["loss_first"]) and np.isfinite(line["loss_last"])
    assert out["steps"] == 2


def test_bench_train_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_train.main(["--size", "32"])
