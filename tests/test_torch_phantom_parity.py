"""The phantom study's two arms on the port against the JAX tool's, with
only the arithmetic differing (ROADMAP.md §3, the phantom study's gain).

Both arms as ``train_variant`` builds them in either tool
(``rsuper_tpu_torch/phantom_benchmark.py``, ``tools/phantom_benchmark.py``):
a float32 ResUNet, base 8, at 32³ × 4, ``ball_dice_last``, the report
weight 0 (mask-only) or 0.1 (the Ball Loss running). The port's loop starts
from the JAX loop's initial parameters (``PRNGKey(seed)``, moved across by
``load_flax_params``) and replays the JAX loop's augmentation draws
(``tests/test_torch_loop.py:_jax_draws``); three steps of each loop on the
same phantoms. Held:

* at every step, the port's losses on its batch from the parameters the
  JAX loop had at that step, within ``LOSS_TOL`` of the JAX step's (the
  batches are the same records and draws, so only the arithmetic of the
  step differs); the first step's free-running losses too;
* the parameters after the three free-running steps, at ``_check_params``'
  bounds.

The free-running losses of the later steps are not held at ``LOSS_TOL``:
from the second update on they part by up to 1.4e-3 (mask-only, third step)
and 3.9e-4 (report arm). That is float32 rounding, amplified: with the
instance norm taken in float64 in both packages the two models' gradients
agree to 3.3e-8, while in float32 each is 1.4 % (JAX) and 3.7 % (port)
from that float64 gradient, and Adam's sign-like first steps turn those
gradients into updates that differ on the elements whose sign the rounding
flips (``ROADMAP.md`` §3, "Not faults of the port").
"""

import shutil

import jax
import jax.numpy as jnp
import pytest

from rsuper_tpu.models import get_model as jget_model
from rsuper_tpu.train import loop as jloop
from rsuper_tpu_torch import phantom_benchmark as pb
from rsuper_tpu_torch.models import load_flax_params
from rsuper_tpu_torch.train import loop
from rsuper_tpu_torch.train import step as tstep
from test_torch_loop import LOSS_TOL, _check_params, _flat, _jax_draws
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_phantom import SMALL, SMALL_SIZE, jtool

STEPS = 3


@pytest.fixture(scope="module")
def phantoms(tmp_path_factory):
    """Seed 0's small study (as ``tests/test_torch_phantom.py`` writes it)
    and the JAX loop's initial parameters of the phantom model, flat."""
    root = tmp_path_factory.mktemp("phantom_parity")
    size, pb.SIZE = pb.SIZE, SMALL_SIZE
    try:
        pb.generate(str(root / "data"), **SMALL, seed=0)
    finally:
        pb.SIZE = size
    cfg = pb.variant_config(str(root), True, STEPS)
    model = jget_model(cfg.arch, len(pb.MASK_CLASSES), dict(cfg.model_args),
                       dtype=jnp.float32)
    init = jloop.init_params_on_host(
        model, jax.random.PRNGKey(cfg.seed),
        jnp.zeros((1, *cfg.training_size, 1), jnp.float32))
    return root, _flat(init["params"])


def _kept(monkeypatch, module, **extra):
    """Wrap `module.train` so the state it returns is kept; each call's
    model first takes the parameters `flat` where it is given, and `extra`
    maps further keyword arguments to functions of the config."""
    kept = []
    real = module.train
    flat = extra.pop("flat", None)

    def train(cfg, model, dataset, **kwargs):
        if flat is not None:
            load_flax_params(model, flat)
        more = {k: v(cfg) for k, v in extra.items()}
        state = real(cfg, model, dataset, **kwargs, **more)
        kept.append((cfg, state))
        return state

    monkeypatch.setattr(module, "train", train)
    return kept


def _jax_steps(monkeypatch):
    """Wrap the JAX loop's step: [(flat parameters before the step, the
    step's losses)]."""
    seen = []
    build = jloop.build_train_step

    def wrapped(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, batch):
            before = _flat(jax.device_get(state.params["params"]))
            state, losses = step(state, batch)
            seen.append((before, {k: float(v) for k, v in losses.items()}))
            return state, losses

        return recorded

    monkeypatch.setattr(jloop, "build_train_step", wrapped)
    return seen


def _port_steps(monkeypatch, jax_steps):
    """Wrap the port loop's step: before step i, the losses of the model at
    the JAX loop's parameters of step i on the step's batch (the model's
    own parameters restored after); [(those losses, the step's losses)]."""
    seen = []
    build = loop.build_train_step

    def wrapped(lmap, cfg, *args, **kwargs):
        step = build(lmap, cfg, *args, **kwargs)

        def recorded(state, batch):
            model = state.model
            own = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
            load_flax_params(model, jax_steps[len(seen)][0])
            forced = tstep.gradients(model, batch, lmap, cfg)
            model.load_state_dict(own)
            for p in model.parameters():
                p.grad = None
            state, losses = step(state, batch)
            seen.append(tuple({k: float(v) for k, v in d.items()}
                              for d in (forced, losses)))
            return state, losses

        return recorded

    monkeypatch.setattr(loop, "build_train_step", wrapped)
    return seen


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_TOL * abs(v), (what, k, got[k], v)


@pytest.mark.parametrize("with_reports", [False, True],
                         ids=["mask_only", "report"])
def test_phantom_arm_matches_the_jax_loop(phantoms, tmp_path, monkeypatch,
                                          with_reports):
    root, flat0 = phantoms
    for name in ("jax", "port"):  # each loop writes its own checkpoints
        shutil.copytree(root / "data", tmp_path / name)

    jsteps = _jax_steps(monkeypatch)
    jkept = _kept(monkeypatch, jloop)
    jtool.train_variant(str(tmp_path / "jax"), with_reports, STEPS)

    steps = _port_steps(monkeypatch, jsteps)
    kept = _kept(monkeypatch, loop, flat=flat0, draws=_jax_draws)
    pb.train_variant(str(tmp_path / "port"), with_reports, STEPS,
                     device="cpu")

    (cfg, state), (_, jstate) = kept[0], jkept[0]
    assert cfg.report_volume_loss_basic == (0.1 if with_reports else 0.0)
    assert state.step == int(jstate.step) == STEPS
    assert len(steps) == len(jsteps) == STEPS
    for i, ((forced, _), (_, want)) in enumerate(zip(steps, jsteps)):
        assert ("ball_loss_bce" in want) == with_reports
        _close(forced, want, f"step {i + 1} from the JAX parameters")
    _close(steps[0][1], jsteps[0][1], "step 1")
    _check_params(state, jstate, flat0, cfg, steps=STEPS)

