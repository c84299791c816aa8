"""The port's seeded parameters against flax's own ``init``, leaf by leaf.

``init_params`` draws each parameter as the JAX models' initialisers do:
flax's ``lecun_normal`` for every kernel and weight (a normal truncated at
±2 of its own standard deviation, scaled to variance 1/fan_in), zeros for
biases and DANet's gates, ones for LayerNorm scales, 0.25 for PReLU slopes
and an untruncated normal(0.02) for the relative-position tables and the
position embeddings. Each case builds its JAX model with the JAX factory,
runs ``jax.jit(model.init)`` once on the CPU and carries the tree across
with ``params_from_flax``; the port's model of the same arguments is filled
by ``init_params``. Then, leaf by leaf:

* constant flax leaves (zeros, ones, 0.25) equal the port's exactly;
* every kernel, on both sides, lies within ±2/0.87962566 once multiplied by
  √fan_in, fan_in as flax's ``variance_scaling`` counts it on the flax
  kernel (all axes but the last: the receptive field times the input
  channels), carried to the port's layout through ``params_from_flax``;
* per family and case, the pooled unit-scale values (kernel·√fan_in, and
  the normal(0.02) leaves over 0.02) of the two sides have standard
  deviations within 5 standard errors and a two-sample Kolmogorov–Smirnov
  p-value above 1e-3;
* a seed gives the same bits twice, and two seeds differ.

The cases cover every name of the port's ``MODEL_REGISTRY`` at the widths
of ``tests/test_torch_zoo.py``, ``tests/test_torch_dim2.py`` and
``tests/test_torch_medformer.py`` (``TINY``, with the classification and
CLIP heads of ``tests/test_torch_clip.py``), and MedFormers with MBConv
blocks and their SE gates, and with an anisotropic ``scale`` and
``torch_port=True``. One JAX compile a case is most of the file's time.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rsuper_tpu.models import factory as jfactory
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu_torch.models import get_model, init_params, params_from_flax
from rsuper_tpu_torch.models.medformer import MedFormer
from rsuper_tpu_torch.models.params import TRUNCATED_STD
from test_torch_clip import HEADS
from test_torch_dim2 import CASES as DIM2_CASES
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_medformer import TINY
from test_torch_medformer_options import ANISO
from test_torch_medformer_options import CASES as OPTION_CASES
from test_torch_zoo import CASES as ZOO_CASES

NUM_CLASSES = 3
LECUN_MAX = 2.0 / 0.87962566  # flax's cut, in units of 1/√fan_in
NORMAL_STD = 0.02
NORMAL_LEAVES = ("rel_bias", "pos_embed", "pos")
SE_BOUND = 5.0  # standard errors between the two standard deviations
KS_ALPHA = 1e-3


def _registry(arch, args, shape):
    """A case of a registry name: (JAX model, port model factory, input)."""
    port_args = dict(args)
    if arch.endswith("_2d"):
        port_args["img_size"] = shape[1:]  # the CLI sets it so
    return (lambda: jfactory.get_model(arch, NUM_CLASSES, dict(args),
                                       dtype=jnp.float32),
            lambda: get_model(arch, NUM_CLASSES, port_args,
                              dtype=torch.float32),
            (1, *shape[1:]))


def _medformer(args, shape):
    """A MedFormer built from its class, as the options' tests build it
    (the registry keeps the default ``kernel_size`` and ``scale``)."""
    return (lambda: JaxMedFormer(NUM_CLASSES, dtype=jnp.float32, **args),
            lambda: MedFormer(NUM_CLASSES, dtype=torch.float32, **args),
            shape)


CASES = {
    **{c: _registry(arch, args, shape)
       for c, (arch, args, shape) in ZOO_CASES.items()},
    **{a: _registry(a, args, shape)
       for a, (args, shape) in DIM2_CASES.items()},
    # the heads make the extra encoder stages `cls_extra`/`clip_extra`
    "medformer_heads": _registry("medformer", {**TINY, **HEADS},
                                 (1, 32, 32, 32)),
    "mf_mbconv_se": _medformer(
        {**TINY, **OPTION_CASES["mbconv_linear_gelu"][0]},
        (1, *OPTION_CASES["mbconv_linear_gelu"][1][1:])),
    "mf_aniso_torch_port": _medformer(
        {**TINY, **OPTION_CASES["aniso_cf"][0], "torch_port": True},
        (1, *OPTION_CASES["aniso_cf"][1][1:])),
}
assert OPTION_CASES["aniso_cf"][0]["scale"] == ANISO


def _flax_init(jax_model, shape):
    """flax's ``init`` of the model on a (B, *spatial, 1) input, compiled
    once at LLVM's level 0 (as the parity tests compile): a flat
    {"a/b/kernel": array} tree."""
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(*shape, 1)).astype(np.float32))
    key = jax.random.PRNGKey(0)
    tree = jax.jit(jax_model.init).lower(key, x).compile(
        compiler_options={"xla_backend_optimization_level": 0})(key, x)
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree["params"])[0]}


def _std_se(v):
    """The population standard deviation of `v` and its standard error
    (the delta method on the second moment: no normality assumed)."""
    v = np.asarray(v, np.float64)
    m2 = np.mean(v * v)
    m4 = np.mean(v ** 4)
    return math.sqrt(m2), math.sqrt(max(m4 - m2 * m2, 0.0) / v.size) / (
        2.0 * math.sqrt(m2))


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_params_draws_as_flax_init(case):
    jax_model, port_model, shape = CASES[case]
    flat = _flax_init(jax_model(), shape)
    model = init_params(port_model(), seed=0)
    theirs = params_from_flax(flat, model)  # strict: every leaf, each once
    # flax's fan_in of each kernel (in_axis -2: all axes but the last),
    # carried to the port's layout by the same re-layout as the values
    fan_in = params_from_flax(
        {k: np.full(v.shape, math.prod(v.shape[:-1]), np.float32)
         for k, v in flat.items()}, model)
    pooled = {"lecun": ([], []), "normal": ([], [])}
    for name, p in model.named_parameters():
        ours, want = p.detach(), theirs[name]
        if float(want.min()) == float(want.max()):
            assert torch.equal(ours, want), f"{case} {name}: not constant"
            continue
        assert float(ours.min()) < float(ours.max()), f"{case} {name}"
        if name.rsplit(".", 1)[-1] in NORMAL_LEAVES:
            pooled["normal"][0].append(ours.flatten() / NORMAL_STD)
            pooled["normal"][1].append(want.flatten() / NORMAL_STD)
            continue
        assert float(fan_in[name].min()) == float(fan_in[name].max())
        scale = math.sqrt(float(fan_in[name][(0,) * fan_in[name].ndim]))
        for side, w in (("port", ours), ("flax", want)):
            top = float(w.abs().max()) * scale
            assert top <= LECUN_MAX + 1e-6, (
                f"{case} {name} ({side}): max|w|·√fan_in {top} > "
                f"{LECUN_MAX}")
        pooled["lecun"][0].append(ours.flatten() * scale)
        pooled["lecun"][1].append(want.flatten() * scale)
    assert pooled["lecun"][0], case
    for family, (ours, want) in pooled.items():
        if not ours:
            continue
        a = torch.cat(ours).double().numpy()
        b = torch.cat(want).double().numpy()
        (sa, ea), (sb, eb) = _std_se(a), _std_se(b)
        assert abs(sa - sb) <= SE_BOUND * math.hypot(ea, eb), (
            case, family, a.size, sa, sb, ea, eb)
        ks = stats.ks_2samp(a, b)
        assert ks.pvalue > KS_ALPHA, (case, family, a.size, ks)
    again = init_params(port_model(), seed=0).state_dict()
    other = init_params(port_model(), seed=1).state_dict()
    for name, v in model.state_dict().items():
        assert torch.equal(again[name], v), f"{case} {name}: not repeated"
    for name, v in model.state_dict().items():
        if float(v.min()) < float(v.max()):
            assert not torch.equal(other[name], v), f"{case} {name}: seed"


def test_truncated_std_is_the_unit_normal_cut_at_two():
    """The constant the draw divides by: the standard deviation of a unit
    normal truncated at ±2 (flax's 0.87962566103423978)."""
    assert math.isclose(TRUNCATED_STD, float(stats.truncnorm(-2, 2).std()),
                        rel_tol=1e-12)
