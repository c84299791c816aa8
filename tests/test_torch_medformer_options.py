"""Every option of the JAX MedFormer, held against the port on the CPU.

Each case is a small configuration (the TINY widths of
``tests/test_torch_medformer.py``) that reaches several options at once;
together they reach each option of the JAX ``MedFormer`` once:

* ``mbconv_linear_gelu``: MBConv conv blocks (stem and stages, with the
  conv shortcut of a width change), conv blocks beside attention in
  encoder and decoder stages, ``proj_type="linear"`` (PatchMerging's 1×1
  ``Conv_0``, 1×1 attention projections, the FusedMBConv feed-forward),
  GELU, and attention in decoder stage 7 (at a width that lets the JAX
  model build it);
* ``fused_nonorm_kernels``: FusedMBConv blocks, ``norm="none"``, SiLU, a
  per-stage ``kernel_size`` with tuples and a 5³ stage, so grouped
  depthwise convs of other kernels run on cuDNN, and attention in decoder
  stage 6;
* ``aniso_cf``: the default BasicBlocks on an anisotropic ``scale``
  ((1, 2, 2) first), ``cf_fullres``/``cf_halfres`` False in the JAX model:
  the port's channel-first stem and stages on (B, D, C, H, W) planes whose
  depth is twice their edge, the last decoder stage upsampling H and W
  only.

The other blocks of ``BLOCKS`` (ConvNormAct, Bottleneck) and the other
activations enter MedFormer through the same ``BLOCKS``/``make_act``
lookups; they are held against JAX as blocks in ``tests/test_torch_zoo.py``,
the encoder heads in ``tests/test_torch_clip.py``.
The JAX parameter tree is filled with seeded numpy values and carried over
with ``params_from_flax``; one jitted JAX call a case gives the float32
heads and the gradient of L = Σ_heads Σ head·r.

Tolerances, float32 on both sides: forward max|Δ| ≤ 1e-3·(1 + max|ref|)
per head; gradients ‖Δg‖ ≤ 2e-3·(‖g‖ + 1e-3·max‖g‖) per parameter, the
attention models' bound of ``tests/test_torch_zoo.py``. Against a float64
run of the JAX model both packages' float32 gradients stay within 3.3e-4
on every tensor of these cases (``python tools/zoo_rounding_witness.py
--medformer``); a MedFormer whose conv stages normalise a few channels
(Bottleneck, post-activated ConvNormAct) is ill-conditioned: the JAX
package's own float32 gradient is off by 1.6e-2–2.4e-2 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu_torch.models import load_flax_params, params_from_flax
from rsuper_tpu_torch.models.medformer import MedFormer
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_medformer import TINY, _unflatten, flax_params

NUM_CLASSES = 3
F32_TOL = 1e-3
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-3
ANISO = ((1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))

# case → (model args over TINY, input (B, D, H, W))
CASES = {
    "mbconv_linear_gelu": (dict(conv_block="MBConv",
                                conv_num=(1, 1, 0, 0, 0, 1, 1, 1),
                                trans_num=(0, 1, 2, 1, 1, 1, 0, 1),
                                chan_num=(8, 16, 32, 40, 32, 16, 8, 16),
                                proj_type="linear", act="gelu"),
                           (1, 16, 16, 16)),
    "fused_nonorm_kernels": (dict(conv_block="FusedMBConv", norm="none",
                                  act="silu", conv_num=(1, 0, 1, 0, 0, 0, 1,
                                                        1),
                                  kernel_size=((3, 3, 1), 3, 5, (1, 3, 3),
                                               3),
                                  trans_num=(0, 1, 2, 1, 1, 1, 1, 0),
                                  chan_num=(8, 16, 32, 40, 32, 16, 16, 4)),
                             (1, 16, 16, 16)),
    "aniso_cf": (dict(scale=ANISO, cf_fullres=False, cf_halfres=False,
                      kernel_size=(3, (3, 3, 3), 3, 3, 3)),
                 (1, 16, 32, 32)),
}
_REFS = {}


def _args(case):
    args, _ = CASES[case]
    return {**TINY, **args}


def _outputs(out):
    """The model's outputs as a list: the segmentation heads, then the
    encoder heads it has."""
    seg = out["segmentation"]
    heads = list(seg) if isinstance(seg, (list, tuple)) else [seg]
    return heads + [out[k] for k in ("classification", "clip") if k in out]


def _ref(case):
    if case not in _REFS:
        _, shape = CASES[case]
        rng = np.random.default_rng(5)
        x = rng.normal(size=(*shape, 1)).astype(np.float32)
        jm = JaxMedFormer(NUM_CLASSES, dtype=jnp.float32, **_args(case))
        flat = flax_params(jm, x)
        shapes = [o.shape for o in _outputs(jax.eval_shape(
            jm.apply, {"params": _unflatten(flat)}, jnp.asarray(x)))]
        r = [rng.normal(size=s).astype(np.float32) for s in shapes]

        def loss(params, x, r):
            outs = _outputs(jm.apply({"params": params}, x))
            return sum(jnp.sum(o * w) for o, w in zip(outs, r)), outs

        args = (_unflatten(flat), jnp.asarray(x), [jnp.asarray(w) for w in r])
        (_, outs), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True)).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})(*args)
        _REFS[case] = dict(x=x, flat=flat, r=r,
                           outs=[np.asarray(o) for o in outs],
                           grads=jax.tree_util.tree_map(np.asarray, grads))
    return _REFS[case]


def _port(case, flat, **over):
    model = MedFormer(NUM_CLASSES, dtype=torch.float32,
                      **{**_args(case), **over})
    return load_flax_params(model, flat)


@pytest.mark.parametrize("case", sorted(CASES))
def test_medformer_option_matches_jax_forward_and_gradient(case):
    ref = _ref(case)
    model = _port(case, ref["flat"])
    outs = _outputs(model(torch.from_numpy(ref["x"])))
    assert len(outs) == len(ref["outs"])
    for i, (got, want) in enumerate(zip(outs, ref["outs"])):
        assert tuple(got.shape) == want.shape, (case, i)
        err = float(np.abs(got.detach().numpy() - want).max())
        mx = float(np.abs(want).max())
        assert err <= F32_TOL * (1 + mx), (case, i, err, mx)
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs,
                                                               ref["r"]))
    loss.backward()
    want = params_from_flax(ref["grads"], model)
    top = max(float(w.norm()) for w in want.values())
    assert top > 0
    for k, p in model.named_parameters():
        # a parameter the loss does not reach (the last stage's map output)
        # has no gradient here and a zero one in JAX
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - want[k]).norm())
        bound = GRAD_TOL * (float(want[k].norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{case} {k}: ‖Δ‖ {err} > {bound}"


def _routes(model):
    """(channel-first conv blocks, depthwise-kernel convs, cuDNN convs)."""
    kinds = [type(m).__name__ for m in model.modules()]
    return (kinds.count("BasicBlockCF"), kinds.count("DepthwiseConv3"),
            kinds.count("Conv"))


def test_routes_follow_the_function_not_the_tpu_gates():
    """The anisotropic default blocks run the stem and the conv stages
    channel-first, as the default does, whatever ``cf_fullres`` and
    ``cf_halfres`` say; MBConv stages run channels-last, their 3³ stride-1
    depthwise convs on the depthwise kernel; a stage with attention runs its
    BasicBlocks channels-last."""
    aniso = _port("aniso_cf", _ref("aniso_cf")["flat"])
    assert aniso.stem_cf and aniso.skip_cf[:2] == [True, True]
    assert _routes(aniso)[0] == 1 + 2 + 2 + 2  # stem, DownBlockMF_0, up 6/7
    assert aniso.UpBlockMF_2.cf and aniso.UpBlockMF_3.cf
    mb = MedFormer(NUM_CLASSES, **_args("mbconv_linear_gelu"))
    cf_blocks, dw, _ = _routes(mb)
    assert cf_blocks == 0 and not mb.stem_cf and dw > 0
    attn6 = MedFormer(NUM_CLASSES, **{**_args("aniso_cf"),
                                      **_args("fused_nonorm_kernels"),
                                      "conv_block": "BasicBlock",
                                      "norm": "in", "act": "relu",
                                      "kernel_size": (3,) * 5})
    assert not attn6.UpBlockMF_2.cf and attn6.UpBlockMF_3.cf


@pytest.mark.parametrize("over", [dict(cf_fullres=True, cf_halfres=True),
                                  dict(cf_fullres=False),
                                  dict(cf_halfres=False)])
def test_layout_switches_change_nothing(over):
    """``cf_fullres``/``cf_halfres`` are the JAX model's TPU layout
    switches: the port computes the same function with the same parameter
    tree either way, equal to the JAX model built with both False."""
    ref = _ref("aniso_cf")
    model = _port("aniso_cf", ref["flat"], **over)
    with torch.inference_mode():
        outs = _outputs(model(torch.from_numpy(ref["x"])))
    for got, want in zip(outs, ref["outs"]):
        err = float(np.abs(got.numpy() - want).max())
        assert err <= F32_TOL * (1 + float(np.abs(want).max()))


@pytest.mark.parametrize("over,match", [
    (dict(trans_num=(1, 1, 2, 1, 1, 1, 0, 0)), "trans_num\\[0\\]"),
    (dict(trans_num=(0, 1, 2, 1, 1, 1, 1, 0)), "trans_num\\[6\\]"),
    (dict(trans_num=(0, 1, 2, 1, 1, 1, 0, 1)), "trans_num\\[7\\]"),
])
def test_configurations_the_jax_model_cannot_build_raise(over, match):
    """Attention in the first encoder stage, and attention after
    UpBlockMF_1 on a semantic map of another width: the JAX model fails to
    build them, the port raises ValueError naming the option."""
    args = {**TINY, **over}
    with pytest.raises(Exception):
        jax.eval_shape(JaxMedFormer(NUM_CLASSES, **args).init,
                       jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)))
    with pytest.raises(ValueError, match=match):
        MedFormer(NUM_CLASSES, **args)
