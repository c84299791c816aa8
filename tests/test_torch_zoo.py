"""The port's 3D model zoo against the JAX package, on the CPU.

Each architecture of ``rsuper_tpu/models/factory.py`` is a case of one
parametrised test, at small widths (the sizes of ``tests/test_models.py``
or smaller). The JAX parameter tree (from ``jax.eval_shape`` of ``init``)
is filled with seeded numpy values and carried over with
``params_from_flax``, strict both ways; one jitted JAX call per case gives
the float32 forward and the gradient of L = Σ_heads Σ head·r (r seeded
normal, one tensor a head), and is shared by the case's tests.

The input shapes reach each trap of the translation: the strided UNets
take (20, 24, 32) volumes, so their stride-2 3³ convs pad (0, 1) on even
sizes and (1, 1) on odd ones (flax SAME) and the decoder resizes 2 → 3 and
3 → 5; the pooled ones take (32, 36, 40), so max pools floor odd sizes and
the deepest stage keeps 2³ voxels; the Swin models' deepest stages are one
window and every stage of size > 1 window runs a shifted block with its
mask, at batch 2.

Tolerances (float32 on both sides, sums in another order):
* forward: max|Δ| ≤ F32_TOL·(1 + max|ref|) per head (the MedFormer
  file's); the largest seen is 1.2e-4;
* gradient: ‖Δg‖ ≤ tol·(‖g‖ + GRAD_FLOOR·max‖g‖) per parameter, with
  tol = GRAD_TOL, the bound of ``tests/test_torch_train.py``, for the
  transformers and V-Net (the largest seen is 4e-4), and CONV_GRAD_TOL for
  the conv nets of CONV_NETS. Their chains of instance norms and ReLUs on
  a few channels amplify float32 rounding: against a float64 run of the
  JAX model, the JAX package's own float32 gradient is off by up to 1.8e-2
  on a tensor and the port's by up to 2.1e-2
  (``python tools/zoo_rounding_witness.py``), so the two may lie up to
  about 4e-2 apart; a layout, padding or flip fault is off by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rsuper_tpu.models import factory as jfactory
from rsuper_tpu_torch.models import (factory, flax_from_state_dict,
                                     get_model, init_params,
                                     load_flax_params, params_from_flax)
from rsuper_tpu_torch.models import params as port_params
from rsuper_tpu_torch.models.layers import Conv, ConvTranspose
from rsuper_tpu_torch.models.swin_unetr import _shift_mask
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_medformer import _unflatten, flax_params

NUM_CLASSES = 3
F32_TOL = 1e-3
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-3
CONV_GRAD_TOL = 6e-2  # the instance-normed conv nets (module docstring)
CONV_NETS = ("unet_pool", "resunet_aux", "attention_unet", "unetpp")
UNET_SHAPE = (1, 20, 24, 32)
POOL_SHAPE = (1, 32, 36, 40)

# case → (arch, model args, input (B, D, H, W))
CASES = {
    "unet_pool": ("unet", dict(base_chan=4, pool=True), POOL_SHAPE),
    "resunet_aux": ("resunet", dict(base_chan=4, aux_head=True),
                    UNET_SHAPE),
    "attention_unet": ("attention_unet", dict(base_chan=4), POOL_SHAPE),
    "unetpp": ("unetpp", dict(base_chan=4, depth=3), POOL_SHAPE),
    "vnet": ("vnet", dict(base_chan=4), (1, 16, 16, 16)),
    "unetr": ("unetr", dict(img_size=(32, 32, 32), hidden_size=32,
                            mlp_dim=64, num_heads=4, num_layers=4,
                            feature_size=4), (1, 32, 32, 32)),
    "swin_unetr": ("swin_unetr", dict(feature_size=4, depths=(2, 1, 1, 1),
                                      num_heads=(2, 2, 2, 2),
                                      window_size=2), (2, 32, 32, 32)),
    "nnformer": ("nnformer", dict(embed_dim=8, depths=(2, 1, 2),
                                  num_heads=(2, 2, 2), window_size=2),
                 (2, 32, 32, 32)),
    "vtunet": ("vtunet", dict(embed_dim=8, depths=(2, 2, 1),
                              num_heads=(2, 2, 2), window_size=2),
               (2, 16, 16, 16)),
}
_REFS = {}


def _heads(seg):
    return list(seg) if isinstance(seg, (list, tuple)) else [seg]


def _ref(case):
    """The case's input, flax parameters, head weights r, and JAX's
    float32 heads and parameter gradient (computed once a module)."""
    if case not in _REFS:
        arch, args, shape = CASES[case]
        rng = np.random.default_rng(3)
        x = rng.normal(size=(*shape, 1)).astype(np.float32)
        jm = jfactory.get_model(arch, NUM_CLASSES, dict(args),
                                dtype=jnp.float32)
        flat = flax_params(jm, x)
        n_heads = len(_heads(jax.eval_shape(
            jm.apply, {"params": _unflatten(flat)},
            jnp.asarray(x))["segmentation"]))
        r = [rng.normal(size=(*shape, NUM_CLASSES)).astype(np.float32)
             for _ in range(n_heads)]

        def loss(params, x, r):
            seg = _heads(jm.apply({"params": params}, x)["segmentation"])
            return sum(jnp.sum(h * w) for h, w in zip(seg, r)), seg

        args = (_unflatten(flat), jnp.asarray(x), [jnp.asarray(w) for w in r])
        # LLVM's optimisation level 0 halves the compile, which dominates
        (_, seg), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True)).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})(*args)
        _REFS[case] = dict(
            x=x, flat=flat, r=r, heads=[np.asarray(h) for h in seg],
            grads=jax.tree_util.tree_map(np.asarray, grads))
    return _REFS[case]


def _port(case, flat):
    arch, args, _ = CASES[case]
    model = get_model(arch, NUM_CLASSES, dict(args), dtype=torch.float32)
    return load_flax_params(model, flat)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zoo_matches_jax_forward_and_gradient(case):
    ref = _ref(case)
    model = _port(case, ref["flat"])
    seg = model(torch.from_numpy(ref["x"]))["segmentation"]
    heads = _heads(seg)
    assert len(heads) == len(ref["heads"])
    assert isinstance(seg, list) == (len(heads) == 2)
    for i, (got, want) in enumerate(zip(heads, ref["heads"])):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.float32
        err = float(np.abs(got.detach().numpy() - want).max())
        mx = float(np.abs(want).max())
        assert err <= F32_TOL * (1 + mx), (case, i, err, mx)
    loss = sum((h * torch.from_numpy(w)).sum() for h, w in zip(heads,
                                                               ref["r"]))
    loss.backward()
    want = params_from_flax(ref["grads"], model)
    top = max(float(w.norm()) for w in want.values())
    assert top > 0
    tol = CONV_GRAD_TOL if case in CONV_NETS else GRAD_TOL
    for k, p in model.named_parameters():
        err = float((p.grad - want[k]).norm())
        bound = tol * (float(want[k].norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{case} {k}: ‖Δ‖ {err} > {bound}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_zoo_params_round_trip_through_flax_layout(case):
    """flax → port → flax gives back every leaf bit for bit; the seeded
    initialiser fills every parameter as flax's initialisers do."""
    flat = _ref(case)["flat"]
    model = _port(case, flat)
    back = flax_from_state_dict(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    arch, args, _ = CASES[case]
    fresh = init_params(get_model(arch, NUM_CLASSES, dict(args)), seed=1)
    for k, p in fresh.named_parameters():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "bias":
            assert not p.any(), k
        elif leaf == "alpha":
            assert (p == 0.25).all(), k
        elif ".LayerNorm_" in f".{k}":
            assert (p == 1).all(), k
        else:
            assert torch.isfinite(p).all() and p.std() > 0, k


# the generic blocks of layers.py: (JAX class, its arguments); C_in 4 → 8
BLOCK_CASES = {
    "convnormact_gelu_s2": ("ConvNormAct", dict(features=8, strides=2,
                                                act="gelu")),
    "convnormact_preact_relu6_nonorm": ("ConvNormAct", dict(
        features=8, norm="none", act="relu6", preact=True)),
    "convnormact_1x1_silu": ("ConvNormAct", dict(features=8, kernel_size=1,
                                                 act="silu", preact=True)),
    "basicblock_s2": ("BasicBlock", dict(features=8, strides=2)),
    "bottleneck_s2": ("Bottleneck", dict(features=8, strides=2)),
    "bottleneck_5": ("Bottleneck", dict(features=8, kernel_size=5)),
    "convnormact_grouped_s2": ("ConvNormAct", dict(features=8, groups=2,
                                                   strides=2)),
    "dsconv_5_s2": ("DepthwiseSeparableConv", dict(features=8, kernel_size=5,
                                                   strides=2)),
    "mbconv_s2_gelu": ("MBConv", dict(features=8, strides=2, act="gelu")),
    "mbconv_e1_k311_nose": ("MBConv", dict(features=8, expansion=1,
                                           kernel_size=(3, 1, 1), se=False)),
    "fused_mbconv_s2_silu": ("FusedMBConv", dict(features=8, strides=2,
                                                 act="silu")),
    "fused_mbconv_nonorm": ("FusedMBConv", dict(features=8, norm="none",
                                                expansion=2)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_generic_block_matches_jax(case):
    """One block of ``layers.py`` on a (2, 9, 10, 8, 4) input (odd and
    even sizes): output, and the gradients of Σ y·r for the parameters and
    the input, within F32_TOL and GRAD_TOL."""
    from rsuper_tpu.models import layers as jlayers
    from rsuper_tpu_torch.models import layers

    name, kw = BLOCK_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(2, 9, 10, 8, 4)).astype(np.float32)
    jm = getattr(jlayers, name)(**kw)
    flat = flax_params(jm, x)
    y_shape = jax.eval_shape(jm.apply, {"params": _unflatten(flat)},
                             jnp.asarray(x)).shape
    r = rng.normal(size=y_shape).astype(np.float32)

    def loss(p, x):
        y = jm.apply({"params": p}, x)
        return jnp.sum(y * r), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(_unflatten(flat), jnp.asarray(x))
    port_kw = {k: v for k, v in kw.items() if k != "features"}
    block = load_flax_params(getattr(layers, name)(4, kw["features"],
                                                   **port_kw), flat)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = block(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)
    (y * torch.from_numpy(r)).sum().backward()
    grads = dict(params_from_flax(jax.tree_util.tree_map(np.asarray, gp),
                                  block), x=torch.tensor(np.asarray(gx)))
    got = dict(block.named_parameters(), x=xt)
    top = max(float(g.norm()) for g in grads.values())
    for k, g in grads.items():
        err = float((got[k].grad - g).norm())
        assert err <= GRAD_TOL * (float(g.norm()) + GRAD_FLOOR * top), k


# (kernel, stride, size): even and odd sizes of the zoo's strided convs,
# the 5³ and 16³ convs, and the 2³ transposed convs
@pytest.mark.parametrize("kernel,stride,size", [
    (3, 2, 8), (3, 2, 7), (3, 1, 6), (2, 2, 8), (2, 2, 7), (5, 1, 6),
    (4, 4, 8)])
def test_one_conv_layer_matches_flax(kernel, stride, size):
    rng = np.random.default_rng(kernel * 100 + stride * 10 + size)
    x = rng.normal(size=(2, size, size + 1, size, 3)).astype(np.float32)
    jconv = fnn.Conv(5, (kernel,) * 3, strides=(stride,) * 3)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jnp.asarray(x)))
    conv = Conv(3, 5, kernel, stride)
    load_flax_params(conv, params)
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel,stride", [(2, 2), (3, 2), (2, 1), (4, 2)])
def test_one_transposed_conv_layer_matches_flax(kernel, stride):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(2, 5, 4, 6, 3)).astype(np.float32)
    jconv = fnn.ConvTranspose(5, (kernel,) * 3, strides=(stride,) * 3)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jnp.asarray(x)))
    conv = ConvTranspose(3, 5, kernel, stride)
    load_flax_params(conv, params)
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_shift_mask_is_the_jax_packages():
    from rsuper_tpu.models.swin_unetr import _shift_mask as jmask

    for dims, ws, shift in (((4, 4, 4), 2, 1), ((8, 4, 8), 4, 2),
                            ((2, 2, 2), 2, 1)):
        np.testing.assert_array_equal(_shift_mask(dims, ws, shift),
                                      jmask(dims, ws, shift))


def _jax_leaf_shapes(arch, model, x_shape):
    """The port name and shape of every leaf of the JAX model's tree at its
    defaults, through the converter's own rules (``_convert_leaf``
    on zero-stride stand-ins: no memory for the full-width weights)."""
    jm = jfactory.get_model(arch, NUM_CLASSES, {}, dtype=jnp.float32)
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros(x_shape, jnp.float32))["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(p, "key", p)) for p in path]
        name, arr = port_params._convert_leaf(
            parts, np.broadcast_to(np.float32(0), leaf.shape),
            port_params._owner(model, parts))
        out[".".join(parts[:-1] + [name])] = tuple(arr.shape)
    return out


# the smallest input each architecture takes at its defaults
_DEFAULT_INPUT = {"unetr": 96, "swin_unetr": 64, "nnformer": 64,
                  "vtunet": 32}


@pytest.mark.parametrize("arch", sorted(jfactory.MODEL_REGISTRY))
def test_every_jax_arch_builds_or_names_its_roadmap_item(arch):
    """Each name of the JAX registry builds at the JAX defaults: the JAX
    tree's leaves name every parameter, each with its shape, and nothing
    else. The 2D models are held at a 64² slice (the input size their
    Swin windows and TransUNet's embedding are built for)."""
    assert arch in factory.MODEL_REGISTRY
    if arch.endswith("_2d"):
        model = get_model(arch, NUM_CLASSES, {"img_size": (64, 64)})
        x_shape = (1, 64, 64, 1)
    else:
        model = get_model(arch, NUM_CLASSES)
        if arch == "medformer":  # held at its defaults by tools/, too slow
            return
        s = _DEFAULT_INPUT.get(arch, 16)
        x_shape = (1, s, s, s, 1)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert _jax_leaf_shapes(arch, model, x_shape) == want


def test_unknown_arch_raises_value_error():
    with pytest.raises(ValueError, match="unknown arch"):
        get_model("nope", NUM_CLASSES)
