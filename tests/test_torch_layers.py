"""The PyTorch port's MedFormer layers against the JAX modules, on the CPU.

Each JAX module's parameter tree comes from ``jax.eval_shape`` of its
``init`` and is filled with seeded numpy values (random biases and LayerNorm
scales included, so every leaf matters); ``params_from_flax`` carries the
same values into the port's module. Inputs come from numpy with a fixed
seed. Everything runs in float32.

Tolerance: max|Δ| ≤ 1e-4·(1 + max|ref|) — the two frameworks sum the same
products in another order; no step rounds below float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.models import layers as jl
from rsuper_tpu.models import medformer as jmf
from rsuper_tpu_torch.models import layers as tl
from rsuper_tpu_torch.models import medformer as tmf
from rsuper_tpu_torch.models.params import load_flax_params

TOL = 1e-4


def _assert_close(got, ref, tol=TOL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    bound = tol * (1.0 + float(np.abs(ref).max()))
    assert err <= bound, f"max|Δ| {err} > {bound}"


def _flax_params(module, *inputs, seed=0):
    """Flat {"a/b/kernel": array} tree of `module`, filled from numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in inputs])["params"]
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


def _jax_apply(module, flat, *inputs):
    from flax.traverse_util import unflatten_dict

    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    return module.apply({"params": tree}, *[jnp.asarray(a) for a in inputs])


def _run_pair(jmod, tmod, *inputs):
    flat = _flax_params(jmod, *inputs)
    load_flax_params(tmod, flat)
    ref = _jax_apply(jmod, flat, *inputs)
    with torch.inference_mode():
        got = tmod(*[torch.from_numpy(a) for a in inputs])
    return got, ref


def _randn(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ norms, resize
def test_instance_norms_match_jax():
    x = _randn(2, 4, 5, 6, 3) * 3.0 + 1.0
    _assert_close(tl.instance_norm(torch.from_numpy(x)).numpy(),
                  jl.instance_norm(jnp.asarray(x)))
    xcf = _randn(2, 4, 3, 5, 6, seed=2) * 2.0 - 1.0
    _assert_close(tl.instance_norm_cf(torch.from_numpy(xcf)).numpy(),
                  jl.instance_norm_cf(jnp.asarray(xcf)))
    # PatchMerging's split view: (B, D', sd, C, H', sh, W', sw)
    x8 = xcf.reshape(2, 2, 2, 3, 5, 1, 3, 2)
    _assert_close(tl.instance_norm_axes(torch.from_numpy(x8), (1, 4, 6)
                                        ).numpy(),
                  jl.instance_norm_axes(jnp.asarray(x8), (1, 4, 6)))


@pytest.mark.parametrize("src,dst", [((4, 3, 5), (8, 6, 10)),
                                     ((3, 3, 3), (12, 12, 12)),
                                     ((2, 4, 3), (8, 16, 12))])
def test_resize_trilinear_matches_jax(src, dst):
    """×2 (decoder) and ×4 (the aux head's 24→96) half-pixel upsampling."""
    x = _randn(2, *src, 3)
    _assert_close(tl.resize_trilinear(torch.from_numpy(x), dst).numpy(),
                  jl.resize_trilinear(jnp.asarray(x), dst))
    xcf = np.ascontiguousarray(np.moveaxis(x, -1, 2))
    _assert_close(tl.resize_trilinear_cf(torch.from_numpy(xcf), dst).numpy(),
                  jl.resize_trilinear_cf(jnp.asarray(xcf), dst))


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("cf_input", [True, False])
def test_patch_merging_matches_jax(cf_input):
    """The merged channel order (sd, sh, sw, c), from CF and from
    channels-last input."""
    x = _randn(1, 4, 3, 6, 8) if cf_input else _randn(1, 4, 6, 8, 3)
    got, ref = _run_pair(jmf.PatchMerging(10, cf_input=cf_input),
                         tmf.PatchMerging(3, 10, cf_input=cf_input), x)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("no_map_out", [False, True])
def test_bidirection_attention_matches_jax(no_map_out):
    """The (2, heads, dim_head) head split of both token sets."""
    feat, sem = _randn(2, 4, 4, 6, 10), _randn(2, 3, 3, 3, 8, seed=3)
    got, ref = _run_pair(
        jmf.BidirectionAttention(8, 12, heads=2, dim_head=4,
                                 no_map_out=no_map_out),
        tmf.BidirectionAttention(10, 8, 12, heads=2, dim_head=4,
                                 no_map_out=no_map_out),
        feat, sem)
    _assert_close(got[0].numpy(), ref[0])
    _assert_close(got[1].numpy(), ref[1])


def test_bidirection_attention_block_matches_jax():
    """With the 1×1 ConvNormAct shortcut (feat_dim != out_dim)."""
    x, sem = _randn(1, 4, 4, 4, 6), _randn(1, 3, 3, 3, 8, seed=4)
    got, ref = _run_pair(
        jmf.BidirectionAttentionBlock(8, 12, heads=2, dim_head=4,
                                      expansion=2),
        tmf.BidirectionAttentionBlock(6, 8, 12, heads=2, dim_head=4,
                                      expansion=2),
        x, sem)
    _assert_close(got[0].numpy(), ref[0])
    _assert_close(got[1].numpy(), ref[1])


@pytest.mark.parametrize("expansion", [1, 2])
def test_mbconv_matches_jax(expansion):
    x = _randn(2, 4, 4, 6, 8)
    got, ref = _run_pair(jl.MBConv(8, expansion=expansion),
                         tl.MBConv(8, 8, expansion=expansion), x)
    _assert_close(got.numpy(), ref)


def test_transformer_block_matches_jax():
    x = _randn(2, 10, 8)
    got, ref = _run_pair(jl.TransformerBlock(2, 2, 4, 12),
                         tl.TransformerBlock(8, 2, 2, 4, 12), x)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("c_in,features", [(3, 6), (5, 5)])
def test_basic_block_cf_matches_jax(c_in, features):
    """Paired (C changes: ConvNormAct_0 and the shortcut as one fused call
    on stacked kernels) and unpaired (identity shortcut)."""
    x = _randn(2, 4, c_in, 6, 5) * 2.0 + 0.3
    tmod = tl.BasicBlockCF(c_in, features)
    assert tmod.pair == (c_in != features)
    got, ref = _run_pair(jl.BasicBlockCF(features), tmod, x)
    _assert_close(got.numpy(), ref)


def test_semantic_map_generation_matches_jax():
    """Its dense 3³ convs are recognised by their parent's name, so the
    port's module sits under the name the flax tree gives it in a stage."""
    x = _randn(2, 4, 6, 4, 5)
    jmod = jmf.SemanticMapGeneration(7)
    flat = _flax_params(jmod, x)
    stage = torch.nn.Module()
    stage.SemanticMapGeneration_0 = tmf.SemanticMapGeneration(5, 7)
    load_flax_params(stage, {f"SemanticMapGeneration_0/{k}": v
                             for k, v in flat.items()})
    ref = _jax_apply(jmod, flat, x)
    with torch.inference_mode():
        got = stage.SemanticMapGeneration_0(torch.from_numpy(x))
    _assert_close(got.numpy(), ref)
