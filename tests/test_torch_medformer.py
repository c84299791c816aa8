"""The PyTorch port's MedFormer against the JAX model, on the CPU.

A small configuration that keeps every stage kind of the default one: the
channel-first stem and conv stages at full and half resolution (paired and
unpaired BasicBlockCF), three attention encoder stages (one with two blocks),
semantic-map fusion, two attention decoder stages with map shortcuts, the
aux head and the channel-first decoder. The JAX parameter tree (from
``jax.eval_shape`` of ``init``) is filled with seeded numpy values and
carried over with ``params_from_flax``; one jitted JAX apply per dtype is
shared by the file's tests.

Tolerances, as max|Δ| ≤ tol·(1 + max|ref|):
* float32: 1e-3 — float32 on both sides; sums in another order through
  about 40 layers;
* bfloat16: both sides round every activation to bf16 (about 3 significant
  digits), at different places, through about 40 layers; with random
  weights that alone moves the JAX model's logits by several percent from
  its float32 run. So the port's bf16 output is held against JAX's float32
  output at 1.5× the distance of JAX's own bf16 run from it (max|Δ| and
  relative L2), and against JAX's bf16 output at 0.15·(1 + max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu_torch.models import get_model, load_flax_params
from rsuper_tpu_torch.models.params import params_from_flax

# the small widths of tests/test_torch_port.py (copied, not imported)
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
NUM_CLASSES = 3
F32_TOL = 1e-3
BF16_TOL, BF16_NOISE_FACTOR = 0.15, 1.5


def flax_params(module, x, seed=0):
    """Flat {"a/b/kernel": array} tree of `module`, filled from numpy."""
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


@pytest.fixture(scope="module")
def pair():
    x = np.random.default_rng(1).normal(size=(1, 32, 32, 32, 1)).astype(
        np.float32)
    jm = JaxMedFormer(NUM_CLASSES, dtype=jnp.float32, **TINY)
    flat = flax_params(jm, x)
    tree = {"params": _unflatten(flat)}
    out = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        model = JaxMedFormer(NUM_CLASSES, dtype=dt, **TINY)
        seg = jax.jit(model.apply)(tree, jnp.asarray(x))["segmentation"]
        out[name] = [np.asarray(s, np.float32) for s in seg]
    return x, flat, out


def _port(flat, dtype):
    model = get_model("medformer", NUM_CLASSES, dict(TINY), dtype=dtype)
    return load_flax_params(model, flat).eval()


def _errs(got, ref):
    err = float(np.abs(got - ref).max())
    mx = float(np.abs(ref).max())
    rel_l2 = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    return err, mx, rel_l2


def test_params_from_flax_fills_every_parameter(pair):
    _, flat, _ = pair
    model = get_model("medformer", NUM_CLASSES, dict(TINY))
    state = params_from_flax(flat, model)
    assert len(state) == len(flat) == len(model.state_dict())
    assert any(k.startswith("Checkpoint") for k in flat)  # remat's prefix
    # a nested tree under "params", and the tree of a model without remat
    plain = {k.replace("Checkpoint", ""): v for k, v in flat.items()}
    for tree in ({"params": _unflatten(flat)}, plain):
        state2 = params_from_flax(tree, model)
        assert sorted(state2) == sorted(state)
        for k in state:
            np.testing.assert_array_equal(state[k].numpy(),
                                          state2[k].numpy())


def test_medformer_float32_matches_jax(pair):
    x, flat, out = pair
    model = _port(flat, torch.float32)
    with torch.inference_mode():
        seg = model(torch.from_numpy(x))["segmentation"]
    assert len(seg) == 2
    for name, got, ref in zip(("logits", "aux"), seg, out["float32"]):
        assert tuple(got.shape) == (1, 32, 32, 32, NUM_CLASSES)
        assert got.dtype == torch.float32
        err, mx, _ = _errs(got.numpy(), ref)
        assert err <= F32_TOL * (1 + mx), f"{name}: {err} vs {mx}"


def test_medformer_bfloat16_matches_jax(pair):
    x, flat, out = pair
    model = _port(flat, torch.bfloat16)
    with torch.inference_mode():
        seg = model(torch.from_numpy(x))["segmentation"]
    for i, name in enumerate(("logits", "aux")):
        assert seg[i].dtype == torch.bfloat16
        g = seg[i].float().numpy()
        assert np.isfinite(g).all()
        err, mx, _ = _errs(g, out["bfloat16"][i])
        assert err <= BF16_TOL * (1 + mx), f"{name}: {err} vs {mx}"
        err32, _, rel32 = _errs(g, out["float32"][i])
        noise, _, noise_rel = _errs(out["bfloat16"][i], out["float32"][i])
        assert err32 <= BF16_NOISE_FACTOR * noise, f"{name}: {err32} {noise}"
        assert rel32 <= BF16_NOISE_FACTOR * noise_rel, \
            f"{name}: rel L2 {rel32} vs {noise_rel}"


def test_params_from_flax_raises_on_missing_leaf(pair):
    _, flat, _ = pair
    model = get_model("medformer", NUM_CLASSES, dict(TINY))
    short = dict(flat)
    short.pop("UpBlockMF_3/BasicBlock_0/ConvNormAct_1/Conv_0/kernel")
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(short, model)


def test_params_from_flax_raises_on_extra_leaf(pair):
    _, flat, _ = pair
    model = get_model("medformer", NUM_CLASSES, dict(TINY))
    extra = dict(flat)
    extra["outc/extra/bias"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        params_from_flax(extra, model)
    wrong = dict(flat)
    wrong["outc/bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(wrong, model)


@pytest.mark.parametrize("option", [{"cf_fullres": False},
                                    {"conv_block": "MBConv"}])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError):
        get_model("medformer", NUM_CLASSES, {**TINY, **option})


@pytest.mark.parametrize("torch_port", [False, True])
def test_torch_port_option_is_threaded(torch_port):
    """``torch_port`` builds and reaches every block the JAX option reaches:
    align-corners upsampling, eps 1e-5 in the patch merges, the attention
    blocks and the LayerNorms (1e-4 and 1e-6 without it)."""
    model = get_model("medformer", NUM_CLASSES,
                      {**TINY, "torch_port": torch_port,
                       "classification_classes": 2})
    block_eps, ln_eps = (1e-5, 1e-5) if torch_port else (1e-4, 1e-6)
    assert model.torch_port is torch_port
    for name, m in model.named_modules():
        kind = type(m).__name__
        if kind in ("PatchMerging", "BidirectionAttentionBlock"):
            assert m.norm_eps == block_eps, name
        elif kind == "LayerNorm":
            assert m.eps == ln_eps, name
        elif kind in ("UpBlockMF", "UpBlockCF"):
            assert m.align_corners is torch_port, name
