"""The port's 2D pathway models against the JAX package, on the CPU.

Each architecture of the JAX registry's 2D pathway is a case of one
parametrised test at small widths. The JAX parameter tree is filled with
seeded numpy values (DANet's gates too, which JAX initialises to zero, so
that its attention branches count) and carried over with
``params_from_flax``, strict both ways; one jitted JAX call a case gives
the float32 forward and the gradient of L = Σ_heads Σ head·r.

The inputs reach the traps of the translation: the strided UNets take
(36, 42) slices, so their stride-2 3×3 convs pad (0, 1) on even sizes and
(1, 1) on odd ones (flax SAME) and the decoder resizes 3 → 5 and 3 → 6;
UNet++ takes (36, 40), so its max pools floor; Swin-UNet's second and
third stages run shifted blocks with their masks, its last stage a window
of 2 that does not shift, at batch 2.

Tolerances (float32 on both sides): forward max|Δ| ≤ 1e-3·(1 + max|ref|)
per head; gradient ‖Δg‖ ≤ tol·(‖g‖ + 1e-3·max‖g‖) per parameter, with
tol = 2e-3 for the attention models and 6e-2 for the instance-normed nets
of CONV_NETS (the bounds of ``tests/test_torch_zoo.py``, and why). The 2D
MedFormer is one of those: its instance norms on few channels and small
maps amplify float32 rounding, and against a float64 run of the JAX model
the JAX package's own float32 gradient is off by 2.4e-2 on a tensor and
the port's by 1.7e-2 at this file's widths, 2.7e-2 apart (``python
tools/zoo_rounding_witness.py --dim2``). Its case takes map_size 4: at the
registry's 8 the seeded model is more chaotic still (on the card one
float32 rounding of the input moves its logits by 1e-3 of their size,
``chip_smoke.py``'s dim2 phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.models import factory as jfactory
from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                     init_params, load_flax_params,
                                     params_from_flax)
from rsuper_tpu_torch.models.dim2_zoo import _shift_mask2d
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_medformer import _unflatten, flax_params

NUM_CLASSES = 3
F32_TOL = 1e-3
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-3
CONV_GRAD_TOL = 6e-2
CONV_NETS = ("unet_2d", "resunet_2d", "attention_unet_2d", "unetpp_2d",
             "dual_attention_unet_2d", "medformer_2d")

# arch → (model args, input (B, H, W)); the port's img_size is the input's
CASES = {
    "unet_2d": (dict(base_chan=4), (2, 36, 42)),
    "resunet_2d": (dict(base_chan=4), (2, 36, 42)),
    "attention_unet_2d": (dict(base_chan=4), (2, 36, 42)),
    "dual_attention_unet_2d": (dict(base_chan=4), (1, 32, 32)),
    "transunet_2d": (dict(base_chan=4, hidden=16, depth=2, heads=2),
                     (1, 36, 40)),
    "swin_unet_2d": (dict(embed_dim=8, depths=(2, 2, 2, 1),
                          num_heads=(2, 2, 2, 2)), (2, 64, 64)),
    "unetpp_2d": (dict(base_chan=4, depth=3), (1, 36, 40)),
    "medformer_2d": (dict(base_chan=4, num_heads=(1, 2, 2, 2, 2, 2, 1, 1),
                          fusion_dim=16, fusion_heads=2, aux_loss=True,
                          map_size=4), (1, 64, 64)),
}
_REFS, _FLAT = {}, {}


def _heads(seg):
    return list(seg) if isinstance(seg, (list, tuple)) else [seg]


def _input(arch):
    args, shape = CASES[arch]
    rng = np.random.default_rng(7)
    return rng, rng.normal(size=(*shape, 1)).astype(np.float32)


def _flat(arch):
    """The JAX tree of the case's model filled from numpy (a trace, no
    compile)."""
    if arch not in _FLAT:
        jm = jfactory.get_model(arch, NUM_CLASSES, dict(CASES[arch][0]),
                                dtype=jnp.float32)
        _FLAT[arch] = flax_params(jm, _input(arch)[1])
    return _FLAT[arch]


def _ref(arch):
    if arch not in _REFS:
        args, shape = CASES[arch]
        rng, x = _input(arch)
        jm = jfactory.get_model(arch, NUM_CLASSES, dict(args),
                                dtype=jnp.float32)
        flat = _flat(arch)
        n_heads = len(_heads(jax.eval_shape(
            jm.apply, {"params": _unflatten(flat)},
            jnp.asarray(x))["segmentation"]))
        r = [rng.normal(size=(*shape, NUM_CLASSES)).astype(np.float32)
             for _ in range(n_heads)]

        def loss(params, x, r):
            seg = _heads(jm.apply({"params": params}, x)["segmentation"])
            return sum(jnp.sum(h * w) for h, w in zip(seg, r)), seg

        args = (_unflatten(flat), jnp.asarray(x), [jnp.asarray(w) for w in r])
        (_, seg), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True)).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})(*args)
        _REFS[arch] = dict(
            x=x, flat=flat, r=r, heads=[np.asarray(h) for h in seg],
            grads=jax.tree_util.tree_map(np.asarray, grads))
    return _REFS[arch]


def _model(arch, **kw):
    args, shape = CASES[arch]
    return get_model(arch, NUM_CLASSES, {**args, "img_size": shape[1:]},
                     **kw)


# resunet_2d builds the same UNet2D as unet_2d (the JAX registry's choice):
# its tree is held below, its function by the unet_2d case
@pytest.mark.parametrize("arch", sorted(set(CASES) - {"resunet_2d"}))
def test_dim2_matches_jax_forward_and_gradient(arch):
    ref = _ref(arch)
    model = load_flax_params(_model(arch, dtype=torch.float32), ref["flat"])
    seg = model(torch.from_numpy(ref["x"]))["segmentation"]
    heads = _heads(seg)
    assert len(heads) == len(ref["heads"])
    for i, (got, want) in enumerate(zip(heads, ref["heads"])):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.float32
        err = float(np.abs(got.detach().numpy() - want).max())
        mx = float(np.abs(want).max())
        assert err <= F32_TOL * (1 + mx), (arch, i, err, mx)
    loss = sum((h * torch.from_numpy(w)).sum() for h, w in zip(heads,
                                                               ref["r"]))
    loss.backward()
    want = params_from_flax(ref["grads"], model)
    top = max(float(w.norm()) for w in want.values())
    assert top > 0
    tol = CONV_GRAD_TOL if arch in CONV_NETS else GRAD_TOL
    for k, p in model.named_parameters():
        # DANet's three discarded class heads are not computed here: no
        # gradient, and a zero one in JAX
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - want[k]).norm())
        bound = tol * (float(want[k].norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{arch} {k}: ‖Δ‖ {err} > {bound}"


@pytest.mark.parametrize("arch", sorted(CASES))
def test_dim2_params_round_trip_through_flax_layout(arch):
    """flax → port → flax gives back every leaf bit for bit (2D kernels and
    1×1 convs, DANet's gates, Swin's tables, TransUNet's embedding); the
    seeded initialiser fills them as flax's initialisers do."""
    flat = _flat(arch)
    model = load_flax_params(_model(arch), flat)
    back = flax_from_state_dict(model.state_dict(), model=model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fresh = init_params(_model(arch), seed=1)
    for k, p in fresh.named_parameters():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "gamma"):
            assert not p.any(), k
        elif ".LayerNorm_" in f".{k}":
            assert (p == 1).all(), k
        else:
            assert torch.isfinite(p).all() and p.std() > 0, k


def test_shift_mask2d_is_the_jax_packages():
    from rsuper_tpu.models.dim2_zoo import _shift_mask2d as jmask

    for dims, ws, shift in (((8, 8), 4, 2), ((4, 8), 2, 1), ((4, 4), 4, 2)):
        np.testing.assert_array_equal(_shift_mask2d(dims, ws, shift),
                                      jmask(dims, ws, shift))


def test_transunet_refuses_another_input_size():
    model = init_params(_model("transunet_2d", dtype=torch.float32))
    with pytest.raises(ValueError, match="img_size"):
        model(torch.zeros(1, 64, 64, 1))
