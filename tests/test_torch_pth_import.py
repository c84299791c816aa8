"""Reference R-Super ``.pth`` weights in the port, against the JAX package,
on the CPU: the port's key map (``rsuper_tpu_torch/models/torch_port.py``),
``MedFormer(torch_port=True)``, ``resize_trilinear{,_cf}(align_corners=True)``
and ``python -m rsuper_tpu_torch.convert_checkpoint``.

A reference-layout state_dict is made without the reference: the JAX
package's ``export_state_dict`` of seeded flax parameters.
Module-scoped fixtures hold the JAX side at the small widths of
``tests/test_torch_medformer.py`` (heads > 1, so a wrong ``qv`` channel
permutation shows in the forward pass) on one 32³ batch of
``tests/test_torch_train.py``: its float32 and bf16 forward, and its
``loss="dice"`` gradients.

Tolerances:
* key map, transforms, conversion and export: equal, bit for bit;
* align-corners resizing, float32: max|Δ| ≤ 1e-6·(1 + max|ref|) (the same
  linear weights, separable in JAX, trilinear in one pass here: a few
  float32 roundings apart);
* forward, as max|Δ| ≤ tol·(1 + max|ref|): float32 1e-3, bf16 0.15 against
  JAX's bf16 run and 1.5× JAX's own bf16 distance from its float32 run
  (``tests/test_torch_medformer.py``);
* gradients, float32: per parameter ‖Δ‖ ≤ 2e-3·(‖ref‖ + 1e-3·max‖ref‖),
  loss terms 1e-4 relative (``tests/test_torch_train.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.losses import LesionChannelMap as JLesionChannelMap
from rsuper_tpu.losses import LossConfig as JLossConfig
from rsuper_tpu.models import layers as jlayers
from rsuper_tpu.models import torch_port as jtp
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.train.step import loss_fn as jax_loss_fn
from rsuper_tpu_torch import convert_checkpoint
from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                     init_params, params_from_flax)
from rsuper_tpu_torch.models import layers as tlayers
from rsuper_tpu_torch.models import torch_port as tport
from rsuper_tpu_torch.train import loss_fn
from rsuper_tpu_torch.train.checkpoint import _donor_params, load_params

TINY = dict(  # tests/test_torch_medformer.py's widths (copied)
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
ARCH = ("base_chan", "chan_num", "conv_num", "trans_num", "num_heads",
        "fusion_depth")
CLASSES = ["background", "liver", "liver_lesion", "pancreatic_lesion"]
SIZE = 32
F32_TOL = 1e-3
BF16_TOL, BF16_NOISE_FACTOR = 0.15, 1.5
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-3
RESIZE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Several test processes share the machine; PyTorch's pool of spinning
    intra-op threads would slow these small models tens of times, so they
    take one thread (as ``tests/test_torch_loop.py`` does)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _keymap_kwargs(margs):
    return {k: margs[k] for k in ARCH if k in margs}


def _batch():  # tests/test_torch_train.py's batch (copied)
    rng = np.random.default_rng(0)
    C = len(CLASSES)
    seg = np.zeros((1, SIZE, SIZE, SIZE, C), np.float32)
    seg[0, 8:24, 8:24, 8:24, CLASSES.index("pancreatic_lesion")] = 1.0
    lab = np.zeros_like(seg)
    lab[0, 4:14, 6:20, 10:28, CLASSES.index("liver")] = 1.0
    vols = np.zeros((1, 10), np.float32)
    vols[0, :2] = [900.0, 300.0]
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


def _nest(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _flat_np(tree):
    from flax.traverse_util import flatten_dict

    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


class JaxSide:
    """The JAX torch_port model at TINY on the batch, its seeded
    parameters, and their reference-layout state_dict."""

    def __init__(self):
        self.batch = _batch()
        self.jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.model = JaxMedFormer(len(CLASSES), dtype=jnp.float32,
                                  remat=False, torch_port=True, **TINY)
        flat = _flax_params(self.model, self.batch["image"])
        self.params = {"params": _nest({k: jnp.asarray(v)
                                        for k, v in flat.items()})}
        self.pth = jtp.export_state_dict(_nest(flat), **_keymap_kwargs(TINY))


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


@pytest.fixture(scope="module")
def ref(jax_side):
    """The JAX model's segmentation outputs in float32 and bf16."""
    j = jax_side
    jm16 = JaxMedFormer(len(CLASSES), dtype=jnp.bfloat16, remat=False,
                        torch_port=True, **TINY)
    seg = {name: [np.asarray(s, np.float32) for s in jax.jit(m.apply)(
        j.params, j.jbatch["image"])["segmentation"]]
        for name, m in (("float32", j.model), ("bfloat16", jm16))}
    return dict(batch=j.batch, pth=j.pth, seg=seg)


@pytest.fixture(scope="module")
def ref_grads(jax_side):
    """The JAX model's ``loss="dice"`` terms and gradients, float32."""
    j = jax_side
    (_, losses), grads = jax.jit(
        jax.value_and_grad(jax_loss_fn, has_aux=True),
        static_argnums=(1, 3, 4))(j.params, j.model, j.jbatch,
                                  JLesionChannelMap.from_classes(CLASSES),
                                  JLossConfig(loss="dice"))
    return dict(batch=j.batch, pth=j.pth,
                losses={k: float(v) for k, v in losses.items()},
                grads=_flat_np(grads["params"]))


def _imported(pth, dtype, torch_port=True):
    """The reference-layout state_dict through the port's converter into a
    port MedFormer (strict load)."""
    tree, missing, unused = tport.convert_state_dict(
        {"module." + k: v for k, v in pth.items()}, **_keymap_kwargs(TINY))
    assert missing == [] and unused == []
    model = get_model("medformer", len(CLASSES),
                      {**TINY, "remat": False, "torch_port": torch_port},
                      dtype=dtype)
    model.load_state_dict(params_from_flax(tree), strict=True)
    return model


def _err(got, ref):
    err = float(np.abs(got - ref).max())
    mx = float(np.abs(ref).max())
    return err, mx, float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("margs", [
    {}, TINY, {**TINY, "classification": True, "clip": True},
    {"classification": True, "aux_loss": False}])
def test_key_map_matches_jax(margs):
    kw = _keymap_kwargs(margs)
    kw.update({k: margs[k] for k in ("classification", "clip", "aux_loss")
               if k in margs})
    got = [(tk, path) for tk, path, _ in tport.medformer_key_map(**kw)]
    want = [(tk, path) for tk, path, _ in jtp.medformer_key_map(**kw)]
    assert got == want and len(got) > 100


@pytest.mark.parametrize("margs", [
    {"classification_classes": 3, "clip_branch": True},
    {**TINY, "classification_classes": 2, "clip_branch": True,
     "clip_feats": 16}])
def test_conversion_is_jax_bit_for_bit_and_round_trips(margs):
    """Seeded port parameters exported to the reference layout and converted
    back, on both sides: every array equal, and the round trip exact."""
    model = init_params(get_model("medformer", 5, margs), seed=2)
    state = model.state_dict()
    flat = flax_from_state_dict(state)
    kw = dict(_keymap_kwargs(margs), classification=True, clip=True)
    got = tport.export_state_dict(flat, **kw)
    want = jtp.export_state_dict(_nest(flat), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tree, missing, unused = tport.convert_state_dict(got, **kw)
    jtree, _, _ = jtp.convert_state_dict(want, **kw)
    assert missing == unused == []
    a, b = _flat_np(tree), _flat_np(jtree)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = params_from_flax(tree, model)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    again = tport.export_state_dict({"params": tree}, **kw)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)


@pytest.mark.parametrize("layout", ["cl", "cf"])
def test_align_corners_resize_matches_jax(layout):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 7, 4)).astype(np.float32)
    for size in ((9, 13, 6), (5, 4, 11), (1, 7, 2)):
        if layout == "cl":
            ref = jlayers.resize_trilinear(jnp.asarray(x), size,
                                           align_corners=True)
            got = tlayers.resize_trilinear(torch.from_numpy(x), size,
                                           align_corners=True)
        else:  # (B, D, C, H, W): C = 3 stays
            ref = jlayers.resize_trilinear_cf(jnp.asarray(x), size,
                                              align_corners=True)
            got = tlayers.resize_trilinear_cf(torch.from_numpy(x), size,
                                              align_corners=True)
        assert tuple(got.shape) == tuple(ref.shape)
        ref = np.asarray(ref)
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= RESIZE_TOL * (1 + float(np.abs(ref).max())), \
            (layout, size, err)


def test_torch_port_float32_forward_matches_jax(ref):
    x = torch.from_numpy(ref["batch"]["image"])
    with torch.inference_mode():
        seg = _imported(ref["pth"], torch.float32)(x)["segmentation"]
        default = _imported(ref["pth"], torch.float32, torch_port=False)(x)
    for name, got, want, other in zip(("logits", "aux"), seg,
                                      ref["seg"]["float32"],
                                      default["segmentation"]):
        err, mx, _ = _err(got.numpy(), want)
        assert err <= F32_TOL * (1 + mx), f"{name}: {err} vs {mx}"
        # the default numerics compute another function of these weights
        assert _err(other.numpy(), want)[0] > 10 * F32_TOL * (1 + mx), name


def test_torch_port_bfloat16_forward_matches_jax(ref):
    x = torch.from_numpy(ref["batch"]["image"])
    with torch.inference_mode():
        seg = _imported(ref["pth"], torch.bfloat16)(x)["segmentation"]
    for i, name in enumerate(("logits", "aux")):
        g = seg[i].float().numpy()
        assert np.isfinite(g).all()
        err, mx, _ = _err(g, ref["seg"]["bfloat16"][i])
        assert err <= BF16_TOL * (1 + mx), f"{name}: {err} vs {mx}"
        err32, _, rel32 = _err(g, ref["seg"]["float32"][i])
        noise, _, noise_rel = _err(ref["seg"]["bfloat16"][i],
                                   ref["seg"]["float32"][i])
        assert err32 <= BF16_NOISE_FACTOR * noise, f"{name}: {err32} {noise}"
        assert rel32 <= BF16_NOISE_FACTOR * noise_rel, name


def test_torch_port_step_gradients_match_jax(ref_grads):
    ref = ref_grads
    model = _imported(ref["pth"], torch.float32).train()
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    overall, losses = loss_fn(model, batch,
                              LesionChannelMap.from_classes(CLASSES),
                              LossConfig(loss="dice"))
    overall.backward()
    for k, v in ref["losses"].items():
        assert abs(float(losses[k].detach()) - v) <= 1e-4 * abs(v), (k, v)
    want = params_from_flax(ref["grads"], model)
    top = max(float(w.norm()) for w in want.values())
    for k, p in model.named_parameters():
        err = float((p.grad - want[k]).norm())
        bound = GRAD_TOL * (float(want[k].norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{k}: ‖Δ‖ {err} > {bound}"


TINY4 = {**TINY, "expansion": 4}  # the converter's models: expansion 4


def _cli_flags():
    return ["--base_chan", "4", "--chan_num", "8,16,32,40,32,16,8,4",
            "--trans_num", "0,1,2,1,1,1,0,0", "--num_heads",
            "1,2,2,2,2,2,1,1", "--fusion_depth", "1", "--fusion_dim", "40",
            "--fusion_heads", "2"]


def test_convert_checkpoint_cli(tmp_path):
    """A reference trainer's ``.pth`` (DDP and compile prefixes, an EMA
    copy), a bare state_dict and an ``.npz`` become port checkpoint
    directories holding exactly the exported parameters; ``--ema`` of a
    bare one raises."""
    states = [init_params(get_model("medformer", 3, TINY4), seed=s)
              .state_dict() for s in (0, 1)]
    kw = _keymap_kwargs(TINY4)
    ref_sd = [tport.export_state_dict(flax_from_state_dict(s), **kw)
              for s in states]
    torch.save({"model_state_dict": {"module." + k: torch.from_numpy(v)
                                     for k, v in ref_sd[0].items()},
                "ema_model_state_dict": {"_orig_mod." + k: torch.from_numpy(v)
                                         for k, v in ref_sd[1].items()},
                "epoch": 3}, tmp_path / "model.pth")
    torch.save({k: torch.from_numpy(v) for k, v in ref_sd[0].items()},
               tmp_path / "bare.pth")
    np.savez(tmp_path / "sd.npz", **ref_sd[1])
    runs = [("model.pth", [], 0), ("model.pth", ["--ema"], 1),
            ("bare.pth", [], 0), ("sd.npz", [], 1)]
    for i, (src, extra, which) in enumerate(runs):
        out = tmp_path / f"out{i}"
        convert_checkpoint.main([str(tmp_path / src), str(out)]
                                + _cli_flags() + extra)
        for got in (load_params(str(out)), _donor_params(str(out))):
            assert sorted(got) == sorted(states[which])
            assert all(torch.equal(got[k], v)
                       for k, v in states[which].items())
        info = json.loads((out / "convert_info.json").read_text())
        assert info["ema"] == bool(extra) and info["missing"] == []
        assert info["unused"] == []
    with pytest.raises(ValueError, match="EMA"):
        convert_checkpoint.main([str(tmp_path / "bare.pth"),
                                 str(tmp_path / "x")] + _cli_flags()
                                + ["--ema"])
    with pytest.raises(RuntimeError, match="size mismatch"):
        convert_checkpoint.main([str(tmp_path / "bare.pth"),
                                 str(tmp_path / "y"), "--classes", "4"]
                                + _cli_flags())
    assert not (tmp_path / "y").exists()
