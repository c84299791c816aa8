"""Parameters: carry a JAX (flax) parameter tree of MedFormer or of the
model zoo over to the port, or draw seeded random ones.

``params_from_flax`` takes the tree as nested dicts of arrays or as a flat
``{"a/b/kernel": array}`` mapping (the ``--params_npz`` file of
``tools/export_params_npz.py``) and returns the port's ``state_dict``. The
module paths are the same in both packages (flax's ``Checkpoint`` prefix of
rematerialised blocks is dropped); each leaf is renamed and re-laid-out by
its kind:

* ``LayerNorm_*/scale``                    → ``weight``
* ``Dense_*/kernel`` (I, O)                → ``weight`` (O, I)
* 1×1×1 conv ``kernel`` (1, 1, 1, I, O)    → ``weight`` (O, I)
* ``SemanticMapGeneration_*/Conv_*/kernel`` → ``weight`` (O, I, 3, 3, 3)
* ``kernel`` of a port ``Conv`` (dense and grouped convs of any kernel
  and stride, 3D and 2D)                   → ``weight`` (O, I/g, *kernel)
* ``kernel`` of a port ``Conv1`` or ``Dense`` (1×1 convs, 2D ones too)
                                           → ``weight`` (O, I)
* ``kernel`` of a port ``ConvTranspose``   → ``weight`` (I, O, kd, kh, kw),
  spatially flipped (flax does not flip a transposed conv's kernel; torch
  does)
* other 3³ ``kernel`` (CF and depthwise)   → ``kernel`` unchanged (the
  layout the CUDA kernels take)
* ``bias``, ``alpha`` (PReLU), ``rel_bias`` (Swin's relative-position
  table), ``pos_embed`` (UNETR), ``pos`` (TransUNet 2D), ``gamma``
  (DANet's gates)                          → unchanged

The owner of a zoo conv's kernel is found in `model`, so a zoo tree needs
it, and so does a MedFormer whose blocks leave the default's (grouped and
non-3³ convs); the default MedFormer's rules go by name alone.

The mapping is a pure re-layout, so it carries any tree of the parameters'
structure across: a JAX gradient tree, the EMA tree, Adam's moments.
``flax_from_state_dict`` is its inverse, and ``train_state_from_jax`` fills a
port train state (parameters, EMA copy, AdamW moments and step) from the JAX
package's, so that the next step of both packages agrees.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .layers import Conv, Conv1, ConvTranspose


def _t_conv(w: np.ndarray) -> np.ndarray:
    """flax (*kernel, I, O) → torch (O, I, *kernel): Conv3d's (O, I, kd,
    kh, kw), Conv2d's (O, I, kh, kw); I is C_in / groups."""
    n = w.ndim - 2
    return np.transpose(w, (n + 1, n, *range(n)))


def _t_linear(w: np.ndarray) -> np.ndarray:
    """flax Dense (I, O) ↔ torch Linear (O, I)."""
    return np.transpose(w, (1, 0))


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _strip_checkpoint(part: str) -> str:
    return part[len("Checkpoint"):] if part.startswith("Checkpoint") else part


def _t_conv_transpose(w: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (kd, kh, kw, I, O) → torch (I, O, kd, kh, kw) of
    the flipped kernel."""
    return np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


_UNCHANGED = ("bias", "alpha", "rel_bias", "pos_embed", "pos", "gamma")


def _owner(model, parts):
    """The port module that holds the leaf at `parts`, or None."""
    if model is None:
        return None
    try:
        return model.get_submodule(".".join(parts[:-1]))
    except AttributeError:
        return None


def _convert_leaf(parts, w: np.ndarray, owner=None):
    """(port name of the leaf, array in the port's layout); `owner` is the
    port module that holds it, where known."""
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    grand = parts[-3] if len(parts) > 2 else ""
    if leaf in _UNCHANGED:
        return leaf, w
    if leaf == "kernel" and isinstance(owner, ConvTranspose):
        return "weight", _t_conv_transpose(w)
    if leaf == "kernel" and isinstance(owner, Conv):
        return "weight", _t_conv(w)
    if leaf == "kernel" and isinstance(owner, Conv1):
        return "weight", _t_linear(w.reshape(w.shape[-2:]))
    if leaf == "scale" and parent.startswith("LayerNorm"):
        return "weight", w
    if leaf == "kernel" and w.ndim == 2 and parent.startswith("Dense"):
        return "weight", _t_linear(w)
    if leaf == "kernel" and w.ndim == 5:
        if w.shape[:3] == (1, 1, 1):
            return "weight", _t_conv(w)[:, :, 0, 0, 0]
        if grand.startswith("SemanticMapGeneration"):
            return "weight", _t_conv(w)
        return "kernel", w
    raise KeyError(f"no rule for flax leaf {'/'.join(parts)} {w.shape}")


def params_from_flax(tree: Mapping[str, Any],
                     model: nn.Module | None = None,
                     strict: bool = True) -> Dict[str, torch.Tensor]:
    """flax parameter tree → the port's ``state_dict`` (float32 tensors).

    Every flax leaf is consumed exactly once (two leaves mapping to one port
    name raise). With `model` (which a zoo tree needs, for the layout of its
    convs), every port parameter must be filled with the right shape and no
    leaf may be left over, else it raises; unless not `strict`, as for a
    warm start's donor of other classes."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    flat = _flatten(tree)  # nested and flat "a/b/kernel" trees alike
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = [_strip_checkpoint(p) for p in path.split("/")]
        name, arr = _convert_leaf(parts, np.asarray(value, dtype=np.float32),
                                  _owner(model, parts))
        key = ".".join(parts[:-1] + [name])
        if key in state:
            raise KeyError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    if model is not None and strict:
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if missing or extra:
            raise KeyError(f"flax tree does not match the model: "
                           f"missing {missing[:10]}, extra {extra[:10]}")
        bad = [k for k in want if tuple(state[k].shape) != want[k]]
        if bad:
            raise ValueError(f"shape mismatch: " + ", ".join(
                f"{k} {tuple(state[k].shape)} vs {want[k]}" for k in bad[:10]))
    return state


_REMAT_BLOCKS = ("DownBlockMF_0", "DownBlockMF_1", "DownBlockMF_2",
                 "DownBlockMF_3", "UpBlockMF_0", "UpBlockMF_1")


def flax_from_state_dict(state: Mapping[str, torch.Tensor],
                         remat: bool = False,
                         model: nn.Module | None = None
                         ) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` (or any mapping of its parameter names, such
    as gradients) → a flat flax tree ``{"a/b/kernel": array}`` (float32): the
    inverse of ``params_from_flax``. With `remat` the blocks that flax names
    with a ``Checkpoint`` prefix under ``nn.remat`` get it back. A 2D
    model's 1×1 convs need `model` (their flax kernels are (1, 1, I, O))."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        parts = key.split(".")
        leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
        w = value.detach().cpu().float().numpy()
        owner = _owner(model, parts)
        if leaf == "weight" and w.ndim == 5 and parent.startswith(
                "ConvTranspose"):
            leaf, w = "kernel", np.transpose(w, (2, 3, 4, 0, 1))[::-1, ::-1,
                                                                 ::-1]
        elif leaf == "weight" and w.ndim == 1:
            leaf = "scale"
        elif leaf == "weight" and w.ndim == 2 and isinstance(owner, Conv1):
            leaf, w = "kernel", _t_linear(w).reshape((1,) * owner.nd
                                                      + w.shape[::-1])
        elif leaf == "weight" and w.ndim == 2 and parent.startswith("Dense"):
            leaf, w = "kernel", _t_linear(w)
        elif leaf == "weight" and w.ndim == 2:
            leaf, w = "kernel", _t_linear(w)[None, None, None]
        elif leaf == "weight" and w.ndim in (4, 5):
            n = w.ndim - 2
            leaf, w = "kernel", np.transpose(w, (*range(2, n + 2), 1, 0))
        elif leaf != "kernel" and leaf not in _UNCHANGED:
            raise KeyError(f"no rule for port parameter {key} {w.shape}")
        if remat and parts[0] in _REMAT_BLOCKS:
            parts = ["Checkpoint" + parts[0]] + parts[1:]
        flat["/".join(parts[:-1] + [leaf])] = np.ascontiguousarray(w)
    return flat


def train_state_from_jax(state, params, ema_params=None, mu=None, nu=None,
                         count: int = 0, step: int = 0):
    """Fill a port ``TrainState`` from the JAX package's (flax trees of numpy
    arrays): the parameters, the EMA copy, AdamW's first and second moments
    (optax ``ScaleByAdamState.mu`` / ``.nu``) with its update count, and the
    step counter. Returns `state`."""
    model = state.model
    load_flax_params(model, params)
    dev = next(model.parameters()).device
    if ema_params is not None:
        state.ema_params = {k: v.to(dev) for k, v in
                            params_from_flax(ema_params, model).items()}
    if mu is not None:
        m = params_from_flax(mu, model)
        v = params_from_flax(nu, model)
        opt = state.optimizer.opt
        for name, p in model.named_parameters():
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": m[name].to(dev),
                "exp_avg_sq": v[name].to(dev),
            }
    state.step = int(step)
    return state


def load_flax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill `model` from a flax tree (strict both ways); returns `model`."""
    state = params_from_flax(tree, model)
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random parameters, with flax's initialisers: LeCun-normal
    kernels and weights (fan-in by layout), zero biases and DANet gates,
    unit LayerNorm scales, PReLU slopes 0.25, and normal(0.02) for Swin's
    relative-position tables and the position embeddings of UNETR and
    TransUNet 2D. Returns `model`."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
            else model
        if leaf in ("bias", "gamma"):
            val = torch.zeros(p.shape)
        elif type(owner).__name__ == "LayerNorm":
            val = torch.ones(p.shape)
        elif leaf == "alpha":
            val = torch.full(p.shape, 0.25)
        elif leaf in ("rel_bias", "pos_embed", "pos"):
            val = 0.02 * torch.randn(p.shape, generator=gen)
        else:
            # flax layout (..., I, O), torch layout (O, I, ...) or a
            # transposed conv's (I, O, ...)
            if leaf == "kernel":
                fan_in = math.prod(p.shape[:-1])
            elif isinstance(owner, ConvTranspose):
                fan_in = p.shape[0] * math.prod(p.shape[2:])
            else:
                fan_in = math.prod(p.shape[1:])
            val = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        p.copy_(val.to(p.device))
    return model
