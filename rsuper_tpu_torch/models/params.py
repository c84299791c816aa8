"""Parameters: carry a JAX (flax) MedFormer parameter tree over to the port,
or draw seeded random ones.

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
* other 3³ ``kernel`` (CF and depthwise)   → ``kernel`` unchanged (the
  layout the CUDA kernels take)
* ``bias``                                 → ``bias``
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _t_conv(w: np.ndarray) -> np.ndarray:
    """flax (kd, kh, kw, I, O) → torch Conv3d (O, I, kd, kh, kw)."""
    return np.transpose(w, (4, 3, 0, 1, 2))


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


def _convert_leaf(parts, w: np.ndarray):
    """(port name of the leaf, array in the port's layout)."""
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    grand = parts[-3] if len(parts) > 2 else ""
    if leaf == "bias":
        return "bias", w
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
                     model: nn.Module | None = None) -> Dict[str, torch.Tensor]:
    """flax parameter tree → the port's ``state_dict`` (float32 tensors).

    Every flax leaf is consumed exactly once (two leaves mapping to one port
    name raise). With `model`, every port parameter must be filled with the
    right shape and no leaf may be left over, else it raises."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    flat = _flatten(tree)  # nested and flat "a/b/kernel" trees alike
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = [_strip_checkpoint(p) for p in path.split("/")]
        name, arr = _convert_leaf(parts, np.asarray(value, dtype=np.float32))
        key = ".".join(parts[:-1] + [name])
        if key in state:
            raise KeyError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    if model is not None:
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


def load_flax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill `model` from a flax tree (strict both ways); returns `model`."""
    state = params_from_flax(tree, model)
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random parameters: LeCun-normal kernels and weights (fan-in by
    layout), zero biases, unit LayerNorm scales. Returns `model`."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
            else model
        if leaf == "bias":
            val = torch.zeros(p.shape)
        elif type(owner).__name__ == "LayerNorm":
            val = torch.ones(p.shape)
        else:
            # flax layout (..., I, O) or torch layout (O, I, ...)
            fan_in = (math.prod(p.shape[:-1]) if leaf == "kernel"
                      else math.prod(p.shape[1:]))
            val = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        p.copy_(val.to(p.device))
    return model
