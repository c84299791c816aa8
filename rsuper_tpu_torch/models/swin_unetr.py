"""SwinUNETR (counterpart of ``rsuper_tpu/models/swin_unetr.py``),
channels-last: a 3D Swin-Transformer encoder (window attention with shifted
windows, relative position bias, patch merging) feeding a residual-conv
decoder with a skip from every stage.

Window attention reshapes to (windows·B, ws³, C) batched matmuls; the
shift mask and the relative-position index are built on the host with
numpy (the port's own copy of that code) and kept on the device after
their first use; cyclic shifts are ``torch.roll``; the softmax runs in
float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .layers import BasicBlock, Conv, Conv1, ConvTranspose, Dense, \
    LayerNorm, Mlp


def _window_partition(x, ws: int):
    """(B, D, H, W, C) → (B·nw, ws³, C)."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws, ws, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws ** 3, C)


def _window_reverse(wins, ws: int, shape):
    B, D, H, W, C = shape
    x = wins.reshape(B, D // ws, H // ws, W // ws, ws, ws, ws, C)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, C)


def _shift_mask(dims: Tuple[int, int, int], ws: int, shift: int
                ) -> np.ndarray:
    """(nw, ws³, ws³) additive mask of the shifted windows: 0 between
    voxels of the same pre-shift region, -1e9 between regions."""
    D, H, W = dims
    img = np.zeros((1, D, H, W, 1), np.float32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for d in slices:
        for h in slices:
            for w in slices:
                img[:, d, h, w, :] = cnt
                cnt += 1
    wins = np.reshape(
        img.reshape(1, D // ws, ws, H // ws, ws, W // ws, ws, 1)
        .transpose(0, 1, 3, 5, 2, 4, 6, 7),
        (-1, ws ** 3),
    )
    diff = wins[:, :, None] - wins[:, None, :]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def _rel_index(ws: int) -> np.ndarray:
    """(ws³·ws³,) row of the relative-position table for each pair of
    voxels of a window."""
    coords = np.stack(np.meshgrid(*([np.arange(ws)] * 3), indexing="ij"))
    coords = coords.reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    idx = (rel[0] * (2 * ws - 1) + rel[1]) * (2 * ws - 1) + rel[2]
    return idx.reshape(-1)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with the relative-position
    bias ``rel_bias`` ((2·ws − 1)³, heads) and an optional shift mask."""

    def __init__(self, dim: int, heads: int, ws: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads, self.ws = dim, heads, ws
        self.Dense_0 = Dense(dim, 3 * dim, True, dtype)
        self.rel_bias = nn.Parameter(torch.empty((2 * ws - 1) ** 3, heads))
        self.Dense_1 = Dense(dim, dim, True, dtype)
        self._idx = {}  # device → the index of _rel_index, made once

    def forward(self, x, mask=None):
        nwB, L, _ = x.shape
        head_dim = self.dim // self.heads
        qkv = self.Dense_0(x).reshape(nwB, L, 3, self.heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q @ k.transpose(-1, -2)) * head_dim ** -0.5
        idx = self._idx.get(x.device)
        if idx is None:
            idx = self._idx[x.device] = torch.as_tensor(
                _rel_index(self.ws), device=x.device)
        bias = self.rel_bias[idx].reshape(L, L, self.heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(nwB // nw, nw, self.heads, L, L)
            attn = attn + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(nwB, self.heads, L, L)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(nwB, L, self.dim)
        return self.Dense_1(out)


class SwinBlock(nn.Module):
    """LayerNorm → (shifted) window attention → residual → LayerNorm →
    Mlp (ratio 4) → residual; flax's LayerNorm eps 1e-6."""

    def __init__(self, dim: int, heads: int, ws: int, shift: int,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.WindowAttention_0 = WindowAttention(dim, heads, ws, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self._masks = {}  # (D, H, W, device) → the shift mask, made once

    def mask(self, dims, device):
        key = (*dims, device)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                _shift_mask(tuple(dims), self.ws, self.shift), device=device)
        return self._masks[key]

    def forward(self, x):
        B, D, H, W, C = x.shape
        h = self.LayerNorm_0(x)
        mask = None
        if self.shift > 0:
            h = torch.roll(h, (-self.shift,) * 3, dims=(1, 2, 3))
            mask = self.mask((D, H, W), x.device)
        wins = self.WindowAttention_0(_window_partition(h, self.ws), mask)
        h = _window_reverse(wins, self.ws, (B, D, H, W, C))
        if self.shift > 0:
            h = torch.roll(h, (self.shift,) * 3, dims=(1, 2, 3))
        x = x + h
        return x + self.Mlp_0(self.LayerNorm_1(x))


class SwinPatchMerging(nn.Module):
    """2× downsampling: each 2³ neighbourhood's channels side by side
    (depth, row, column offset, then channel), LayerNorm, a bias-free
    Dense."""

    def __init__(self, c_in: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(8 * c_in, dtype=dtype)
        self.Dense_0 = Dense(8 * c_in, out_dim, False, dtype)

    def forward(self, x):
        B, D, H, W, C = x.shape
        x = x.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2, C)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
            B, D // 2, H // 2, W // 2, 8 * C)
        return self.Dense_0(self.LayerNorm_0(x))


class _DecoderUp(nn.Module):
    """transposed 2³ conv, concatenate the skip, BasicBlock."""

    def __init__(self, c_in: int, c_skip: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(c_in, features, 2, 2,
                                             dtype=dtype)
        self.BasicBlock_0 = BasicBlock(features + c_skip, features,
                                       dtype=dtype)

    def forward(self, x, skip):
        x = self.ConvTranspose_0(x)
        return self.BasicBlock_0(torch.cat([x, skip.to(x.dtype)], dim=-1))


def swin_stages(module: nn.Module, dims: Sequence[int],
                depths: Sequence[int], num_heads: Sequence[int], ws: int,
                dtype, first: int = 0) -> int:
    """Add the ``SwinBlock_i`` of each stage (even blocks unshifted, odd
    ones shifted by ws // 2), numbered from `first`, to `module`; returns
    the next number."""
    i = first
    for dim, depth, heads in zip(dims, depths, num_heads):
        for b in range(depth):
            module.add_module(f"SwinBlock_{i}", SwinBlock(
                dim, heads, ws, 0 if b % 2 == 0 else ws // 2, dtype=dtype))
            i += 1
    return i


class SwinUNETR(nn.Module):
    """(B, D, H, W, 1) → ``{"segmentation": logits}``; D, H and W must be
    multiples of 16·window_size; ``outc`` in float32."""

    def __init__(self, num_classes: int, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 4, dtype=torch.float32):
        super().__init__()
        f = feature_size
        self.depths, self.dtype = tuple(depths), dtype
        dims = [f, 2 * f, 4 * f, 8 * f]
        self.Conv_0 = Conv(1, f, 2, 2, dtype=dtype)
        swin_stages(self, dims, depths, num_heads, window_size, dtype)
        for s in range(3):
            self.add_module(f"SwinPatchMerging_{s}",
                            SwinPatchMerging(dims[s], dims[s + 1], dtype))
        for i, (c_in, c) in enumerate(((1, f), (f, f), (2 * f, 2 * f),
                                       (4 * f, 4 * f), (8 * f, 8 * f))):
            self.add_module(f"BasicBlock_{i}", BasicBlock(c_in, c,
                                                          dtype=dtype))
        for i, (c_in, c) in enumerate(((8 * f, 4 * f), (4 * f, 2 * f),
                                       (2 * f, f), (f, f))):
            self.add_module(f"_DecoderUp_{i}", _DecoderUp(c_in, c, c, dtype))
        self.outc = Conv1(f, num_classes, True, torch.float32)

    def forward(self, x):
        x = x.to(self.dtype)
        t = self.Conv_0(x)
        feats, i = [], 0
        for s, depth in enumerate(self.depths):
            for _ in range(depth):
                t = getattr(self, f"SwinBlock_{i}")(t)
                i += 1
            feats.append(t)
            if s < 3:
                t = getattr(self, f"SwinPatchMerging_{s}")(t)
        enc = [self.BasicBlock_0(x)] + [
            getattr(self, f"BasicBlock_{s + 1}")(feats[s]) for s in range(3)]
        out = self.BasicBlock_4(feats[3])
        for i in range(4):
            out = getattr(self, f"_DecoderUp_{i}")(out, enc[3 - i])
        return {"segmentation": self.outc(out)}
