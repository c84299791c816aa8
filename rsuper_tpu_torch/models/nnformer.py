"""nnFormer and VT-UNet (counterpart of ``rsuper_tpu/models/nnformer.py``),
channels-last, on the shifted-window blocks of ``swin_unetr.py``.

nnFormer: a conv stem of two stride-2 3³ ConvNormActs (GELU), three Swin
stages with patch merging, a transformer decoder with patch expansion and
additive skips, and the deep-supervision head ``aux_out``. VT-UNet: a 2³
patch embedding, the same encoder, a decoder that concatenates each skip
and projects it with a bias-free Dense.

With a ``spatial`` argument (``parallel/spatial.py``) the conv stem (or
patch embedding) runs on the rank's planes, as the JAX model does under
``spatial_constraint``; its output is gathered, and the Swin encoder and
decoder with their patch merges and expansions run whole on every rank of
the model group (nnFormer's aux head too, whole). The last expansions to
full resolution and the head are per voxel: they take the rank's planes
of the decoder's output, so the logits come back sharded.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..parallel.spatial import gather_depth, shard_depth
from .layers import Conv, Conv1, ConvNormAct, Dense, resize_trilinear
from .swin_unetr import SwinPatchMerging, swin_stages


class _PatchExpand(nn.Module):
    """Linear 2× upsampling: a bias-free Dense to 8·out_dim, then depth to
    space (depth, row, column offset, then channel)."""

    def __init__(self, c_in: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.out_dim = out_dim
        self.Dense_0 = Dense(c_in, 8 * out_dim, False, dtype)

    def forward(self, x):
        B, D, H, W, _ = x.shape
        x = self.Dense_0(x).reshape(B, D, H, W, 2, 2, 2, self.out_dim)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(B, 2 * D, 2 * H, 2 * W, self.out_dim)


class _SwinUNet(nn.Module):
    """The encoder both models share: ``SwinBlock_0..`` of three stages
    (widths e, 2e, 4e) with ``SwinPatchMerging_0/1``, then the decoder's
    blocks of stages 1 and 0, numbered on."""

    def __init__(self, embed_dim: int, depths: Sequence[int],
                 num_heads: Sequence[int], window_size: int, dtype):
        super().__init__()
        e = embed_dim
        self.dims = (e, 2 * e, 4 * e)
        self.depths, self.dtype = tuple(depths), dtype
        n = swin_stages(self, self.dims, depths, num_heads, window_size,
                        dtype)
        for s in range(2):
            self.add_module(f"SwinPatchMerging_{s}", SwinPatchMerging(
                self.dims[s], self.dims[s + 1], dtype))
        self.n_enc = n
        swin_stages(self, self.dims[1::-1], self.depths[1::-1],
                    tuple(num_heads)[1::-1], window_size, dtype, first=n)

    def _blocks(self, x, first: int, count: int):
        for i in range(first, first + count):
            x = getattr(self, f"SwinBlock_{i}")(x)
        return x

    def encode(self, t):
        skips, i = [], 0
        for s in range(3):
            t = self._blocks(t, i, self.depths[s])
            i += self.depths[s]
            skips.append(t)
            if s < 2:
                t = getattr(self, f"SwinPatchMerging_{s}")(t)
        return skips

    def decode_stage(self, x, s):
        """The decoder's Swin blocks of stage `s` (1, then 0)."""
        first = self.n_enc + (0 if s == 1 else self.depths[1])
        return self._blocks(x, first, self.depths[s])


class NnFormer(_SwinUNet):
    """(B, D, H, W, 1) → ``{"segmentation": [logits, aux]}`` (``logits``
    alone without ``aux_loss``); D, H and W must be multiples of
    16·window_size; the heads compute in float32."""

    def __init__(self, num_classes: int, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12),
                 window_size: int = 4, aux_loss: bool = True,
                 dtype=torch.float32):
        super().__init__(embed_dim, depths, num_heads, window_size, dtype)
        e = embed_dim
        kw = dict(strides=2, act="gelu", dtype=dtype)
        self.ConvNormAct_0 = ConvNormAct(1, e // 2, 3, **kw)
        self.ConvNormAct_1 = ConvNormAct(e // 2, e, 3, **kw)
        self._PatchExpand_0 = _PatchExpand(4 * e, 2 * e, dtype)
        self._PatchExpand_1 = _PatchExpand(2 * e, e, dtype)
        self._PatchExpand_2 = _PatchExpand(e, e // 2, dtype)
        self._PatchExpand_3 = _PatchExpand(e // 2, e // 2, dtype)
        self.aux_loss = aux_loss
        if aux_loss:
            self.aux_out = Conv1(2 * e, num_classes, True, torch.float32)
        self.outc = Conv1(e // 2, num_classes, True, torch.float32)

    def forward(self, x, spatial=None):
        """With `spatial`, `x` and the logits are the rank's depth planes;
        the aux head is whole on every rank."""
        x = x.to(self.dtype)
        skips = self.encode(gather_depth(self.ConvNormAct_1(
            self.ConvNormAct_0(x, spatial), spatial), spatial))
        out, aux = skips[2], None
        size = (x.shape[1] * (1 if spatial is None else spatial.size),
                *x.shape[2:4])
        for s in (1, 0):
            out = getattr(self, f"_PatchExpand_{1 - s}")(out) + skips[s]
            out = self.decode_stage(out, s)
            if self.aux_loss and s == 1:
                aux = resize_trilinear(self.aux_out(out), size)
        out = self._PatchExpand_3(self._PatchExpand_2(shard_depth(out,
                                                                  spatial)))
        logits = self.outc(out)
        return {"segmentation": [logits, aux] if self.aux_loss else logits}


class VTUNet(_SwinUNet):
    """(B, D, H, W, 1) → ``{"segmentation": logits}``; D, H and W must be
    multiples of 8·window_size; ``outc`` in float32."""

    def __init__(self, num_classes: int, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12),
                 window_size: int = 4, dtype=torch.float32):
        super().__init__(embed_dim, depths, num_heads, window_size, dtype)
        e = embed_dim
        self.Conv_0 = Conv(1, e, 2, 2, dtype=dtype)
        self._PatchExpand_0 = _PatchExpand(4 * e, 2 * e, dtype)
        self.Dense_0 = Dense(4 * e, 2 * e, False, dtype)
        self._PatchExpand_1 = _PatchExpand(2 * e, e, dtype)
        self.Dense_1 = Dense(2 * e, e, False, dtype)
        self._PatchExpand_2 = _PatchExpand(e, e, dtype)
        self.outc = Conv1(e, num_classes, True, torch.float32)

    def forward(self, x, spatial=None):
        """With `spatial`, `x` and the logits are the rank's depth
        planes."""
        skips = self.encode(gather_depth(self.Conv_0(x.to(self.dtype),
                                                     spatial), spatial))
        out = skips[2]
        for s in (1, 0):
            out = getattr(self, f"_PatchExpand_{1 - s}")(out)
            out = getattr(self, f"Dense_{1 - s}")(
                torch.cat([out, skips[s]], dim=-1))
            out = self.decode_stage(out, s)
        return {"segmentation": self.outc(self._PatchExpand_2(
            shard_depth(out, spatial)))}
