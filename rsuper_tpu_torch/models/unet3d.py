"""3D UNet / ResUNet (counterpart of ``rsuper_tpu/models/unet3d.py``),
channels-last.

An encoder of ``Conv_0`` + one block + 4 down blocks (channel multipliers
1, 2, 4, 8, 10 × base), a mirrored decoder that upsamples trilinearly and
concatenates the skip, and a 1×1×1 class head ``outc``. ``block=
"BasicBlock"`` is the ResUNet of the ``abdomenatlas/resunet_3d`` preset;
``unet`` stages are post-activated ``ConvNormAct``s; ``Bottleneck``,
``MBConv`` and ``FusedMBConv`` stages are the other blocks of
``layers.BLOCKS``. Downsampling is a
strided first block (flax SAME padding, ``layers.same_pads``) or, with
``pool``, a VALID max pool. ``aux_head`` adds the 1×1×1 ``aux_out`` head on
the second decoder stage, resized to the input.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BLOCKS, Conv, Conv1, resize_trilinear


def _scale3(s):
    return (s,) * 3 if isinstance(s, int) else tuple(s)


def _block(name: str):
    if name not in BLOCKS:
        raise ValueError(f"unknown UNet block {name!r}; the blocks are "
                         f"{sorted(BLOCKS)}")
    return BLOCKS[name]


def max_pool(x, scale):
    """flax ``nn.max_pool(x, scale, strides=scale)`` (VALID: odd sizes
    floor) on (B, D, H, W, C)."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), scale, scale)
    return y.permute(0, 2, 3, 4, 1)


class DownBlock(nn.Module):
    def __init__(self, c_in: int, features: int, num_blocks: int = 2,
                 block: str = "BasicBlock", pool: bool = True,
                 down_scale: Any = 2, kernel_size: Any = 3, norm: str = "in",
                 dtype=torch.float32):
        super().__init__()
        Block = _block(block)
        scale = _scale3(down_scale)
        self.pool = scale if pool else None
        self.names = [f"{block}_{i}" for i in range(num_blocks)]
        for i, name in enumerate(self.names):
            strides = scale[0] if i == 0 and not pool else 1
            self.add_module(name, Block(
                c_in if i == 0 else features, features,
                kernel_size=kernel_size, strides=strides, norm=norm,
                dtype=dtype))

    def forward(self, x):
        if self.pool is not None:
            x = max_pool(x, self.pool)
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class UpBlock(nn.Module):
    def __init__(self, c_low: int, c_skip: int, features: int,
                 num_blocks: int = 2, block: str = "BasicBlock",
                 kernel_size: Any = 3, norm: str = "in", dtype=torch.float32):
        super().__init__()
        Block = _block(block)
        self.names = [f"{block}_{i}" for i in range(num_blocks)]
        for i, name in enumerate(self.names):
            self.add_module(name, Block(
                c_low + c_skip if i == 0 else features, features,
                kernel_size=kernel_size, norm=norm, dtype=dtype))

    def forward(self, x_low, x_skip):
        x = resize_trilinear(x_low, x_skip.shape[1:4])
        x = torch.cat([x, x_skip.to(x.dtype)], dim=-1)
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class UNet3D(nn.Module):
    """(B, D, H, W, 1) → ``{"segmentation": logits}`` (or ``[logits, aux]``
    with ``aux_head``), channels-last, in ``dtype``."""

    def __init__(self, num_classes: int, base_chan: int = 32,
                 block: str = "BasicBlock", pool: bool = False,
                 norm: str = "in", scale: Sequence[Any] = (2, 2, 2, 2),
                 kernel_size: Sequence[Any] = (3, 3, 3, 3, 3),
                 aux_head: bool = False, dtype=torch.float32):
        super().__init__()
        b = base_chan
        Block = _block(block)
        self.aux_head, self.dtype = aux_head, dtype
        self.Conv_0 = Conv(1, b, 3, use_bias=False, dtype=dtype)
        self.stem = f"{block}_0"
        self.add_module(self.stem, Block(b, b, kernel_size=kernel_size[0],
                                         norm=norm, dtype=dtype))
        chans = [b, 2 * b, 4 * b, 8 * b, 10 * b]
        for i in range(4):
            self.add_module(f"DownBlock_{i}", DownBlock(
                chans[i], chans[i + 1], block=block, pool=pool,
                down_scale=scale[i], kernel_size=kernel_size[min(i + 1, 4)],
                norm=norm, dtype=dtype))
        c_low = chans[4]
        for i, c in enumerate((8 * b, 4 * b, 2 * b, b)):
            self.add_module(f"UpBlock_{i}", UpBlock(
                c_low, chans[3 - i], c, block=block,
                kernel_size=kernel_size[3 - i], norm=norm, dtype=dtype))
            c_low = c
        if aux_head:
            self.aux_out = Conv1(4 * b, num_classes, True, dtype)
        self.outc = Conv1(b, num_classes, True, dtype)

    def forward(self, x):
        x = x.to(self.dtype)
        h = getattr(self, self.stem)(self.Conv_0(x))
        skips = [h]
        for i in range(4):
            h = getattr(self, f"DownBlock_{i}")(h)
            skips.append(h)
        out, aux = skips[-1], None
        for i in range(4):
            out = getattr(self, f"UpBlock_{i}")(out, skips[3 - i])
            if self.aux_head and i == 1:
                aux = resize_trilinear(self.aux_out(out), x.shape[1:4])
        logits = self.outc(out)
        return {"segmentation": [logits, aux] if self.aux_head else logits}
