"""Attention U-Net (counterpart of ``rsuper_tpu/models/attention_unet.py``),
channels-last: a UNet whose skips pass through additive attention gates
driven by the coarser decoder feature."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv1, ConvNormAct, resize_trilinear
from .unet3d import max_pool


class AttentionGate(nn.Module):
    """g (decoder, coarser) and x (skip) → x · sigmoid(conv(relu(g' + x')));
    the sigmoid in float32."""

    def __init__(self, c_g: int, c_x: int, inter: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv1(c_g, inter, True, dtype)
        self.Conv_1 = Conv1(c_x, inter, True, dtype)
        self.Conv_2 = Conv1(inter, 1, True, dtype)

    def forward(self, g, x):
        a = torch.relu(self.Conv_0(g) + self.Conv_1(x))
        a = self.Conv_2(a)
        return x * torch.sigmoid(a.float()).to(x.dtype)


class _Double(nn.Module):
    """Two post-activated 3³ ConvNormActs (instance norm, ReLU)."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(c_in, features, 3, dtype=dtype)
        self.ConvNormAct_1 = ConvNormAct(features, features, 3, dtype=dtype)

    def forward(self, x):
        return self.ConvNormAct_1(self.ConvNormAct_0(x))


class AttentionUNet(nn.Module):
    """(B, D, H, W, 1) → ``{"segmentation": logits}``; ``outc`` in
    float32."""

    def __init__(self, num_classes: int, base_chan: int = 32,
                 dtype=torch.float32):
        super().__init__()
        b = base_chan
        self.dtype = dtype
        enc = (b, 2 * b, 4 * b, 8 * b, 10 * b)
        for i, c in enumerate(enc):
            self.add_module(f"_Double_{i}",
                            _Double(1 if i == 0 else enc[i - 1], c, dtype))
        c_low = enc[4]
        for i, c in enumerate((8 * b, 4 * b, 2 * b, b)):
            self.add_module(f"AttentionGate_{i}",
                            AttentionGate(c_low, c, max(c // 2, 1), dtype))
            self.add_module(f"_Double_{5 + i}", _Double(c_low + c, c, dtype))
            c_low = c
        self.outc = Conv1(b, num_classes, True, torch.float32)

    def forward(self, x):
        h = self._Double_0(x.to(self.dtype))
        skips = [h]
        for i in range(1, 5):
            h = getattr(self, f"_Double_{i}")(max_pool(h, (2, 2, 2)))
            skips.append(h)
        out = skips[4]
        for i in range(4):
            skip = skips[3 - i]
            out = resize_trilinear(out, skip.shape[1:4]).to(out.dtype)
            gated = getattr(self, f"AttentionGate_{i}")(out, skip)
            out = getattr(self, f"_Double_{5 + i}")(
                torch.cat([out, gated], dim=-1))
        return {"segmentation": self.outc(out)}
