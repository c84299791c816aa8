"""UNETR (counterpart of ``rsuper_tpu/models/unetr.py``), channels-last: a
ViT encoder over 16³ patches whose hidden states at four depths are
reshaped to volumes and deconvolved, merged by a residual-conv decoder.

With a ``spatial`` argument (``parallel/spatial.py``) the conv parts run
depth-sharded, as the JAX model does under ``spatial_constraint``: the
patch embedding on the rank's planes (a local depth of whole patches),
then the tokens are gathered and the ViT runs whole on every rank of the
model group; each hidden state's planes of the rank go through the deconv
chains, and the full-resolution block, the decoder and the head run
sharded (halo exchanges, group sums in the norms). The logits come back
sharded.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..parallel.spatial import gather_depth, shard_depth
from .layers import BasicBlock, Conv, Conv1, ConvTranspose, TransformerBlock

PATCH = 16


class _DeconvBlock(nn.Module):
    """`n_ups` × (transposed 2³ conv → BasicBlock)."""

    def __init__(self, c_in: int, features: int, n_ups: int,
                 dtype=torch.float32):
        super().__init__()
        self.n_ups = n_ups
        for i in range(n_ups):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(
                c_in if i == 0 else features, features, 2, 2, dtype=dtype))
            self.add_module(f"BasicBlock_{i}",
                            BasicBlock(features, features, dtype=dtype))

    def forward(self, x, spatial=None):
        for i in range(self.n_ups):
            x = getattr(self, f"ConvTranspose_{i}")(x, spatial)
            x = getattr(self, f"BasicBlock_{i}")(x, spatial)
        return x


class _UpBlock(nn.Module):
    """transposed 2³ conv, concatenate the skip, BasicBlock."""

    def __init__(self, c_in: int, c_skip: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(c_in, features, 2, 2,
                                             dtype=dtype)
        self.BasicBlock_0 = BasicBlock(features + c_skip, features,
                                       dtype=dtype)

    def forward(self, x, skip, spatial=None):
        x = self.ConvTranspose_0(x, spatial)
        return self.BasicBlock_0(torch.cat([x, skip.to(x.dtype)], dim=-1),
                                 spatial)


class UNETR(nn.Module):
    """(B, *img_size, 1) → ``{"segmentation": logits}``; ``outc`` in
    float32. The position embedding ``pos_embed`` fixes the input size."""

    def __init__(self, num_classes: int,
                 img_size: Tuple[int, int, int] = (96, 96, 96),
                 feature_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12, extract_layers: Sequence[int] = (),
                 dtype=torch.float32):
        super().__init__()
        self.grid = tuple(s // PATCH for s in img_size)
        n_tokens = self.grid[0] * self.grid[1] * self.grid[2]
        self.hidden, self.num_layers, self.dtype = hidden_size, num_layers, \
            dtype
        self.extract = tuple(extract_layers) or tuple(
            num_layers // 4 * k for k in (1, 2, 3, 4))
        self.Conv_0 = Conv(1, hidden_size, PATCH, PATCH, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, hidden_size))
        for i in range(num_layers):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(
                hidden_size, 1, num_heads, hidden_size // num_heads, mlp_dim,
                dtype=dtype))
        f = feature_size
        self.BasicBlock_0 = BasicBlock(1, f, dtype=dtype)
        for i, (c, n) in enumerate(((2 * f, 3), (4 * f, 2), (8 * f, 1))):
            self.add_module(f"_DeconvBlock_{i}",
                            _DeconvBlock(hidden_size, c, n, dtype))
        c_in = hidden_size
        for i, c in enumerate((8 * f, 4 * f, 2 * f, f)):
            self.add_module(f"_UpBlock_{i}", _UpBlock(c_in, c, c, dtype))
            c_in = c
        self.outc = Conv1(f, num_classes, True, torch.float32)

    def forward(self, x, spatial=None):
        """With `spatial`, `x` and the logits are the rank's depth
        planes."""
        B = x.shape[0]
        x = x.to(self.dtype)
        tok = gather_depth(self.Conv_0(x, spatial), spatial)
        tok = tok.reshape(B, -1, self.hidden) + self.pos_embed.to(tok.dtype)
        hidden = []
        for i in range(self.num_layers):
            tok = getattr(self, f"TransformerBlock_{i}")(tok)
            if i + 1 in self.extract:
                hidden.append(shard_depth(
                    tok.reshape(B, *self.grid, self.hidden), spatial))
        enc = [self.BasicBlock_0(x, spatial)] + [
            getattr(self, f"_DeconvBlock_{i}")(hidden[i], spatial)
            for i in range(3)]
        out = hidden[3]
        for i in range(4):
            out = getattr(self, f"_UpBlock_{i}")(out, enc[3 - i], spatial)
        return {"segmentation": self.outc(out)}
