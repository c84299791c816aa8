"""The 2D transformer zoo (counterpart of ``rsuper_tpu/models/dim2_zoo.py``),
channels-last (B, H, W, C): Swin-UNet, UNet++ 2D and MedFormer 2D.

Window attention reshapes to (windows·B, ws², C) batched matmuls; the
shift masks and the relative-position index are built on the host with
numpy (the port's own copy of that code) and kept on the device after
their first use; cyclic shifts are ``torch.roll``; softmaxes run in
float32. Convs run on cuDNN (``dim2.conv2d``), as XLA runs the JAX
package's. A Swin block's window is min(window_size, H, W), so the shape of
its relative-position table depends on the input size: ``SwinUNet2D``
takes `img_size`, as the JAX model takes it from the input it is
initialised with.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .dim2 import (BasicBlock2D, ConvNormAct2D, conv2d, max_pool2d,
                   resize2d)
from .layers import Dense, LayerNorm, Mlp, TransformerBlock, instance_norm, \
    make_act


# --------------------------------------------------------------- 2D windows
def _window_partition2d(x, ws: int):
    """(B, H, W, C) → (B·nw, ws², C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse2d(wins, ws: int, shape):
    B, H, W, C = shape
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _shift_mask2d(dims, ws: int, shift: int) -> np.ndarray:
    """(nw, ws², ws²) additive mask of the shifted 2D windows: 0 between
    pixels of the same pre-shift region, -1e9 between regions."""
    H, W = dims
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for h in slices:
        for w in slices:
            img[:, h, w, :] = cnt
            cnt += 1
    wins = np.reshape(
        img.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4,
                                                              5),
        (-1, ws * ws),
    )
    diff = wins[:, :, None] - wins[:, None, :]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def _rel_index2d(ws: int) -> np.ndarray:
    """(ws²·ws²,) row of the relative-position table for each pair of
    pixels of a window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    return (rel[0] * (2 * ws - 1) + rel[1]).reshape(-1)


class WindowAttention2D(nn.Module):
    """Multi-head attention inside each window with the relative-position
    bias ``rel_bias`` ((2·ws − 1)², heads) and an optional shift mask."""

    def __init__(self, dim: int, heads: int, ws: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads, self.ws = dim, heads, ws
        self.Dense_0 = Dense(dim, 3 * dim, True, dtype)
        self.rel_bias = nn.Parameter(torch.empty((2 * ws - 1) ** 2, heads))
        self.Dense_1 = Dense(dim, dim, True, dtype)
        self._idx = {}  # device → the index of _rel_index2d, made once

    def forward(self, x, mask=None):
        nwB, L, _ = x.shape
        head_dim = self.dim // self.heads
        qkv = self.Dense_0(x).reshape(nwB, L, 3, self.heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q @ k.transpose(-1, -2)) * head_dim ** -0.5
        idx = self._idx.get(x.device)
        if idx is None:
            idx = self._idx[x.device] = torch.as_tensor(
                _rel_index2d(self.ws), device=x.device)
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


class SwinBlock2D(nn.Module):
    """LayerNorm → (shifted) window attention → residual → LayerNorm → Mlp
    (ratio 4) → residual. Built for an (H, W) input: its window is
    min(ws, H, W), and it shifts only when the window is larger than the
    shift, as the JAX block decides at trace time."""

    def __init__(self, dim: int, heads: int, ws: int, shift: int, hw,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.ws = min(ws, *hw)
        self.shift = shift if self.ws > shift else 0
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.WindowAttention2D_0 = WindowAttention2D(dim, heads, self.ws,
                                                     dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self._masks = {}  # (H, W, device) → the shift mask, made once

    def mask(self, dims, device):
        key = (*dims, device)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                _shift_mask2d(tuple(dims), self.ws, self.shift),
                device=device)
        return self._masks[key]

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.LayerNorm_0(x)
        mask = None
        if self.shift > 0:
            h = torch.roll(h, (-self.shift, -self.shift), dims=(1, 2))
            mask = self.mask((H, W), x.device)
        wins = self.WindowAttention2D_0(_window_partition2d(h, self.ws), mask)
        h = _window_reverse2d(wins, self.ws, (B, H, W, C))
        if self.shift > 0:
            h = torch.roll(h, (self.shift, self.shift), dims=(1, 2))
        x = x + h
        return x + self.Mlp_0(self.LayerNorm_1(x))


class PatchMerging2D(nn.Module):
    """2× down: each 2×2 neighbourhood's channels side by side, LayerNorm,
    a bias-free Dense."""

    def __init__(self, c_in: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(4 * c_in, dtype=dtype)
        self.Dense_0 = Dense(4 * c_in, out_dim, False, dtype)

    def forward(self, x):
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        return self.Dense_0(self.LayerNorm_0(x))


class PatchExpand2D(nn.Module):
    """`factor`× up: a bias-free Dense to out_dim·f², pixel shuffle,
    LayerNorm (Swin-Unet's PatchExpand)."""

    def __init__(self, c_in: int, out_dim: int, factor: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(c_in, out_dim * factor * factor, False, dtype)
        self.LayerNorm_0 = LayerNorm(out_dim, dtype=dtype)
        self.out_dim, self.factor = out_dim, factor

    def forward(self, x):
        B, H, W, _ = x.shape
        f = self.factor
        x = self.Dense_0(x).reshape(B, H, W, f, f, self.out_dim)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, H * f, W * f,
                                                self.out_dim)
        return self.LayerNorm_0(x)


class SwinUNet2D(nn.Module):
    """Patch embedding (``Conv_0``, ps×ps stride ps, + ``LayerNorm_0``) →
    Swin encoder with patch merging → mirrored decoder with patch expanding
    and a bias-free Dense over each skip concatenation → ps× expansion →
    ``outc`` (float32). The input's H and W must be multiples of
    ps·2^(stages − 1); `img_size` is the input size the model is built
    for."""

    def __init__(self, num_classes: int, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 4, patch_size: int = 4,
                 img_size=(256, 256), dtype=torch.float32):
        super().__init__()
        n, ps = len(depths), patch_size
        self.depths, self.dtype, self.n = tuple(depths), dtype, n
        dims = [embed_dim * 2 ** i for i in range(n)]
        hw = [(img_size[0] // ps >> i, img_size[1] // ps >> i)
              for i in range(n)]
        self.Conv_0 = conv2d(1, embed_dim, ps, ps, True, dtype)
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype=dtype)
        blocks = []
        for s in list(range(n)) + list(range(n - 2, -1, -1)):
            for b in range(depths[s]):
                blocks.append(SwinBlock2D(
                    dims[s], num_heads[s], window_size,
                    0 if b % 2 == 0 else window_size // 2, hw[s],
                    dtype=dtype))
        for i, block in enumerate(blocks):
            self.add_module(f"SwinBlock2D_{i}", block)
        for s in range(n - 1):
            self.add_module(f"PatchMerging2D_{s}",
                            PatchMerging2D(dims[s], dims[s + 1], dtype))
        for k, s in enumerate(range(n - 2, -1, -1)):
            self.add_module(f"PatchExpand2D_{k}",
                            PatchExpand2D(dims[s + 1], dims[s], dtype=dtype))
            self.add_module(f"Dense_{k}", Dense(2 * dims[s], dims[s], False,
                                                dtype))
        self.add_module(f"PatchExpand2D_{n - 1}",
                        PatchExpand2D(dims[0], embed_dim, ps, dtype))
        self.outc = conv2d(embed_dim, num_classes, 1, dtype=torch.float32)

    def forward(self, x):
        t = self.LayerNorm_0(self.Conv_0(x.to(self.dtype)))
        n, i, skips = self.n, 0, []
        for s in range(n):
            for _ in range(self.depths[s]):
                t = getattr(self, f"SwinBlock2D_{i}")(t)
                i += 1
            skips.append(t)
            if s < n - 1:
                t = getattr(self, f"PatchMerging2D_{s}")(t)
        for k, s in enumerate(range(n - 2, -1, -1)):
            t = getattr(self, f"PatchExpand2D_{k}")(t)
            t = getattr(self, f"Dense_{k}")(torch.cat([t, skips[s]], dim=-1))
            for _ in range(self.depths[s]):
                t = getattr(self, f"SwinBlock2D_{i}")(t)
                i += 1
        t = getattr(self, f"PatchExpand2D_{n - 1}")(t)
        return {"segmentation": self.outc(t)}


# ------------------------------------------------------------------ UNet++ 2D
class _PPBlock2D(nn.Module):
    """Two pre-activated 3×3 ConvNormAct2Ds."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.ConvNormAct2D_0 = ConvNormAct2D(c_in, features, dtype=dtype)
        self.ConvNormAct2D_1 = ConvNormAct2D(features, features, dtype=dtype)

    def forward(self, x):
        return self.ConvNormAct2D_1(self.ConvNormAct2D_0(x))


class UNetPlusPlus2D(nn.Module):
    """Nested dense skip pathways: node X^{i,j} is the module ``x{i}_{j}``;
    ``outc`` in float32."""

    def __init__(self, num_classes: int, base_chan: int = 32, depth: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        chans = [base_chan * 2 ** i for i in range(depth + 1)]
        for i in range(depth + 1):
            self.add_module(f"x{i}_0", _PPBlock2D(
                1 if i == 0 else chans[i - 1], chans[i], dtype))
        for j in range(1, depth + 1):
            for i in range(depth + 1 - j):
                self.add_module(f"x{i}_{j}", _PPBlock2D(
                    j * chans[i] + chans[i + 1], chans[i], dtype))
        self.outc = conv2d(chans[0], num_classes, 1, dtype=torch.float32)

    def forward(self, x):
        grid = {}
        h = x.to(self.dtype)
        for i in range(self.depth + 1):
            if i > 0:
                h = max_pool2d(grid[(i - 1, 0)])
            h = grid[(i, 0)] = getattr(self, f"x{i}_0")(h)
        for j in range(1, self.depth + 1):
            for i in range(self.depth + 1 - j):
                up = resize2d(grid[(i + 1, j - 1)],
                              grid[(i, 0)].shape[1:3]).to(self.dtype)
                cat = torch.cat([grid[(i, k)] for k in range(j)] + [up],
                                dim=-1)
                grid[(i, j)] = getattr(self, f"x{i}_{j}")(cat)
        return {"segmentation": self.outc(grid[(0, self.depth)])}


# --------------------------------------------------------------- MedFormer 2D
class SemanticMapGeneration2D(nn.Module):
    """Pool (B, H, W, C) into an (ms, ms, map_dim) semantic map by learned
    spatial attention: two 3×3 bias-free convs, a float32 softmax over the
    positions."""

    def __init__(self, c_in: int, map_dim: int, map_size: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.code = map_size * map_size
        self.Conv_0 = conv2d(c_in, map_dim, 3, 1, False, dtype)
        self.Conv_1 = conv2d(c_in, self.code, 3, 1, False, dtype)
        self.map_dim, self.map_size = map_dim, map_size

    def forward(self, x):
        b = x.shape[0]
        feat = self.Conv_0(x).reshape(b, -1, self.map_dim)
        weight = self.Conv_1(x).reshape(b, -1, self.code)
        weight = torch.softmax(weight.float(), dim=1).to(x.dtype)
        sem = torch.einsum("bsm,bsk->bkm", feat, weight)
        return sem.reshape(b, self.map_size, self.map_size, self.map_dim)


class BidirectionAttention2D(nn.Module):
    """Cross-attention both ways between pixel tokens and the ms² map
    tokens, 1×1 projections ``Conv_0`` … ``Conv_3`` (feature qv, map qv,
    feature out, map out)."""

    def __init__(self, feat_dim: int, map_dim: int, out_dim: int, heads: int,
                 dim_head: int, map_size: int = 8, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.Conv_0 = conv2d(feat_dim, inner * 2, 1, 1, False, dtype)
        self.Conv_1 = conv2d(map_dim, inner * 2, 1, 1, False, dtype)
        self.Conv_2 = conv2d(inner, out_dim, 1, 1, False, dtype)
        self.Conv_3 = conv2d(inner, map_dim, 1, 1, False, dtype)
        self.heads, self.dim_head, self.map_size = heads, dim_head, map_size

    def forward(self, feat, sem):
        b, h, w, _ = feat.shape
        inner = self.heads * self.dim_head

        def tokens(t):
            t = t.reshape(b, -1, 2, self.heads, self.dim_head)
            t = t.permute(2, 0, 3, 1, 4)
            return t[0], t[1]

        fq, fv = tokens(self.Conv_0(feat))
        mq, mv = tokens(self.Conv_1(sem))
        a32 = ((fq @ mq.transpose(-1, -2)) * self.dim_head ** -0.5).float()
        f2m = torch.softmax(a32, dim=-1).to(feat.dtype)
        m2f = torch.softmax(a32, dim=-2).to(feat.dtype)
        feat_out = (f2m @ mv).permute(0, 2, 1, 3).reshape(b, h, w, inner)
        map_out = (m2f.transpose(-1, -2) @ fv).permute(0, 2, 1, 3).reshape(
            b, self.map_size, self.map_size, inner)
        return self.Conv_2(feat_out), self.Conv_3(map_out)


class BidirectionAttentionBlock2D(nn.Module):
    """instance norm → bidirectional attention → residual (a 1×1
    ``ConvNormAct2D`` shortcut when C changes) → feed-forward: 1×1 expand
    (pre-activated ConvNormAct2D) → 3×3 depthwise ``Conv_0`` → norm → act →
    1×1 ``Conv_1``, residual; the map gets the map output added."""

    def __init__(self, feat_dim: int, map_dim: int, out_dim: int, heads: int,
                 dim_head: int, expansion: int = 4, map_size: int = 8,
                 act: str = "relu", dtype=torch.float32):
        super().__init__()
        self.BidirectionAttention2D_0 = BidirectionAttention2D(
            feat_dim, map_dim, out_dim, heads, dim_head, map_size, dtype)
        self.shortcut = feat_dim != out_dim
        expanded = expansion * out_dim
        convs = [ConvNormAct2D(feat_dim, out_dim, 1, dtype=dtype)] \
            if self.shortcut else []
        convs.append(ConvNormAct2D(out_dim, expanded, 1, dtype=dtype))
        for i, conv in enumerate(convs):
            self.add_module(f"ConvNormAct2D_{i}", conv)
        self.expand = f"ConvNormAct2D_{len(convs) - 1}"
        self.Conv_0 = conv2d(expanded, expanded, 3, 1, False, dtype,
                             groups=expanded)
        self.Conv_1 = conv2d(expanded, out_dim, 1, 1, False, dtype)
        self.act = make_act(act)

    def forward(self, x, sem):
        out, map_out = self.BidirectionAttention2D_0(instance_norm(x),
                                                     instance_norm(sem))
        out = out + (self.ConvNormAct2D_0(x) if self.shortcut else x)
        h = getattr(self, self.expand)(out)
        h = self.Conv_1(self.act(instance_norm(self.Conv_0(h))))
        return out + h, map_out + sem


class DownBlockMF2D(nn.Module):
    """2×2 max pool → BasicBlock2Ds (or a 1×1 ``ConvNormAct2D_0`` to the
    width without them) → (semantic map) → attention blocks."""

    def __init__(self, c_in: int, out_dim: int, conv_num: int,
                 trans_num: int, heads: int, dim_head: int, map_size: int = 8,
                 map_generate: bool = False, dtype=torch.float32):
        super().__init__()
        for i in range(conv_num):
            self.add_module(f"BasicBlock2D_{i}", BasicBlock2D(
                c_in if i == 0 else out_dim, out_dim, dtype=dtype))
        self.project = conv_num == 0 and c_in != out_dim
        if self.project:
            self.ConvNormAct2D_0 = ConvNormAct2D(c_in, out_dim, 1,
                                                 dtype=dtype)
        if map_generate:
            self.SemanticMapGeneration2D_0 = SemanticMapGeneration2D(
                out_dim, out_dim, map_size, dtype)
        for i in range(trans_num):
            self.add_module(f"BidirectionAttentionBlock2D_{i}",
                            BidirectionAttentionBlock2D(
                                out_dim, out_dim, out_dim, heads, dim_head,
                                map_size=map_size, dtype=dtype))
        self.conv_num, self.trans_num = conv_num, trans_num
        self.map_generate = map_generate

    def forward(self, x):
        x = max_pool2d(x)
        for i in range(self.conv_num):
            x = getattr(self, f"BasicBlock2D_{i}")(x)
        if self.project:
            x = self.ConvNormAct2D_0(x)
        sem = self.SemanticMapGeneration2D_0(x) if self.map_generate else None
        for i in range(self.trans_num):
            x, sem = getattr(self, f"BidirectionAttentionBlock2D_{i}")(x, sem)
        return x, sem


class UpBlockMF2D(nn.Module):
    """upsample + skip-concat → 1×1 ``ConvNormAct2D_0`` (+ map shortcut
    ``Conv_0``) → attention blocks → BasicBlock2Ds."""

    def __init__(self, c_low: int, c_skip: int, out_dim: int, conv_num: int,
                 trans_num: int, heads: int, dim_head: int, map_size: int = 8,
                 map_shortcut: bool = False, map_dims=(0, 0),
                 dtype=torch.float32):
        super().__init__()
        self.ConvNormAct2D_0 = ConvNormAct2D(c_low + c_skip, out_dim, 1,
                                             dtype=dtype)
        if map_shortcut:
            self.Conv_0 = conv2d(sum(map_dims), out_dim, 1, 1, False, dtype)
        for i in range(trans_num):
            self.add_module(f"BidirectionAttentionBlock2D_{i}",
                            BidirectionAttentionBlock2D(
                                out_dim, out_dim, out_dim, heads, dim_head,
                                map_size=map_size, dtype=dtype))
        for i in range(conv_num):
            self.add_module(f"BasicBlock2D_{i}", BasicBlock2D(
                out_dim, out_dim, dtype=dtype))
        self.conv_num, self.trans_num = conv_num, trans_num
        self.map_shortcut = map_shortcut

    def forward(self, x_low, x_skip, map_low, map_skip=None):
        x = resize2d(x_low, x_skip.shape[1:3]).to(x_low.dtype)
        feat = self.ConvNormAct2D_0(torch.cat([x, x_skip.to(x.dtype)],
                                              dim=-1))
        if self.map_shortcut and map_skip is not None:
            sem = self.Conv_0(torch.cat([map_low, map_skip], dim=-1))
        else:
            sem = map_low
        for i in range(self.trans_num):
            feat, sem = getattr(self, f"BidirectionAttentionBlock2D_{i}")(
                feat, sem)
        for i in range(self.conv_num):
            feat = getattr(self, f"BasicBlock2D_{i}")(feat)
        return feat, sem


class SemanticMapFusion2D(nn.Module):
    """Fuse the three encoder maps with a small transformer (``in_proj{i}``,
    ``TransformerBlock_0``, ``out_proj{i}``; LayerNorm eps 1e-6)."""

    def __init__(self, in_dims: Sequence[int], dim: int, heads: int,
                 depth: int = 2, dtype=torch.float32):
        super().__init__()
        for i, c in enumerate(in_dims):
            self.add_module(f"in_proj{i}", conv2d(c, dim, 1, 1, False, dtype))
            self.add_module(f"out_proj{i}", conv2d(dim, c, 1, 1, False,
                                                   dtype))
        self.TransformerBlock_0 = TransformerBlock(dim, depth, heads,
                                                   dim // heads, dim,
                                                   dtype=dtype)
        self.dim = dim

    def forward(self, maps):
        b = maps[0].shape[0]
        toks = [getattr(self, f"in_proj{i}")(m).reshape(b, -1, self.dim)
                for i, m in enumerate(maps)]
        fused = self.TransformerBlock_0(torch.cat(toks, dim=1))
        outs, start = [], 0
        for i, m in enumerate(maps):
            n = toks[i].shape[1]
            seg = fused[:, start:start + n].reshape(b, *m.shape[1:3],
                                                    self.dim)
            start += n
            outs.append(getattr(self, f"out_proj{i}")(seg))
        return outs


class MedFormer2D(nn.Module):
    """2D MedFormer: conv stem (``Conv_0`` + ``BasicBlock2D_0``), four
    pooled encoder stages (attention from the second, ms×ms semantic maps),
    map fusion, four decoder stages (map shortcuts in the first two), an
    optional ``aux_out`` head on the second, resized to the input; ``outc``
    in float32. Returns ``{"segmentation": [logits, aux]}`` with
    ``aux_loss``, else the logits."""

    def __init__(self, num_classes: int, base_chan: int = 32,
                 map_size: int = 8,
                 conv_num: Sequence[int] = (2, 1, 0, 0, 0, 1, 2, 2),
                 trans_num: Sequence[int] = (0, 1, 2, 2, 2, 1, 0, 0),
                 num_heads: Sequence[int] = (1, 4, 8, 16, 8, 4, 1, 1),
                 fusion_depth: int = 2, fusion_dim: int = 512,
                 fusion_heads: int = 16, aux_loss: bool = False,
                 dtype=torch.float32):
        super().__init__()
        b = base_chan
        ch = (2 * b, 4 * b, 8 * b, 16 * b, 8 * b, 4 * b, 2 * b, b)
        cn, tn, nh = conv_num, trans_num, num_heads
        dim_head = [ch[i] // nh[i] for i in range(8)]
        self.dtype, self.aux_loss = dtype, aux_loss
        self.Conv_0 = conv2d(1, b, 3, 1, False, dtype)
        self.BasicBlock2D_0 = BasicBlock2D(b, b, dtype=dtype)
        c_prev = b
        for i in range(4):
            self.add_module(f"DownBlockMF2D_{i}", DownBlockMF2D(
                c_prev, ch[i], cn[i], tn[i], nh[i], dim_head[i], map_size,
                map_generate=i >= 1, dtype=dtype))
            c_prev = ch[i]
        self.SemanticMapFusion2D_0 = SemanticMapFusion2D(
            (ch[1], ch[2], ch[3]), fusion_dim, fusion_heads, fusion_depth,
            dtype)
        skips = (ch[2], ch[1], ch[0], b)
        for j, i in enumerate(range(4, 8)):
            self.add_module(f"UpBlockMF2D_{j}", UpBlockMF2D(
                c_prev, skips[j], ch[i], cn[i], tn[i], nh[i], dim_head[i],
                map_size, map_shortcut=i < 6, map_dims=(ch[i - 1], skips[j]),
                dtype=dtype))
            c_prev = ch[i]
        if aux_loss:
            self.aux_out = conv2d(ch[5], num_classes, 1, dtype=dtype)
        self.outc = conv2d(b, num_classes, 1, dtype=torch.float32)

    def forward(self, x):
        x = x.to(self.dtype)
        x0 = self.BasicBlock2D_0(self.Conv_0(x))
        x1, _ = self.DownBlockMF2D_0(x0)
        x2, map2 = self.DownBlockMF2D_1(x1)
        x3, map3 = self.DownBlockMF2D_2(x2)
        x4, map4 = self.DownBlockMF2D_3(x3)
        map2, map3, map4 = self.SemanticMapFusion2D_0([map2, map3, map4])
        out, sem = self.UpBlockMF2D_0(x4, x3, map4, map3)
        out, sem = self.UpBlockMF2D_1(out, x2, sem, map2)
        aux = resize2d(self.aux_out(out), x.shape[1:3]) if self.aux_loss \
            else None
        out, sem = self.UpBlockMF2D_2(out, x1, sem)
        out, sem = self.UpBlockMF2D_3(out, x0, sem)
        logits = self.outc(out)
        return {"segmentation": [logits, aux] if self.aux_loss else logits}
