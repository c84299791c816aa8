"""The 2D model pathway (counterpart of ``rsuper_tpu/models/dim2.py``),
channels-last (B, H, W, C): UNet, Attention U-Net, the dual-attention UNet
(DANet head) and TransUNet.

Their convs run on cuDNN (``layers.Conv`` with two spatial axes, flax's
SAME padding), as XLA runs the JAX package's: no TPU kernel is on this
path. Instance norm (eps 1e-4) and flax's activations as in the 3D blocks;
upsampling is bilinear with half-pixel centres (``jax.image.resize``'s
``linear``, equal for upsampling) and a backward that adds the same bits
every run (``layers.resize_linear``). Module and parameter names match the
flax tree, so ``models/params.py`` carries a JAX checkpoint over (it needs
the model, for the layout of each conv).

Spatial sharding (``parallel/spatial.py``): every model and block takes an
optional ``spatial`` and then computes on the rank's run of rows (axis 1
of (B, H, W, C)), as the 3D blocks do on depth planes: the convs exchange
halo rows, the norms sum over the model group, the resizes take a
one-row halo, and a 2×2 max pool needs an even run of rows (flax floors an
odd size, a shard's floor would not be the image's). The stages that mix
every position (DANet's position and channel attention, TransUNet's token
stage) run whole on every rank, between ``gather_depth`` and
``shard_depth``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import gather_depth, shard_depth
from .layers import (Conv, Conv1, Dense, TransformerBlock, instance_norm,
                     make_act, resize_linear)


def conv2d(c_in: int, features: int, kernel: int = 3, strides: int = 1,
           use_bias: bool = True, dtype=torch.float32, groups: int = 1):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME")`` on
    (B, H, W, C): a ``Conv1`` for a 1×1 stride-1 dense conv, else a
    ``Conv``."""
    if kernel == 1 and strides == 1 and groups == 1:
        return Conv1(c_in, features, use_bias, dtype, nd=2)
    return Conv(c_in, features, kernel, strides, use_bias, dtype,
                groups=groups, nd=2)


def resize2d(x: torch.Tensor, size, spatial=None) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to `size` (half-pixel centres), its
    backward a fixed sum of taps; with `spatial` the rows of `x` and of
    `size` are the rank's."""
    return resize_linear(x, size, spatial=spatial)


def max_pool2d(x: torch.Tensor, spatial=None) -> torch.Tensor:
    """flax ``nn.max_pool(x, (2, 2), (2, 2))`` (VALID: odd sizes floor) on
    (B, H, W, C). With `spatial` the rank's run of rows must be even."""
    if spatial is not None and x.shape[1] % 2:
        raise ValueError(f"a sharded 2×2 max pool needs an even run of "
                         f"rows, got {x.shape[1]}")
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def run_whole(fn, x: torch.Tensor, spatial=None) -> torch.Tensor:
    """`fn` of the whole map of the rank's rows `x`: gathered, run on every
    rank of the group, the rank's rows of its output kept."""
    return shard_depth(fn(gather_depth(x, spatial)), spatial)


class ConvNormAct2D(nn.Module):
    """k×k conv (no bias) with instance norm and an activation, pre-activated
    (norm → act → conv) by default; ``Conv_0``."""

    def __init__(self, c_in: int, features: int, kernel: int = 3,
                 strides: int = 1, norm: str = "in", act: str = "relu",
                 preact: bool = True, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv2d(c_in, features, kernel, strides, False, dtype)
        self.norm = (instance_norm if norm == "in"
                     else (lambda v, spatial=None: v))
        self.act, self.preact = make_act(act), preact

    def forward(self, x, spatial=None):
        norm = lambda v: self.norm(v, spatial=spatial)  # noqa: E731
        if self.preact:
            return self.Conv_0(self.act(norm(x)), spatial)
        return self.act(norm(self.Conv_0(x, spatial)))


class BasicBlock2D(nn.Module):
    """Two pre-activated 3×3 ConvNormAct2Ds + shortcut (``ConvNormAct2D_2``
    when the stride or C changes)."""

    def __init__(self, c_in: int, features: int, strides: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.ConvNormAct2D_0 = ConvNormAct2D(c_in, features, strides=strides,
                                             dtype=dtype)
        self.ConvNormAct2D_1 = ConvNormAct2D(features, features, dtype=dtype)
        self.shortcut = strides != 1 or c_in != features
        if self.shortcut:
            self.ConvNormAct2D_2 = ConvNormAct2D(c_in, features,
                                                 strides=strides, dtype=dtype)

    def forward(self, x, spatial=None):
        h = self.ConvNormAct2D_1(self.ConvNormAct2D_0(x, spatial), spatial)
        return h + (self.ConvNormAct2D_2(x, spatial) if self.shortcut
                    else x)


def _add_blocks(module: nn.Module, specs, first: int = 0, dtype=None):
    """Add ``BasicBlock2D_i`` (i from `first`) for each (c_in, features,
    strides) of `specs`; returns the next number."""
    i = first
    for c_in, c, s in specs:
        module.add_module(f"BasicBlock2D_{i}", BasicBlock2D(c_in, c, s,
                                                            dtype))
        i += 1
    return i


def _decode(module: nn.Module, out, skips, first: int, spatial=None):
    """Upsample, concatenate each skip and run ``BasicBlock2D_{first+k}``
    (``stage`` blocks a skip)."""
    i = first
    for skip in skips:
        out = resize2d(out, skip.shape[1:3], spatial).to(module.dtype)
        out = torch.cat([out, skip], dim=-1)
        for _ in range(module.stage):
            out = getattr(module, f"BasicBlock2D_{i}")(out, spatial)
            i += 1
    return out


class UNet2D(nn.Module):
    """(B, H, W, 1) → ``{"segmentation": logits}``: five BasicBlock2D
    encoder stages (widths 1, 2, 4, 8, 10 × base, strided from the second),
    four decoder stages; ``outc`` in float32. The JAX registry builds
    ``resunet_2d`` as this same model."""

    stage = 1

    def __init__(self, num_classes: int, base_chan: int = 32,
                 dtype=torch.float32):
        super().__init__()
        b, self.dtype = base_chan, dtype
        enc = (b, 2 * b, 4 * b, 8 * b, 10 * b)
        i = _add_blocks(self, [(1 if k == 0 else enc[k - 1], c,
                                1 if k == 0 else 2)
                               for k, c in enumerate(enc)], dtype=dtype)
        dec, c_low = [], enc[4]
        for skip, c in zip(enc[3::-1], (8 * b, 4 * b, 2 * b, b)):
            dec.append((c_low + skip, c, 1))
            c_low = c
        _add_blocks(self, dec, i, dtype)
        self.outc = conv2d(b, num_classes, 1, dtype=torch.float32)

    def forward(self, x, spatial=None):
        h, skips = x.to(self.dtype), []
        for k in range(5):
            h = getattr(self, f"BasicBlock2D_{k}")(h, spatial)
            skips.append(h)
        out = _decode(self, h, skips[3::-1], 5, spatial)
        return {"segmentation": self.outc(out)}


class AttentionGate2D(nn.Module):
    """g (decoder) and x (skip) → x · sigmoid(conv(relu(g' + x'))); 1×1
    convs with bias, the sigmoid in float32."""

    def __init__(self, c_g: int, c_x: int, inter: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv2d(c_g, inter, 1, dtype=dtype)
        self.Conv_1 = conv2d(c_x, inter, 1, dtype=dtype)
        self.Conv_2 = conv2d(inter, 1, 1, dtype=dtype)

    def forward(self, g, x):
        # 1×1 convs and a per-pixel gate: a sharded map needs nothing
        a = self.Conv_2(torch.relu(self.Conv_0(g) + self.Conv_1(x)))
        return x * torch.sigmoid(a.float()).to(x.dtype)


class AttentionUNet2D(nn.Module):
    """Four BasicBlock2D encoder stages; each decoder stage gates its skip
    with an ``AttentionGate2D`` driven by the upsampled coarser feature."""

    def __init__(self, num_classes: int, base_chan: int = 32,
                 dtype=torch.float32):
        super().__init__()
        b, self.dtype = base_chan, dtype
        enc = (b, 2 * b, 4 * b, 8 * b)
        i = _add_blocks(self, [(1 if k == 0 else enc[k - 1], c,
                                1 if k == 0 else 2)
                               for k, c in enumerate(enc)], dtype=dtype)
        c_low = enc[3]
        for k, c in enumerate((4 * b, 2 * b, b)):
            self.add_module(f"AttentionGate2D_{k}",
                            AttentionGate2D(c_low, c, max(c // 2, 1), dtype))
            _add_blocks(self, [(c_low + c, c, 1)],
                        i + k, dtype)
            c_low = c
        self.outc = conv2d(b, num_classes, 1, dtype=torch.float32)

    def forward(self, x, spatial=None):
        h, skips = x.to(self.dtype), []
        for k in range(4):
            h = getattr(self, f"BasicBlock2D_{k}")(h, spatial)
            skips.append(h)
        out = h
        for k, skip in enumerate(skips[2::-1]):
            out = resize2d(out, skip.shape[1:3], spatial).to(self.dtype)
            gated = getattr(self, f"AttentionGate2D_{k}")(out, skip)
            out = getattr(self, f"BasicBlock2D_{4 + k}")(
                torch.cat([out, gated], dim=-1), spatial)
        return {"segmentation": self.outc(out)}


class PositionAttention2D(nn.Module):
    """DANet position attention: every position attends over all others
    with 1×1-projected queries and keys (C/8) and full-C values, blended in
    through the gate ``gamma`` (zero at initialisation); softmax in
    float32."""

    def __init__(self, c: int, reduction: int = 8, dtype=torch.float32):
        super().__init__()
        r = max(c // reduction, 1)
        self.query = conv2d(c, r, 1, dtype=dtype)
        self.key = conv2d(c, r, 1, dtype=dtype)
        self.value = conv2d(c, c, 1, dtype=dtype)
        self.gamma = nn.Parameter(torch.empty(1))

    def forward(self, x):
        B, H, W, C = x.shape
        q = self.query(x).reshape(B, H * W, -1)
        k = self.key(x).reshape(B, H * W, -1)
        v = self.value(x).reshape(B, H * W, C)
        energy = (q @ k.transpose(1, 2)).float()
        attn = torch.softmax(energy, dim=-1).to(x.dtype)
        out = (attn @ v).reshape(B, H, W, C)
        return self.gamma.to(x.dtype) * out + x


class ChannelAttention2D(nn.Module):
    """DANet channel attention: the channels' Gram matrix, sharpened as
    softmax(rowmax − energy), applied to the channel vectors; gate
    ``gamma`` (zero at initialisation)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(1))

    def forward(self, x):
        B, H, W, C = x.shape
        flat = x.reshape(B, H * W, C)
        energy = (flat.transpose(1, 2) @ flat).float()
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1).to(x.dtype)
        out = (flat @ attn.transpose(1, 2)).reshape(B, H, W, C)
        return self.gamma.to(x.dtype) * out + x


class DAHead2D(nn.Module):
    """Dual-attention head: position and channel attention branches over
    pre-activated 3×3 projections (C → C/4), each re-expanded by a 1×1
    ConvNormAct2D, summed. The JAX head also computes three class
    predictions (``fuse_out``, ``sa_out``, ``sc_out``) that its UNet
    discards; their parameters are here, and they are not computed. With
    `spatial` the projections run on the rank's rows and each attention on
    the gathered map."""

    def __init__(self, c: int, num_classes: int, dtype=torch.float32):
        super().__init__()
        inter = c // 4
        self.conv_a = ConvNormAct2D(c, inter, 3, dtype=dtype)
        self.sa = PositionAttention2D(inter, dtype=dtype)
        self.conv_a_1 = ConvNormAct2D(inter, c, 1, dtype=dtype)
        self.conv_c = ConvNormAct2D(c, inter, 3, dtype=dtype)
        self.sc = ChannelAttention2D()
        self.conv_c_1 = ConvNormAct2D(inter, c, 1, dtype=dtype)
        for name in ("fuse_out", "sa_out", "sc_out"):
            self.add_module(name, conv2d(c, num_classes, 1,
                                         dtype=torch.float32))

    def forward(self, x, spatial=None):
        sa = run_whole(self.sa, self.conv_a(x, spatial), spatial)
        sc = run_whole(self.sc, self.conv_c(x, spatial), spatial)
        return self.conv_a_1(sa, spatial) + self.conv_c_1(sc, spatial)


class DualAttentionUNet2D(nn.Module):
    """Two BasicBlock2Ds a stage (widths 1, 2, 4, 8, 16 × base, strided from
    the second stage), a ``DAHead2D`` (``da_head``) on the bottleneck, a
    mirrored decoder."""

    stage = 2

    def __init__(self, num_classes: int, base_chan: int = 32,
                 dtype=torch.float32):
        super().__init__()
        b, self.dtype = base_chan, dtype
        enc = (b, 2 * b, 4 * b, 8 * b, 16 * b)
        specs = []
        for k, c in enumerate(enc):
            specs += [(1 if k == 0 else enc[k - 1], c, 1 if k == 0 else 2),
                      (c, c, 1)]
        i = _add_blocks(self, specs, dtype=dtype)
        self.da_head = DAHead2D(enc[4], num_classes, dtype)
        dec, c_low = [], enc[4]
        for skip, c in zip(enc[3::-1], (8 * b, 4 * b, 2 * b, b)):
            dec += [(c_low + skip, c, 1), (c, c, 1)]
            c_low = c
        _add_blocks(self, dec, i, dtype)
        self.outc = conv2d(b, num_classes, 1, dtype=torch.float32)

    def forward(self, x, spatial=None):
        h, skips = x.to(self.dtype), []
        for k in range(5):
            h = getattr(self, f"BasicBlock2D_{2 * k}")(h, spatial)
            h = getattr(self, f"BasicBlock2D_{2 * k + 1}")(h, spatial)
            skips.append(h)
        out = _decode(self, self.da_head(h, spatial), skips[3::-1], 10,
                      spatial)
        return {"segmentation": self.outc(out)}


def strided_size(n: int, times: int) -> int:
    """A size after `times` stride-2 SAME convs: ceil(n / 2) each."""
    for _ in range(times):
        n = -(-n // 2)
    return n


class TransUNet2D(nn.Module):
    """CNN encoder (four BasicBlock2Ds, 8× down) → a ViT bottleneck
    (``Dense_0`` to `hidden`, the position embedding ``pos``, a
    ``TransformerBlock``) → a conv decoder. ``pos`` holds a vector for each
    position of the bottleneck, so its shape depends on the input size:
    `img_size` gives it (the JAX model takes it from the input it is
    initialised with). With `spatial` the token stage runs on the gathered
    bottleneck."""

    stage = 1

    def __init__(self, num_classes: int, base_chan: int = 32,
                 hidden: int = 256, depth: int = 4, heads: int = 8,
                 img_size=(256, 256), dtype=torch.float32):
        super().__init__()
        b, self.dtype, self.hidden = base_chan, dtype, hidden
        enc = (b, 2 * b, 4 * b, 8 * b)
        i = _add_blocks(self, [(1 if k == 0 else enc[k - 1], c,
                                1 if k == 0 else 2)
                               for k, c in enumerate(enc)], dtype=dtype)
        self.Dense_0 = Dense(enc[3], hidden, True, dtype)
        n = strided_size(img_size[0], 3) * strided_size(img_size[1], 3)
        self.pos = nn.Parameter(torch.empty(1, n, hidden))
        self.TransformerBlock_0 = TransformerBlock(
            hidden, depth, heads, hidden // heads, hidden * 2, dtype=dtype)
        dec, c_low = [], hidden
        for skip, c in zip(enc[2::-1], (4 * b, 2 * b, b)):
            dec.append((c_low + skip, c, 1))
            c_low = c
        _add_blocks(self, dec, i, dtype)
        self.outc = conv2d(b, num_classes, 1, dtype=torch.float32)

    def tokens(self, h):
        """The ViT bottleneck of the whole (B, H, W, C) map."""
        B, H, W, _ = h.shape
        if H * W != self.pos.shape[1]:
            raise ValueError(f"TransUNet2D was built for {self.pos.shape[1]} "
                             f"bottleneck positions, the input gives {H * W}"
                             ": build it with this input's img_size")
        tok = self.Dense_0(h.reshape(B, H * W, -1))
        tok = self.TransformerBlock_0(tok + self.pos.to(tok.dtype))
        return tok.reshape(B, H, W, self.hidden)

    def forward(self, x, spatial=None):
        h, skips = x.to(self.dtype), []
        for k in range(4):
            h = getattr(self, f"BasicBlock2D_{k}")(h, spatial)
            skips.append(h)
        out = _decode(self, run_whole(self.tokens, h, spatial),
                      skips[2::-1], 4, spatial)
        return {"segmentation": self.outc(out)}
