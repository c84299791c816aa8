"""Shared 3D building blocks of MedFormer (counterpart of
``rsuper_tpu/models/layers.py``).

Layouts follow the JAX package: channels-last ``(B, D, H, W, C)`` for the
``nn.Conv``-style blocks, depth-major channel-first ``(B, D, C, H, W)`` for
the ``*CF`` blocks. Parameters are float32; each block computes in the
``dtype`` it is given (bf16 on the serving path). Module and parameter names
match the flax tree so ``models/params.py`` can carry a JAX checkpoint over:

* ``kernel`` is a flax-layout conv kernel ``(3, 3, 3, C_in, C_out)`` (or
  ``(3, 3, 3, 1, C)`` depthwise) — the layout the CUDA kernels take;
* ``weight`` is a torch-layout weight: ``(C_out, C_in)`` for 1×1 convs and
  dense layers, ``(C_out, C_in, 3, 3, 3)`` for ``F.conv3d``.

Instance norm (eps 1e-4) and ReLU in the conv blocks; trilinear resizing
with half-pixel centres, or with ``align_corners`` for MedFormer's
``torch_port`` numerics; LayerNorm eps as the caller gives it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_cf import conv3x3x3_cf, in_relu_conv3x3x3_cf
from ..ops.dwconv import depthwise_conv3x3x3


# ----------------------------------------------------------- normalisation
def instance_norm_axes(x: torch.Tensor, spatial_axes, eps: float = 1e-4):
    """Per-sample normalisation over `spatial_axes` (no affine): float32
    one-pass stats, var = max(E[x²] − E[x]², 0), output in x's type."""
    axes = tuple(spatial_axes)
    n = math.prod(x.shape[a] for a in axes)
    x32 = x.float()
    s1 = x32.sum(dim=axes, keepdim=True)
    s2 = (x32 * x32).sum(dim=axes, keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return ((x32 - mean) * inv).to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-4):
    """Channels-last (B, *spatial, C) instance norm."""
    return instance_norm_axes(x, range(1, x.dim() - 1), eps)


def instance_norm_cf(x: torch.Tensor, eps: float = 1e-4):
    """Depth-major channel-first (B, D, C, H, W) instance norm."""
    return instance_norm_axes(x, (1,) + tuple(range(3, x.dim())), eps)


# -------------------------------------------------------------- primitives
class Conv1(nn.Module):
    """1×1×1 conv on the last axis (flax ``nn.Conv(features, (1, 1, 1))``):
    ``weight`` (C_out, C_in), optional ``bias``."""

    def __init__(self, c_in: int, features: int, use_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, c_in))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


Dense = Conv1  # flax nn.Dense on the last axis: same parameters and math


class DepthwiseConv3(nn.Module):
    """3³ stride-1 depthwise conv through ``ops/dwconv.py`` (the CUDA kernel
    on the card); ``kernel`` (3, 3, 3, 1, C)."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, 3, 1, c))
        self.dtype = dtype

    def forward(self, x):
        return depthwise_conv3x3x3(x.to(self.dtype), self.kernel)


class ConvNormAct(nn.Module):
    """Pre-activated, channels-last: instance norm → ReLU (unless ``relu``
    is False) → conv, no bias. The conv is a 1×1 ``Conv_0`` or, for a 3³
    depthwise conv (groups == features == C_in), ``DepthwiseConv3_0``. The
    other forms of the JAX block are not on MedFormer's default path and
    are not ported."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 3,
                 groups: int = 1, relu: bool = True, dtype=torch.float32):
        super().__init__()
        if groups > 1 and groups == features == c_in and kernel_size == 3:
            self.DepthwiseConv3_0 = DepthwiseConv3(c_in, dtype)
            self._conv = "DepthwiseConv3_0"
        elif kernel_size == 1 and groups == 1:
            self.Conv_0 = Conv1(c_in, features, False, dtype)
            self._conv = "Conv_0"
        else:
            raise NotImplementedError(
                f"ConvNormAct(kernel_size={kernel_size}, groups={groups}) "
                "is not ported")
        self.relu = relu

    def forward(self, x):
        a = instance_norm(x)
        return getattr(self, self._conv)(F.relu(a) if self.relu else a)


class DepthwiseSeparableConv(nn.Module):
    """depthwise 3³ conv + pointwise 1×1 (``DepthwiseConv3_0``, ``Conv_0``)."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.DepthwiseConv3_0 = DepthwiseConv3(c_in, dtype)
        self.Conv_0 = Conv1(c_in, features, False, dtype)

    def forward(self, x):
        return self.Conv_0(self.DepthwiseConv3_0(x))


class SEBlock(nn.Module):
    """Squeeze-and-excitation: f32 spatial mean → 1×1 → ReLU → 1×1 → gate."""

    def __init__(self, c: int, ratio: int = 4, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv1(c, c // ratio, True, dtype)
        self.Conv_1 = Conv1(c // ratio, c, True, dtype)

    def forward(self, x):
        s = x.float().mean(dim=(1, 2, 3), keepdim=True).to(x.dtype)
        s = self.Conv_1(F.relu(self.Conv_0(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Inverted residual with SE: expand 1×1 → depthwise 3³ → SE → 1×1."""

    def __init__(self, c_in: int, features: int, expansion: int = 4,
                 dtype=torch.float32):
        super().__init__()
        if c_in != features:
            raise NotImplementedError("MBConv with a conv shortcut is not "
                                      "on MedFormer's path")
        mid = expansion * c_in
        # flax numbers the ConvNormActs in call order: without the expansion
        # conv, the depthwise one is ConvNormAct_0
        convs = [] if expansion == 1 else [
            ConvNormAct(c_in, mid, 1, dtype=dtype)]
        convs.append(ConvNormAct(mid, mid, 3, groups=mid, dtype=dtype))
        self.SEBlock_0 = SEBlock(mid, dtype=dtype)
        convs.append(ConvNormAct(mid, features, 1, relu=False, dtype=dtype))
        self.n_convs = len(convs)
        for i, conv in enumerate(convs):
            self.add_module(f"ConvNormAct_{i}", conv)

    def forward(self, x):
        out = x
        for i in range(self.n_convs - 1):
            out = getattr(self, f"ConvNormAct_{i}")(out)
        out = self.SEBlock_0(out)
        return getattr(self, f"ConvNormAct_{self.n_convs - 1}")(out) + x


# ------------------------------------------------------------ transformers
class Mlp(nn.Module):
    """Dense → GELU (tanh approximation, as flax's ``nn.gelu``) → Dense."""

    def __init__(self, c_in: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(c_in, hidden, True, dtype)
        self.Dense_1 = Dense(hidden, c_in, True, dtype)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class MultiHeadSelfAttention(nn.Module):
    """Softmax self-attention on (B, L, C) tokens; softmax in float32."""

    def __init__(self, c: int, heads: int, dim_head: int,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.Dense_0 = Dense(c, inner * 3, False, dtype)
        self.Dense_1 = Dense(inner, c, True, dtype)
        self.heads, self.dim_head = heads, dim_head

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.Dense_0(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        attn = (q @ k.transpose(-1, -2)) * (self.dim_head ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        return self.Dense_1(out)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics, output in ``dtype``."""

    def __init__(self, c: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.eps, self.dtype = eps, dtype

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps).to(self.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN transformer on (B, L, C) tokens."""

    def __init__(self, c: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, ln_eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for j in range(depth):
            self.add_module(f"LayerNorm_{2 * j}", LayerNorm(c, ln_eps, dtype))
            self.add_module(f"MultiHeadSelfAttention_{j}",
                            MultiHeadSelfAttention(c, heads, dim_head, dtype))
            self.add_module(f"LayerNorm_{2 * j + 1}",
                            LayerNorm(c, ln_eps, dtype))
            self.add_module(f"Mlp_{j}", Mlp(c, mlp_dim, dtype=dtype))

    def forward(self, x):
        for j in range(self.depth):
            h = getattr(self, f"LayerNorm_{2 * j}")(x)
            x = x + getattr(self, f"MultiHeadSelfAttention_{j}")(h)
            h = getattr(self, f"LayerNorm_{2 * j + 1}")(x)
            x = x + getattr(self, f"Mlp_{j}")(h)
        return x


# ------------------------------------------------------ channel-first path
class CFConv3(nn.Module):
    """3³ SAME conv on (B, D, C, H, W) through ``ops/conv_cf.py`` (the CUDA
    kernel on the card); ``kernel`` (3, 3, 3, C_in, C_out). With
    ``fuse_in_relu`` it computes conv(relu(instance_norm(x)))."""

    def __init__(self, c_in: int, features: int, fuse_in_relu: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, 3, c_in, features))
        self.fuse_in_relu, self.dtype = fuse_in_relu, dtype

    def forward(self, x):
        if self.fuse_in_relu:
            return in_relu_conv3x3x3_cf(x.to(self.dtype), self.kernel)
        return conv3x3x3_cf(x.to(self.dtype), self.kernel)


class CFConv1(Conv1):
    """1×1×1 conv on (B, D, C, H, W) tensors (``weight`` (C_out, C_in))."""

    def forward(self, x):
        y = torch.einsum("bdchw,oc->bdohw", x.to(self.dtype),
                         self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[None, None, :, None, None]
        return y


class ConvNormActCF(nn.Module):
    """Channel-first pre-activated ConvNormAct: ``Conv_0`` is a CFConv3;
    IN + ReLU run fused inside the conv kernel."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = CFConv3(c_in, features, fuse_in_relu=True, dtype=dtype)

    def forward(self, x):
        return self.Conv_0(x)


class BasicBlockCF(nn.Module):
    """Channel-first BasicBlock: two pre-activated 3³ convs + shortcut
    (``ConvNormAct_0/1``, ``ConvNormAct_2`` when C changes). When C changes,
    ConvNormAct_0 and the ConvNormAct_2 shortcut read the same activation and
    run as ONE fused kernel call on weights stacked along C_out, as in the
    JAX package."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.features = features
        self.ConvNormAct_0 = ConvNormActCF(c_in, features, dtype)
        self.ConvNormAct_1 = ConvNormActCF(features, features, dtype)
        self.pair = c_in != features
        if self.pair:
            self.ConvNormAct_2 = ConvNormActCF(c_in, features, dtype)

    def forward(self, x):
        if self.pair:
            k0 = self.ConvNormAct_0.Conv_0.kernel
            k2 = self.ConvNormAct_2.Conv_0.kernel
            both = in_relu_conv3x3x3_cf(x.to(self.ConvNormAct_0.Conv_0.dtype),
                                        torch.cat([k0, k2], dim=-1))
            out, x = both[:, :, :self.features], both[:, :, self.features:]
        else:
            out = self.ConvNormAct_0(x)
        return self.ConvNormAct_1(out) + x


# ---------------------------------------------------------------- resizing
def resize_trilinear(x: torch.Tensor, size,
                     align_corners: bool = False) -> torch.Tensor:
    """Trilinear resize of (B, D, H, W, C) to spatial `size`: half-pixel
    centres (``jax.image.resize(method="linear")``; equal for upsampling),
    or with `align_corners` output i reads input i·(n_in−1)/(n_out−1), as
    the reference's torch model upsamples (JAX ``_resize_axes_ac``)."""
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=tuple(size),
                      mode="trilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def resize_trilinear_cf(x: torch.Tensor, size,
                        align_corners: bool = False) -> torch.Tensor:
    """`resize_trilinear` for (B, D, C, H, W) tensors: D, H and W are
    resampled, C is not."""
    y = F.interpolate(x.permute(0, 2, 1, 3, 4), size=tuple(size),
                      mode="trilinear", align_corners=align_corners)
    return y.permute(0, 2, 1, 3, 4).contiguous()
