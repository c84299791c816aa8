"""Shared 3D building blocks of MedFormer and the model zoo (counterpart
of ``rsuper_tpu/models/layers.py``).

Layouts follow the JAX package: channels-last ``(B, D, H, W, C)`` for the
``nn.Conv``-style blocks, depth-major channel-first ``(B, D, C, H, W)`` for
the ``*CF`` blocks. Parameters are float32; each block computes in the
``dtype`` it is given (bf16 on the serving path). Module and parameter names
match the flax tree so ``models/params.py`` can carry a JAX checkpoint over:

* ``kernel`` is a flax-layout conv kernel ``(3, 3, 3, C_in, C_out)`` (or
  ``(3, 3, 3, 1, C)`` depthwise) — the layout the CUDA kernels take;
* ``weight`` is a torch-layout weight: ``(C_out, C_in)`` for 1×1 convs and
  dense layers, ``(C_out, C_in, kd, kh, kw)`` for ``F.conv3d`` (``Conv``,
  the model zoo's dense convs of any kernel and stride) and
  ``(C_in, C_out, kd, kh, kw)`` for ``F.conv_transpose3d``
  (``ConvTranspose``).

Instance norm (eps 1e-4) and flax's activations in the conv blocks;
trilinear resizing with half-pixel centres, or with ``align_corners`` for
MedFormer's ``torch_port`` numerics; LayerNorm eps as the caller gives it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_cf import conv3x3x3_cf, in_relu_conv3x3x3_cf
from ..ops.dwconv import depthwise_conv3x3x3


# ----------------------------------------------------------- normalisation
class _InstanceNorm(torch.autograd.Function):
    """The JAX package's instance norm with its closed-form VJP
    (``rsuper_tpu/models/layers.py`` ``_instance_norm_fwd/_bwd``): the
    backward is dx = inv·(dy − E[dy] − y·E[dy·y]) from the saved output y
    and 1/σ, float32 means; autograd of the one-pass forward would
    differentiate E[x²] − E[x]², which cancels badly where σ ≪ |μ|."""

    @staticmethod
    def forward(ctx, x, axes, eps):
        n = math.prod(x.shape[a] for a in axes)
        x32 = x.float()
        s1 = x32.sum(dim=axes, keepdim=True)
        s2 = (x32 * x32).sum(dim=axes, keepdim=True)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = ((x32 - mean) * inv).to(x.dtype)
        ctx.save_for_backward(y, inv)
        ctx.axes = axes
        return y

    @staticmethod
    def backward(ctx, dy):
        y, inv = ctx.saved_tensors
        m1 = dy.float().mean(dim=ctx.axes, keepdim=True)
        m2 = (dy * y).float().mean(dim=ctx.axes, keepdim=True)
        dx = inv * (dy.float() - m1 - y.float() * m2)
        return dx.to(dy.dtype), None, None


def instance_norm_axes(x: torch.Tensor, spatial_axes, eps: float = 1e-4):
    """Per-sample normalisation over `spatial_axes` (no affine): float32
    one-pass stats, var = max(E[x²] − E[x]², 0), output in x's type; the
    closed-form backward of ``_InstanceNorm``."""
    return _InstanceNorm.apply(x, tuple(spatial_axes), eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-4):
    """Channels-last (B, *spatial, C) instance norm."""
    return instance_norm_axes(x, range(1, x.dim() - 1), eps)


def instance_norm_cf(x: torch.Tensor, eps: float = 1e-4):
    """Depth-major channel-first (B, D, C, H, W) instance norm."""
    return instance_norm_axes(x, (1,) + tuple(range(3, x.dim())), eps)


# -------------------------------------------------------------- primitives
class Conv1(nn.Module):
    """1×1×1 conv on the last axis (flax ``nn.Conv(features, (1, 1, 1))``):
    ``weight`` (C_out, C_in), optional ``bias``. `nd` is the number of
    spatial axes of its flax kernel (1,) * nd + (C_in, C_out): 3, or 2 in
    the 2D models."""

    def __init__(self, c_in: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, nd: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, c_in))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype, self.nd = dtype, nd

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Dense(Conv1):
    """flax ``nn.Dense`` on the last axis: a Conv1 whose flax kernel is
    (C_in, C_out)."""

    def __init__(self, c_in: int, features: int, use_bias: bool = True,
                 dtype=torch.float32):
        super().__init__(c_in, features, use_bias, dtype, nd=0)


class DepthwiseConv3(nn.Module):
    """3³ stride-1 depthwise conv through ``ops/dwconv.py`` (the CUDA kernel
    on the card); ``kernel`` (3, 3, 3, 1, C), optional ``bias`` (C,)."""

    def __init__(self, c: int, dtype=torch.float32, use_bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, 3, 1, c))
        self.bias = nn.Parameter(torch.empty(c)) if use_bias else None
        self.dtype = dtype

    def forward(self, x):
        y = depthwise_conv3x3x3(x.to(self.dtype), self.kernel)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _ntuple(v, n: int = 3):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _triple(v):
    return _ntuple(v, 3)


def is_3cubed(kernel_size) -> bool:
    """True for a 3³ kernel, given as 3 or (3, 3, 3)."""
    return _triple(kernel_size) == (3, 3, 3)


def same_pads(size, kernel, stride):
    """flax ``padding="SAME"``'s (low, high) pads of one axis: the output
    has ceil(size / stride) positions and an odd total pad puts the extra
    voxel at the high end (``lax.padtype_to_pads``). A stride-2 3³ conv on
    an even size pads (0, 1), where torch's ``padding=1`` pads (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Dense or grouped conv of any kernel and stride on channels-last
    (B, *spatial, C) tensors with flax's SAME padding (``nn.Conv``, with
    ``feature_group_count`` = `groups`), through cuDNN on the card:
    ``weight`` in torch layout (C_out, C_in / groups, *kernel), optional
    ``bias``. `nd` spatial axes: 3 (``F.conv3d``) or 2 (``F.conv2d``, the
    2D models). The channels-last tensor is handed to cuDNN as a
    channels-last view, so no layout copy is made."""

    def __init__(self, c_in: int, features: int, kernel_size=3, strides=1,
                 use_bias: bool = True, dtype=torch.float32, groups: int = 1,
                 nd: int = 3):
        super().__init__()
        self.nd, self.groups = nd, groups
        self.kernel = _ntuple(kernel_size, nd)
        self.strides = _ntuple(strides, nd)
        self.weight = nn.Parameter(torch.empty(features, c_in // groups,
                                               *self.kernel))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype).movedim(-1, 1)
        pads = [same_pads(n, k, s) for n, k, s in
                zip(x.shape[2:], self.kernel, self.strides)]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:  # F.pad's order: last axis first
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        conv = F.conv3d if self.nd == 3 else F.conv2d
        y = conv(x, self.weight.to(self.dtype), b, self.strides, padding,
                 groups=self.groups)
        return y.movedim(1, -1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (SAME padding, ``transpose_kernel=False``)
    on channels-last tensors. flax correlates the stride-dilated input with
    the kernel as it is; torch's ``conv_transpose3d`` is the same product on
    the spatially flipped kernel. ``weight`` is torch's layout
    (C_in, C_out, kd, kh, kw), holding that flipped kernel
    (``models/params.py`` flips it on the way across)."""

    def __init__(self, c_in: int, features: int, kernel_size=2, strides=2,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.kernel, self.strides = _triple(kernel_size), _triple(strides)
        # lax.conv_transpose's SAME pads (a, b) of the dilated input are
        # torch's padding k - 1 - a and output_padding b - a; b - a lies in
        # [-1, s - 1], and -1 is one voxel cropped off the high end
        pads = []
        for k, s in zip(self.kernel, self.strides):
            a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
            pads.append((k - 1 - a, k + s - 2 - 2 * a))
        self.padding = tuple(p for p, _ in pads)
        self.output_padding = tuple(max(op, 0) for _, op in pads)
        self.crop = tuple(max(-op, 0) for _, op in pads)
        self.weight = nn.Parameter(torch.empty(c_in, features, *self.kernel))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv_transpose3d(
            x.to(self.dtype).permute(0, 4, 1, 2, 3), self.weight.to(self.dtype),
            b, self.strides, self.padding, self.output_padding)
        if any(self.crop):
            d, h, w = (n - c for n, c in zip(y.shape[2:], self.crop))
            y = y[:, :, :d, :h, :w]
        return y.permute(0, 2, 3, 4, 1)


def make_norm(norm: str):
    """'in' → instance norm (eps 1e-4), 'none' → identity."""
    if norm == "in":
        return instance_norm
    if norm == "none":
        return lambda x: x
    raise ValueError(f"unsupported norm {norm!r} (use 'in' or 'none')")


def make_act(act: str):
    """flax's activations; ``gelu`` is its tanh approximation."""
    return {
        "relu": F.relu,
        "relu6": F.relu6,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "none": lambda x: x,
    }[act]


class ConvNormAct(nn.Module):
    """conv → norm → act, or with ``preact`` norm → act → conv; no bias
    unless ``use_bias``. The conv is ``DepthwiseConv3_0`` for a 3³ stride-1
    depthwise conv (groups == features == C_in), a 1×1×1 ``Conv_0``
    (``Conv1``) for a pointwise one, else a ``Conv_0`` (``Conv``, cuDNN) of
    any kernel, stride and group count, as the JAX package runs
    ``feature_group_count`` through XLA."""

    def __init__(self, c_in: int, features: int, kernel_size=3, strides=1,
                 groups: int = 1, norm: str = "in", act: str = "relu",
                 preact: bool = False, use_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        kernel, stride = _triple(kernel_size), _triple(strides)
        if (groups > 1 and groups == features == c_in
                and kernel == (3, 3, 3) and stride == (1, 1, 1)):
            self.DepthwiseConv3_0 = DepthwiseConv3(c_in, dtype, use_bias)
            self._conv = "DepthwiseConv3_0"
        elif groups == 1 and kernel == (1, 1, 1) and stride == (1, 1, 1):
            self.Conv_0 = Conv1(c_in, features, use_bias, dtype)
            self._conv = "Conv_0"
        else:
            self.Conv_0 = Conv(c_in, features, kernel, stride, use_bias,
                               dtype, groups=groups)
            self._conv = "Conv_0"
        self.norm, self.act = make_norm(norm), make_act(act)
        self.preact = preact

    def forward(self, x):
        conv = getattr(self, self._conv)
        if self.preact:
            return conv(self.act(self.norm(x)))
        return self.act(self.norm(conv(x)))


class BasicBlock(nn.Module):
    """Two pre-activated convs + shortcut (``ConvNormAct_0/1``; a
    pre-activated ``ConvNormAct_2`` shortcut when the stride or C
    changes)."""

    def __init__(self, c_in: int, features: int, kernel_size=3, strides=1,
                 norm: str = "in", act: str = "relu", dtype=torch.float32):
        super().__init__()
        kw = dict(norm=norm, act=act, preact=True, dtype=dtype)
        self.ConvNormAct_0 = ConvNormAct(c_in, features, kernel_size, strides,
                                         **kw)
        self.ConvNormAct_1 = ConvNormAct(features, features, kernel_size, 1,
                                         **kw)
        self.shortcut = _triple(strides) != (1, 1, 1) or c_in != features
        if self.shortcut:
            self.ConvNormAct_2 = ConvNormAct(c_in, features, kernel_size,
                                             strides, **kw)

    def forward(self, x):
        out = self.ConvNormAct_1(self.ConvNormAct_0(x))
        return out + (self.ConvNormAct_2(x) if self.shortcut else x)


class Bottleneck(nn.Module):
    """1×1 → k³ → 1×1 pre-activated bottleneck + shortcut."""

    def __init__(self, c_in: int, features: int, kernel_size=3, strides=1,
                 norm: str = "in", act: str = "relu", dtype=torch.float32,
                 expansion: int = 2):
        super().__init__()
        mid = features // expansion
        kw = dict(norm=norm, act=act, preact=True, dtype=dtype)
        self.ConvNormAct_0 = ConvNormAct(c_in, mid, 1, 1, **kw)
        self.ConvNormAct_1 = ConvNormAct(mid, mid, kernel_size, strides, **kw)
        self.ConvNormAct_2 = ConvNormAct(mid, features, 1, 1, **kw)
        self.shortcut = _triple(strides) != (1, 1, 1) or c_in != features
        if self.shortcut:
            self.ConvNormAct_3 = ConvNormAct(c_in, features, kernel_size,
                                             strides, **kw)

    def forward(self, x):
        out = self.ConvNormAct_2(self.ConvNormAct_1(self.ConvNormAct_0(x)))
        return out + (self.ConvNormAct_3(x) if self.shortcut else x)


class DepthwiseSeparableConv(nn.Module):
    """depthwise k³ conv + pointwise 1×1: ``DepthwiseConv3_0`` and
    ``Conv_0`` for a 3³ stride-1 depthwise conv (the CUDA kernel), else a
    grouped ``Conv_0`` (cuDNN) and the pointwise ``Conv_1``, as flax names
    them."""

    def __init__(self, c_in: int, features: int, kernel_size=3, strides=1,
                 use_bias: bool = False, dtype=torch.float32):
        super().__init__()
        if is_3cubed(kernel_size) and _triple(strides) == (1, 1, 1):
            self.DepthwiseConv3_0 = DepthwiseConv3(c_in, dtype, use_bias)
            self.Conv_0 = Conv1(c_in, features, use_bias, dtype)
            self._convs = ("DepthwiseConv3_0", "Conv_0")
        else:
            self.Conv_0 = Conv(c_in, c_in, kernel_size, strides, use_bias,
                               dtype, groups=c_in)
            self.Conv_1 = Conv1(c_in, features, use_bias, dtype)
            self._convs = ("Conv_0", "Conv_1")

    def forward(self, x):
        depthwise, pointwise = (getattr(self, n) for n in self._convs)
        return pointwise(depthwise(x))


class SEBlock(nn.Module):
    """Squeeze-and-excitation: f32 spatial mean → 1×1 → act → 1×1 → gate."""

    def __init__(self, c: int, ratio: int = 4, act: str = "relu",
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv1(c, c // ratio, True, dtype)
        self.Conv_1 = Conv1(c // ratio, c, True, dtype)
        self.act = make_act(act)

    def forward(self, x):
        axes = tuple(range(1, x.dim() - 1))
        s = x.float().mean(dim=axes, keepdim=True).to(x.dtype)
        s = self.Conv_1(self.act(self.Conv_0(s)))
        return x * torch.sigmoid(s)


class _InvertedResidual(nn.Module):
    """The ``ConvNormAct`` chain of MBConv / FusedMBConv (flax numbers them
    in call order), an optional ``SEBlock_0`` before the last, and the
    residual: the input, or a plain k³ ``ConvNormAct`` without norm and
    activation when the stride or C changes."""

    def _finish(self, convs, c_in: int, mid: int, features: int,
                kernel_size, strides, se: bool, act: str, dtype):
        self.shortcut = c_in != features or _triple(strides) != (1, 1, 1)
        if self.shortcut:
            convs.append(ConvNormAct(c_in, features, kernel_size, strides,
                                     norm="none", act="none", dtype=dtype))
        self.n_main = len(convs) - self.shortcut
        # SEBlock_0 first: `init_params` draws in registration order, and
        # this keeps the seeded default MedFormer's weights those of before
        self.se = se
        if se:
            self.SEBlock_0 = SEBlock(mid, act=act, dtype=dtype)
        for i, conv in enumerate(convs):
            self.add_module(f"ConvNormAct_{i}", conv)

    def forward(self, x):
        out = x
        for i in range(self.n_main - 1):
            out = getattr(self, f"ConvNormAct_{i}")(out)
        if self.se:
            out = self.SEBlock_0(out)
        out = getattr(self, f"ConvNormAct_{self.n_main - 1}")(out)
        res = getattr(self, f"ConvNormAct_{self.n_main}")(x) \
            if self.shortcut else x
        return out + res


class MBConv(_InvertedResidual):
    """Inverted residual with SE: expand 1×1 (unless `expansion` is 1) →
    depthwise k³ (the CUDA kernel at 3³ stride 1, else a grouped cuDNN
    conv) → SE → project 1×1, all pre-activated."""

    def __init__(self, c_in: int, features: int, expansion: int = 4,
                 kernel_size=3, strides=1, se: bool = True, norm: str = "in",
                 act: str = "relu", dtype=torch.float32):
        super().__init__()
        mid = expansion * c_in
        kw = dict(norm=norm, act=act, preact=True, dtype=dtype)
        convs = [] if expansion == 1 else [ConvNormAct(c_in, mid, 1, **kw)]
        convs.append(ConvNormAct(mid, mid, kernel_size, strides, groups=mid,
                                 **kw))
        convs.append(ConvNormAct(mid, features, 1, **{**kw, "act": "none"}))
        self._finish(convs, c_in, mid, features, kernel_size, strides, se,
                     act, dtype)


class FusedMBConv(_InvertedResidual):
    """MBConv with the expansion and the depthwise conv fused into one
    dense k³ conv → SE → project 1×1, pre-activated."""

    def __init__(self, c_in: int, features: int, expansion: int = 4,
                 kernel_size=3, strides=1, se: bool = True, norm: str = "in",
                 act: str = "relu", dtype=torch.float32):
        super().__init__()
        mid = expansion * c_in
        kw = dict(norm=norm, act=act, preact=True, dtype=dtype)
        convs = [ConvNormAct(c_in, mid, kernel_size, strides, **kw),
                 ConvNormAct(mid, features, 1, **{**kw, "act": "none"})]
        self._finish(convs, c_in, mid, features, kernel_size, strides, se,
                     act, dtype)


# the blocks a UNet or MedFormer stage can be built of: Block(c_in,
# features, kernel_size=, strides=, norm=, act=, dtype=)
BLOCKS = {
    "ConvNormAct": ConvNormAct,
    "BasicBlock": BasicBlock,
    "Bottleneck": Bottleneck,
    "MBConv": MBConv,
    "FusedMBConv": FusedMBConv,
}


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
