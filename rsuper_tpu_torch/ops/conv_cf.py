"""Channel-first 3³ convolution, plain and with a fused IN+ReLU prologue.

Counterpart of ``rsuper_tpu/ops/conv_cf.py``. Operands are depth-major
channel-first ``(B, D, C, H, W)``; weights are the flax layout
``(3, 3, 3, C_in, C_out)``. On CUDA tensors both functions launch the kernel
of ``csrc/conv_cf.cu``; on CPU tensors they run the plain versions, which
follow the JAX package's XLA fallbacks (``_conv3_cf_xla``,
``_in_relu_conv_xla``): weights rounded to the input's type, float32
compute, output in the input's type.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _in_stats_cf(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Instance-norm stats of (B, D, C, H, W) x as (B, 2, C, 1) float32:
    [:, 0] = 1/σ and [:, 1] = −μ/σ. One-pass E[x²] − E[x]², clamped at 0,
    as ``rsuper_tpu/ops/conv_cf.py:_in_stats_cf``."""
    n = x.shape[1] * x.shape[3] * x.shape[4]
    s1 = torch.sum(x, dim=(1, 3, 4), dtype=torch.float32)
    s2 = torch.sum(x * x, dim=(1, 3, 4), dtype=torch.float32)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return torch.stack([inv, -mean * inv], dim=1)[..., None]


def _conv3_cf_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3³ conv in float32 on the rounded operands, output in x's type."""
    wt = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # (Co, Ci, 3, 3, 3)
    y = F.conv3d(x.float().permute(0, 2, 1, 3, 4), wt, padding=1)
    return y.permute(0, 2, 1, 3, 4).to(x.dtype).contiguous()


def _in_relu_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """IN → ReLU → SAME conv; the activation is rounded to x's type first."""
    stats = _in_stats_cf(x, eps)
    scale = stats[:, 0, :, 0][:, None, :, None, None]
    shift = stats[:, 1, :, 0][:, None, :, None, None]
    a = torch.clamp(x.float() * scale + shift, min=0.0).to(x.dtype)
    return _conv3_cf_plain(a, w)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if w.shape[:3] != (3, 3, 3) or w.dim() != 5 or w.shape[3] != x.shape[2]:
        raise ValueError(f"w must be (3, 3, 3, {x.shape[2]}, Co), got "
                         f"{tuple(w.shape)}")


def _launch(x: torch.Tensor, w: torch.Tensor, stats) -> torch.Tensor:
    """Run csrc/conv_cf.cu on CUDA tensors; allocates the output."""
    B, D, Ci, H, W = x.shape
    Co = w.shape[-1]
    x = x.contiguous()
    wk = w.to(x.dtype).float().reshape(27, Ci, Co).contiguous()
    st = None if stats is None else stats.reshape(B, 2, Ci).contiguous()
    y = torch.empty((B, D, Co, H, W), dtype=x.dtype, device=x.device)
    lib = _build.load("conv_cf")
    fn = lib.rsuper_conv3_cf
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), wk.data_ptr(), None if st is None else st.data_ptr(),
             y.data_ptr(), B, D, Ci, Co, H, W, _DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv_cf")
    return y


def conv3x3x3_cf(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3³ conv, no bias: x (B, D, C_in, H, W), w (3, 3, 3, C_in, C_out)
    → (B, D, C_out, H, W) in x's type, float32 accumulation."""
    _check(x, w)
    if not dispatch.use_kernel(x, w):
        return _conv3_cf_plain(x, w)
    y = _launch(x, w, None)
    conv3x3x3_cf.launches += 1
    return y


def in_relu_conv3x3x3_cf(x: torch.Tensor, w: torch.Tensor,
                         eps: float = 1e-4) -> torch.Tensor:
    """``conv3x3x3_cf(relu(instance_norm(x)), w)`` with the normalisation
    and ReLU applied as the kernel stages its input (instance norm eps 1e-4,
    no affine; stats from `_in_stats_cf`)."""
    _check(x, w)
    if not dispatch.use_kernel(x, w):
        return _in_relu_conv_plain(x, w, eps)
    y = _launch(x, w, _in_stats_cf(x, eps))
    in_relu_conv3x3x3_cf.launches += 1
    return y


conv3x3x3_cf.launches = 0
in_relu_conv3x3x3_cf.launches = 0
