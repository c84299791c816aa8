"""Channels-last depthwise 3³ convolution.

Counterpart of ``rsuper_tpu/ops/dwconv.py``. x is ``(B, D, H, W, C)`` and w
the flax depthwise kernel ``(3, 3, 3, 1, C)``. On CUDA tensors the function
launches the kernel of ``csrc/dwconv.cu`` for every C (the TPU gate
``dw_supported`` — C % 128 and a VMEM budget — does not apply); on CPU
tensors it runs the plain version: weights rounded to x's type, 27 shifted
multiply-adds in float32, output in x's type (the semantics of ``_dw_xla``).

The function is differentiable. On CUDA tensors a ``torch.autograd.Function``
runs ``depthwise_conv3x3x3_bwd``: dx by the same stencil kernel on dy with
flipped taps, dw by the reduction kernel of ``csrc/dwconv_bwd.cu``. The
backward follows ``_dw_xla`` as the forward does: the weights the stencil
sees are rounded to x's type, and the weight gradient is rounded to x's type
before it is cast to the parameter's (the JAX package's Pallas path keeps
both in float32). On CPU tensors autograd differentiates the plain version;
``_dw_bwd_plain`` is what the backward kernels are held against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dw_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, D, H, W, C = x.shape
    w27 = w.to(x.dtype).float().reshape(27, C)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((B, D, H, W, C), dtype=torch.float32, device=x.device)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                acc += (xp[:, kd:kd + D, kh:kh + H, kw:kw + W]
                        * w27[(kd * 3 + kh) * 3 + kw])
    return acc.to(x.dtype)


def _dw_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx in x's type, dw (27, C) float32): dx[q] = Σ_k w[k]·dy[q−(k−1)]
    with w rounded to x's type, dw[k] = Σ_q x[q]·dy[q−(k−1)]; 27 shifted
    products in float32."""
    B, D, H, W, C = x.shape
    w27 = w.to(x.dtype).float().reshape(27, C)
    gp = F.pad(dy.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    x32 = x.float()
    dx = torch.zeros_like(x32)
    dw = []
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                # dy[q − (k − 1)] is the padded dy at offset 2 − k
                g = gp[:, 2 - kd:2 - kd + D, 2 - kh:2 - kh + H,
                       2 - kw:2 - kw + W]
                dx += g * w27[(kd * 3 + kh) * 3 + kw]
                dw.append((g * x32).sum(dim=(0, 1, 2, 3)))
    return dx.to(x.dtype), torch.stack(dw)


def _vec16(C: int, *tensors: torch.Tensor) -> int:
    """1 when C and every pointer allow 16-byte channel vectors."""
    vec = 16 // tensors[0].element_size()
    return int(C % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, D, H, W, C = x.shape
    x = x.contiguous()
    wk = w.to(x.dtype).float().reshape(27, C).contiguous()
    y = torch.empty_like(x)
    lib = _build.load("dwconv")
    fn = lib.rsuper_dw3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, D, H, W, C,
             _DTYPE_CODES[x.dtype], _vec16(C, x, y),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dwconv")
    return y


def _dw_groups(B: int, D: int, H: int, C: int, vec: int) -> int:
    """Number of row groups of the wgrad kernel's grid: enough blocks (one
    per group and 16 channel vectors) to fill the card several times over,
    at most one per 4 rows. Each group costs one (27, C) float32 partial."""
    rows = B * D * H
    chan_blocks = -(-(C // vec) // 16)
    return max(1, min(-(-rows // 4), -(-8 * 132 // chan_blocks)))


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """dx by the stencil kernel of csrc/dwconv.cu on dy with flipped taps,
    dw (27, C) float32 by csrc/dwconv_bwd.cu."""
    B, D, H, W, C = x.shape
    x, dy = x.contiguous(), dy.contiguous()
    dx = _launch(dy, w.flip(0, 1, 2))
    vec16 = _vec16(C, x, dy)
    G = _dw_groups(B, D, H, C, 16 // x.element_size() if vec16 else 1)
    partial = torch.empty((G, 27, C), dtype=torch.float32, device=x.device)
    dw = torch.empty((27, C), dtype=torch.float32, device=x.device)
    lib = _build.load("dwconv_bwd")
    fn = lib.rsuper_dw3_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
             B, D, H, W, C, G, _DTYPE_CODES[x.dtype], vec16,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dwconv_bwd")
    return dx, dw


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or tuple(w.shape) != (3, 3, 3, 1, x.shape[-1]):
        raise ValueError(f"x (B, D, H, W, C) and w (3, 3, 3, 1, C) expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")


def depthwise_conv3x3x3_bwd(x: torch.Tensor, w: torch.Tensor,
                            dy: torch.Tensor):
    """Backward of ``depthwise_conv3x3x3``: (dx in x's type, dw (27, C)
    float32) from dy (B, D, H, W, C) in x's type."""
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x, got {tuple(dy.shape)} {dy.dtype} "
                         f"for {tuple(x.shape)} {x.dtype}")
    if not dispatch.use_kernel(x, w, dy):
        return _dw_bwd_plain(x, w, dy)
    out = _launch_bwd(x, w, dy)
    depthwise_conv3x3x3_bwd.launches += 1
    return out


class _DepthwiseConv3(torch.autograd.Function):
    """``depthwise_conv3x3x3`` on CUDA tensors: forward and backward kernels."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = _launch(x, w)
        depthwise_conv3x3x3.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = depthwise_conv3x3x3_bwd(x, w, dy.contiguous())
        dw = dw.to(x.dtype).to(w.dtype).reshape(w.shape)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None)


def depthwise_conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3³ depthwise conv on (B, D, H, W, C); w (3, 3, 3, 1, C).
    Differentiable: autograd of the plain version on the CPU, the kernels on
    the card."""
    _check(x, w)
    if not dispatch.use_kernel(x, w):
        return _dw_plain(x, w)
    return _DepthwiseConv3.apply(x, w)


depthwise_conv3x3x3.launches = 0
depthwise_conv3x3x3_bwd.launches = 0
