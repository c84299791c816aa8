"""Channels-last depthwise 3³ convolution.

Counterpart of ``rsuper_tpu/ops/dwconv.py``. x is ``(B, D, H, W, C)`` and w
the flax depthwise kernel ``(3, 3, 3, 1, C)``. On CUDA tensors the function
launches the kernel of ``csrc/dwconv.cu`` for every C (the TPU gate
``dw_supported`` — C % 128 and a VMEM budget — does not apply); on CPU
tensors it runs the plain version: weights rounded to x's type, 27 shifted
multiply-adds in float32, output in x's type (the semantics of ``_dw_xla``).
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


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, D, H, W, C = x.shape
    x = x.contiguous()
    wk = w.to(x.dtype).float().reshape(27, C).contiguous()
    y = torch.empty_like(x)
    vec = 16 // x.element_size()
    vec16 = int(C % vec == 0 and x.data_ptr() % 16 == 0
                and y.data_ptr() % 16 == 0)
    lib = _build.load("dwconv")
    fn = lib.rsuper_dw3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, D, H, W, C,
             _DTYPE_CODES[x.dtype], vec16,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dwconv")
    return y


def depthwise_conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3³ depthwise conv on (B, D, H, W, C); w (3, 3, 3, 1, C)."""
    if x.dim() != 5 or tuple(w.shape) != (3, 3, 3, 1, x.shape[-1]):
        raise ValueError(f"x (B, D, H, W, C) and w (3, 3, 3, 1, C) expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not dispatch.use_kernel(x, w):
        return _dw_plain(x, w)
    y = _launch(x, w)
    depthwise_conv3x3x3.launches += 1
    return y


depthwise_conv3x3x3.launches = 0
