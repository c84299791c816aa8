"""Binary morphology on 3D volumes (counterpart of
``rsuper_tpu/ops/morphology.py``; none of it is a Pallas kernel there, and
all of it is plain PyTorch here).

``dilate_cf`` dilates (..., D, H, W) binary arrays by a Euclidean ball of
radius ``odd(kernel_size) / 2``; ``dilate`` does the same for channels-last
arrays. Small balls are exact decompositions into separable running maxes
(ball(1.5), ball(2.5), ball(3.5)); any ball runs as one direct convolution
with the ball kernel or as one product in the FFT domain (count > 0.5);
``iter`` is the repeated small-ball decomposition and ``maxpool`` the cube
with the side k/√2. ``dilate_cube_cf`` is the exact cube used by the device
post-processing. Values must be binary {0, 1}; the output is binary in the
input's type. No gradient flows through a dilation: the masks are data.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .balls import ball_kernel, ball_kernel_wrapped, good_fft_size

def binary_union(*masks: torch.Tensor) -> torch.Tensor:
    """Elementwise OR over binary float masks, in the first mask's type."""
    acc = masks[0]
    for m in masks[1:]:
        acc = acc + m
    return (acc > 0).to(masks[0].dtype)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(..., D, H, W) → (N, 1, D, H, W) float32."""
    return x.float().reshape(-1, 1, *x.shape[-3:])


def _axis_max(v: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Running max of `size` along one spatial axis of (N, 1, D, H, W)."""
    k, p = [1, 1, 1], [0, 0, 0]
    k[axis], p[axis] = size, size // 2
    return F.max_pool3d(v, tuple(k), stride=1, padding=tuple(p))


def _axis_pm_max(v: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """max(v[.. − offset ..], v[.. + offset ..]) along one spatial axis,
    zero-padded (v is non-negative)."""
    dim = 2 + axis
    n = v.shape[dim]
    pad = [0, 0, 0, 0, 0, 0]
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = offset
    vp = F.pad(v, pad)
    return torch.maximum(vp.narrow(dim, 0, n), vp.narrow(dim, 2 * offset, n))


def _ball5_float(v: torch.Tensor) -> torch.Tensor:
    """Un-thresholded ball(2.5) = cube(3) ⊕ cross(1) of a non-negative v."""
    cube = v
    for ax in range(3):
        cube = _axis_max(cube, ax, 3)
    out = cube
    for ax in range(3):
        out = torch.maximum(out, _axis_max(cube, ax, 3))
    return out


def _ball7_float(v: torch.Tensor) -> torch.Tensor:
    """ball(3.5) = (ball(2.5) ⊕ cross(1)) ∪ the eight (±2, ±2, ±2) corners."""
    b5 = _ball5_float(v)
    out = b5
    for ax in range(3):
        out = torch.maximum(out, _axis_max(b5, ax, 3))
    corners = v
    for ax in range(3):
        corners = _axis_pm_max(corners, ax, 2)
    return torch.maximum(out, corners)


def _ball3_float(v: torch.Tensor) -> torch.Tensor:
    """ball(1.5): the 18-neighbourhood, the union over the three axis pairs
    of a separable 2D cube(3)."""
    out = None
    for skip in range(3):
        plane = v
        for ax in range(3):
            if ax != skip:
                plane = _axis_max(plane, ax, 3)
        out = plane if out is None else torch.maximum(out, plane)
    return out


def _iter_float(v: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Radius (k−1)/2 as repeated ball(3.5) passes plus one ball(1.5) or
    ball(2.5) remainder (binary after every pass)."""
    n7, rem = divmod((kernel_size - 1) // 2, 3)
    for _ in range(n7):
        v = (_ball7_float(v) > 0.5).float()
    if rem == 2:
        v = _ball5_float(v)
    elif rem == 1:
        v = _ball3_float(v)
    return v


def _cube_float(v: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool3d(v, k, stride=1, padding=k // 2)


def _direct_float(v: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Counts of one pass with the ball kernel (a single-channel conv)."""
    kern = ball_kernel(kernel_size, device=v.device)
    return F.conv3d(v, kern[None, None], padding=kern.shape[0] // 2)


def _fft_float(v: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Counts of one exact ball in the FFT domain; the volume is zero-padded
    by the ball's radius so the wrap-around never touches it."""
    spatial = tuple(v.shape[-3:])
    radius = kernel_size // 2 + 1
    P = tuple(good_fft_size(s + radius) for s in spatial)
    kf = torch.fft.rfftn(ball_kernel_wrapped(P, kernel_size, device=v.device))
    cnt = torch.fft.irfftn(torch.fft.rfftn(v[:, 0], s=P, dim=(-3, -2, -1))
                           * kf, s=P, dim=(-3, -2, -1))
    return cnt[:, None, :spatial[0], :spatial[1], :spatial[2]]


def _odd(kernel_size: int) -> int:
    return kernel_size + 1 if kernel_size % 2 == 0 else kernel_size


@torch.no_grad()
def dilate_cf(x: torch.Tensor, kernel_size: int,
              method: str = "auto") -> torch.Tensor:
    """Ball dilation of (..., D, H, W) binary arrays with any leading batch
    and channel dimensions. `method`: "auto" (the exact decompositions for
    k = 5 and 7, the direct conv up to k = 9, one FFT-domain ball above),
    "fast", "direct", "fft", "iter" or "maxpool"."""
    kernel_size = _odd(kernel_size)
    if kernel_size <= 1:
        return x
    v = _flat(x)
    if method == "maxpool":
        k = _odd(max(1, int(kernel_size / math.sqrt(2.0))))
        if k <= 1:
            return x
        out = _cube_float(v, k)
    elif kernel_size == 5 and method in ("auto", "fast"):
        out = _ball5_float(v)
    elif kernel_size == 7 and method in ("auto", "fast"):
        out = _ball7_float(v)
    elif method == "iter":
        out = _iter_float(v, kernel_size)
    elif method == "direct" or (method == "auto" and kernel_size <= 9):
        out = _direct_float(v, kernel_size)
    else:
        out = _fft_float(v, kernel_size)
    return (out > 0.5).to(x.dtype).reshape(x.shape)


@torch.no_grad()
def dilate(x: torch.Tensor, kernel_size: int,
           method: str = "auto") -> torch.Tensor:
    """Ball dilation of channels-last arrays: (D, H, W), (D, H, W, C) or
    (..., D, H, W, C), per channel. `method`: "auto", "direct" or "fft"."""
    if method not in ("auto", "direct", "fft"):
        raise ValueError(f"unknown method {method!r}")
    if x.dim() == 3:
        return dilate_cf(x, kernel_size, method)
    return dilate_cf(x.movedim(-1, -4), kernel_size, method).movedim(-4, -1)


def dilate_cube_cf(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Exact cube-kernel dilation of (..., D, H, W) binary arrays — equals
    scipy ``binary_dilation(structure=ones(3³), iterations=(k-1)//2)``.
    Returns x's type, values in {0, 1}."""
    kernel_size = _odd(kernel_size)
    if kernel_size <= 1:
        return x
    return (_cube_float(_flat(x), kernel_size) > 0.5).to(x.dtype).reshape(x.shape)
