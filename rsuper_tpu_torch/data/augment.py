"""Device augmentations in PyTorch (the port's counterpart of
``rsuper_tpu/data/augment.py``): R-Super's online intensity stack — additive
and multiplicative brightness, gamma with retained statistics, contrast with
preserved range, Gaussian blur, Gaussian noise — and the random affine's
matrix and nearest-neighbour label window.

JAX's random stream cannot be reproduced, so these functions take their
random numbers as arguments: the unit uniforms of ``_affine_theta``, and each
intensity op's parameter (``pipeline.draw_augment`` draws them from explicit
``torch.Generator``s; the tests pass the values JAX's key stream gives).
Each op computes in float32 as JAX's does; the blur is a 9-tap weighted sum
of shifted slices, so no cuDNN convolution (and no TF32) is involved.

Volumes are (D, H, W) single-channel unless noted; labels (D, H, W, C).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.shear_warp import norm_axis

BLUR_MAX_SIGMA = 1.5
ADDITIVE_STD = 0.1


# ------------------------------------------------------------- intensity ops
def gaussian_noise(img: torch.Tensor, noise: torch.Tensor, std: float):
    """img + std · noise, `noise` standard normal of img's shape."""
    return img + float(np.float32(std)) * noise


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    s = np.float32(sigma)
    k = np.exp(-(x ** 2) / (np.float32(2.0) * s ** 2))
    return (k / np.sum(k, dtype=np.float32)).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  max_sigma: float = BLUR_MAX_SIGMA) -> torch.Tensor:
    """Separable 3D Gaussian blur with zero ('SAME') borders; the radius is
    fixed by `max_sigma` (sigma is drawn in [0.5, 1.5])."""
    radius = int(math.ceil(2.5 * max_sigma))
    taps = [float(w) for w in _gauss_kernel1d(sigma, radius)]
    out = img.to(torch.float32)
    for axis in range(3):
        n = out.shape[axis]
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = radius
        p = F.pad(out, pad)
        acc = taps[0] * p.narrow(axis, 0, n)
        for j in range(1, 2 * radius + 1):
            acc = acc + taps[j] * p.narrow(axis, j, n)
        out = acc
    return out.to(img.dtype)


def brightness_additive(img: torch.Tensor, normal: float,
                        std: float = ADDITIVE_STD):
    """img + std · n, `normal` one standard normal draw."""
    return img + float(np.float32(std) * np.float32(normal))


def brightness_multiply(img: torch.Tensor, factor: float):
    return img * float(np.float32(factor))


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x, unbiased=False)


def gamma(img: torch.Tensor, g: float, retain_stats: bool = True):
    x = img.to(torch.float32)
    mn, mx = torch.min(x), torch.max(x)
    span = torch.clamp(mx - mn, min=1e-8)
    mean, std = torch.mean(x), _std(x)
    y = torch.pow((x - mn) / span, float(np.float32(g))) * span + mn
    if retain_stats:
        y = (y - torch.mean(y)) / torch.clamp(_std(y), min=1e-8) * std + mean
    return y.to(img.dtype)


def contrast(img: torch.Tensor, f: float, preserve_range: bool = True):
    x = img.to(torch.float32)
    mn, mx, mean = torch.min(x), torch.max(x), torch.mean(x)
    y = (x - mean) * float(np.float32(f)) + mean
    if preserve_range:
        y = torch.clamp(y, mn, mx)
    return y.to(img.dtype)


def intensity_augment(img: torch.Tensor, coins, multiply: float,
                      additive: float, gamma_g: float, contrast_f: float,
                      sigma: float, noise_std: float, noise: torch.Tensor,
                      p: float = 0.3) -> torch.Tensor:
    """R-Super's online intensity stack: op k runs when ``coins[k] < p``, in
    the order multiply, additive, gamma, contrast, blur, noise (JAX computes
    every op and selects; an op whose coin does not fire is skipped here)."""
    if coins[0] < p:
        img = brightness_multiply(img, multiply)
    if coins[1] < p:
        img = brightness_additive(img, additive)
    if coins[2] < p:
        img = gamma(img, gamma_g)
    if coins[3] < p:
        img = contrast(img, contrast_f)
    if coins[4] < p:
        img = gaussian_blur(img, sigma)
    if coins[5] < p:
        img = gaussian_noise(img, noise, noise_std)
    return img


# ---------------------------------------------------------- affine transform
def _uniform(u, lo, hi) -> np.ndarray:
    """JAX's ``uniform(minval=lo, maxval=hi)`` from its unit floats `u`:
    max(lo, u·(hi − lo) + lo) in float32."""
    u = np.asarray(u, np.float32)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    return np.maximum(lo, u * (hi - lo) + lo).astype(np.float32)


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    np.float32)


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    np.float32)


def _affine_theta(u_scale, u_shear, u_translate, u_angle, scale, rotate_deg,
                  translate, shear=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Random 3x4 affine in normalised [-1, 1] coordinates from unit
    uniforms (3, 6, 3 and 3 of them), composed as JAX composes it:
    rotations X·Y·Z times scale/shear/translate. Float32 on the host."""
    f32 = np.float32
    scale = np.asarray(scale, f32)
    sc = _uniform(u_scale, f32(1.0) - scale,
                  f32(1.0) / np.maximum(f32(1.0) - scale, f32(1e-3)))
    shear2 = np.repeat(np.asarray(shear, f32), 2)
    sh = _uniform(u_shear, -shear2, shear2)
    translate = np.asarray(translate, f32)
    tr = _uniform(u_translate, -translate, translate + f32(1e-8))
    rot = np.asarray(rotate_deg, f32)
    ang = _uniform(u_angle, -rot, np.maximum(rot, f32(1.0))) * f32(np.pi / 180.0)
    A = np.array([
        [sc[0], sh[0], sh[1], tr[0]],
        [sh[2], sc[1], sh[3], tr[1]],
        [sh[4], sh[5], sc[2], tr[2]],
        [0.0, 0.0, 0.0, 1.0],
    ], f32)
    theta = _rx(ang[0]) @ _ry(ang[1]) @ _rz(ang[2]) @ A
    return theta[:3, :].astype(f32)


def _window_vox(full: Sequence[int], theta, out_size: Sequence[int],
                start: Sequence[int], device=None):
    """Fractional source-voxel coordinates (z, y, x), each of shape
    `out_size`, of the `out_size` window at `start` of the affine output
    grid of a volume of shape `full`."""
    th = [[float(v) for v in row] for row in np.asarray(theta, np.float32)]
    axes = [norm_axis(n, device)[s: s + o]
            for n, o, s in zip(full, out_size, start)]
    z = axes[0][:, None, None]
    y = axes[1][None, :, None]
    x = axes[2][None, None, :]
    out = []
    for i in range(3):
        src = th[i][0] * z + th[i][1] * y + th[i][2] * x + th[i][3]
        out.append((src + 1.0) * 0.5 * (full[i] - 1))
    return out


def _nearest_window_multichannel(vol: torch.Tensor, theta,
                                 out_size: Sequence[int],
                                 start: Sequence[int]) -> torch.Tensor:
    """Order-0 window sampling of all channels of (D, H, W, C) with one
    shared gather: coordinates rounded half to even (as ``jnp.round`` and
    ``map_coordinates(order=0)``), zero outside the volume."""
    D, H, W, C = vol.shape
    vz, vy, vx = _window_vox((D, H, W), theta, out_size, start, vol.device)
    iz, iy, ix = torch.round(vz), torch.round(vy), torch.round(vx)
    valid = ((iz >= 0) & (iz <= D - 1) & (iy >= 0) & (iy <= H - 1)
             & (ix >= 0) & (ix <= W - 1))
    flat = ((iz.clamp(min=0).to(torch.int64) * H
             + iy.clamp(min=0).to(torch.int64)) * W
            + ix.clamp(min=0).to(torch.int64))
    flat = torch.where(valid, flat, torch.zeros_like(flat)).reshape(-1)
    got = vol.reshape(-1, C)[flat]
    got = got * valid.reshape(-1, 1).to(got.dtype)
    return got.reshape(*out_size, C)


def center_crop(arr: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Centre crop of the leading three spatial dims."""
    starts = [(s - c) // 2 for s, c in zip(arr.shape[:3], size)]
    sl = tuple(slice(st, st + c) for st, c in zip(starts, size))
    return arr[sl]
