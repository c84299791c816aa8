"""Ball kernels and the ball convolution in the FFT domain (counterpart of
``rsuper_tpu/ops/balls.py``).

Diameters are rounded up to the next odd integer and the ball's radius is
``d_odd / 2``, so a k = 7 kernel reaches Euclidean distance 3.5. The optional
Gaussian fill is ``exp(-r² / (2·(std·R)²))`` cut at the ball's boundary and
normalised to sum 1.

``fft_ball_conv`` costs the same for every diameter: the volume is
zero-padded by the largest kernel radius, so the circular wrap-around never
touches it, and cropped back. ``ball_count_wrapped`` and
``ball_count_clipped`` count a ball's voxels in closed form, O(D·H), exactly;
``insert_ball`` is the ball as a coordinate mask. Where the JAX package maps
these over a batch with ``vmap``, the functions here take leading batch
dimensions on the diameter (and the centre) and broadcast.
"""

from __future__ import annotations

import math

import torch

# FFT sizes with prime factors 2, 3, 5 and 7 only
_GOOD_SIZES = sorted(
    {
        2**a * 3**b * 5**c * 7**d
        for a in range(0, 12)
        for b in range(0, 6)
        for c in range(0, 4)
        for d in range(0, 3)
        if 2**a * 3**b * 5**c * 7**d <= 4096
    }
)


def good_fft_size(n: int) -> int:
    """Smallest size >= n whose prime factors are all in {2, 3, 5, 7}."""
    for s in _GOOD_SIZES:
        if s >= n:
            return s
    raise ValueError(f"no good FFT size >= {n}")


def odd_ceil(d):
    """Round up to the next odd integer; python scalars and tensors."""
    if isinstance(d, (int, float)):
        c = math.ceil(d)
        return c + 1 if c % 2 == 0 else c
    c = torch.ceil(d)
    return torch.where(torch.remainder(c, 2) == 0, c + 1, c)


def reference_kernel_size(diameter: float) -> int:
    """Odd box that holds the ball: odd(1.2 · odd(ceil(d)))."""
    ks = math.ceil(1.2 * odd_ceil(diameter))
    return ks + 1 if ks % 2 == 0 else ks


def _ball_values(dist2: torch.Tensor, diameter, gaussian: bool,
                 gaussian_std: float, dtype) -> torch.Tensor:
    """Ball values from squared distances (D, H, W); a `diameter` of shape
    (...) gives (..., D, H, W)."""
    d_odd = odd_ceil(torch.as_tensor(diameter, dtype=torch.float32,
                                     device=dist2.device))
    radius = (d_odd / 2.0)[..., None, None, None]
    mask = (dist2 <= radius * radius).to(dtype)
    if gaussian:
        std = gaussian_std * radius
        vals = torch.exp(-dist2 / (2.0 * std * std)).to(dtype) * mask
        return vals / vals.sum(dim=(-3, -2, -1), keepdim=True)
    return mask


def ball_kernel(diameter: float, *, gaussian: bool = False,
                gaussian_std: float = 1.5, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Ball kernel in an odd box of size 1.2 × d_odd with a centred ball of
    radius d_odd / 2 (`diameter` is a python number: the shape depends on it)."""
    ks = reference_kernel_size(diameter)
    c = torch.arange(ks, dtype=torch.float32, device=device) - (ks - 1) / 2.0
    dist2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    return _ball_values(dist2, diameter, gaussian, gaussian_std, dtype)


def _wrapped_coords(n: int, device=None) -> torch.Tensor:
    """Signed offsets of a periodic grid: index i → i if i <= n//2 else i − n."""
    a = torch.arange(n, dtype=torch.float32, device=device)
    return torch.where(a <= n // 2, a, a - n)


def ball_kernel_wrapped(shape, diameter, *, gaussian: bool = False,
                        gaussian_std: float = 1.5, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Ball kernel on a periodic (FFT-ready) grid of `shape`, centred at
    index (0, 0, 0) with negative offsets wrapped to the high end. A
    `diameter` tensor of shape (...) gives (..., *shape)."""
    cz, cy, cx = (_wrapped_coords(n, device) for n in shape)
    dist2 = cz[:, None, None] ** 2 + cy[None, :, None] ** 2 + cx[None, None, :] ** 2
    return _ball_values(dist2, diameter, gaussian, gaussian_std, dtype)


def _padded_shape(spatial, max_diameter):
    """Padded FFT shape for a given largest kernel diameter."""
    max_radius = reference_kernel_size(max_diameter) // 2
    return tuple(good_fft_size(s + max_radius) for s in spatial)


@torch.no_grad()
def fft_ball_conv(x: torch.Tensor, diameter, *, gaussian: bool = False,
                  gaussian_std: float = 1.5,
                  max_diameter: int = 96) -> torch.Tensor:
    """'Same'-padded 3D convolution of `x` with a ball kernel, zero boundary
    conditions, output shape == input shape. x (D, H, W) with a scalar
    `diameter`, or (B, D, H, W) with (B,) diameters (one kernel an item).
    `max_diameter` bounds the kernel radius that the padding must absorb."""
    if x.dim() not in (3, 4):
        raise ValueError(f"expected (D, H, W) or (B, D, H, W), got "
                         f"{tuple(x.shape)}")
    spatial = tuple(x.shape[-3:])
    P = _padded_shape(spatial, max_diameter)
    d = torch.as_tensor(diameter, dtype=torch.float32, device=x.device)
    d = d.reshape(x.shape[:-3])
    kern = ball_kernel_wrapped(P, d, gaussian=gaussian,
                               gaussian_std=gaussian_std, device=x.device)
    dims = (-3, -2, -1)
    xf = torch.fft.rfftn(x.float(), s=P, dim=dims)  # zero-pads to P
    kf = torch.fft.rfftn(kern, dim=dims)
    y = torch.fft.irfftn(xf * kf, s=P, dim=dims)
    return y[..., :spatial[0], :spatial[1], :spatial[2]].to(x.dtype)


def _floor_sqrt(t: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(sqrt(t))`` for non-negative float32 t, whatever way
    sqrt rounds at perfect squares: two integer comparisons pin the result
    (every value involved is exactly representable below 2**24)."""
    f = torch.floor(torch.sqrt(torch.clamp(t, min=0.0)))
    f = torch.where((f + 1.0) * (f + 1.0) <= t, f + 1.0, f)
    return torch.where(f * f > t, f - 1.0, f)


def _interval_count(t, lo, hi):
    """Sum over (D, H) of the length of the integer interval [lo, hi], where
    t >= 0 (the row meets the ball)."""
    cnt = torch.where(t >= 0.0, torch.clamp(hi - lo + 1.0, min=0.0),
                      torch.zeros_like(t))
    return cnt.sum(dim=(-2, -1))


@torch.no_grad()
def ball_count_wrapped(shape, diameter, device=None) -> torch.Tensor:
    """Voxel count of ``ball_kernel_wrapped(shape, diameter)`` (binary fill)
    without the (D, H, W) grid: for each (dz, dy) the admissible x-offsets
    are ``|dx| <= sqrt(r² - dz² - dy²)`` cut to the wrapped offset range
    ``[-(W - W//2 - 1), W//2]``. Exact. `diameter` (...) → counts (...)."""
    if device is None and isinstance(diameter, torch.Tensor):
        device = diameter.device
    d_odd = odd_ceil(torch.as_tensor(diameter, dtype=torch.float32,
                                     device=device))
    r2 = ((d_odd / 2.0) ** 2)[..., None, None]
    cz, cy = _wrapped_coords(shape[0], device), _wrapped_coords(shape[1], device)
    t = r2 - cz[:, None] ** 2 - cy[None, :] ** 2  # (..., D, H)
    s = _floor_sqrt(t)
    n = shape[2]
    hi = torch.clamp(s, max=float(n // 2))
    lo = torch.clamp(-s, min=-float(n - n // 2 - 1))
    return _interval_count(t, lo, hi)


@torch.no_grad()
def ball_count_clipped(shape, center, diameter) -> torch.Tensor:
    """Voxel count of ``insert_ball(shape, center, diameter)`` without the
    grid: integer x-range counting per (z, y) pair, O(D·H). `center` =
    (cz, cy, cx) holds integer-valued tensors; their shape and `diameter`'s
    broadcast to the shape of the result. Exactly ``insert_ball(...).sum()``,
    which is what makes the growth ladder of the Ball Loss equal to the
    reference's grow loop."""
    cz, cy, cx = (c.float() for c in center)
    d_odd = odd_ceil(torch.as_tensor(diameter, dtype=torch.float32,
                                     device=cz.device))
    r2 = ((d_odd / 2.0) ** 2)[..., None, None]
    z = torch.arange(shape[0], dtype=torch.float32, device=cz.device) \
        - cz[..., None]
    y = torch.arange(shape[1], dtype=torch.float32, device=cz.device) \
        - cy[..., None]
    t = r2 - z[..., :, None] ** 2 - y[..., None, :] ** 2  # (..., D, H)
    s = _floor_sqrt(t)
    cxf = cx[..., None, None]
    hi = torch.clamp(cxf + s, max=float(shape[2] - 1))
    lo = torch.clamp(cxf - s, min=0.0)
    return _interval_count(t, lo, hi)


@torch.no_grad()
def insert_ball(shape, center, diameter) -> torch.Tensor:
    """Binary float32 ball of `diameter` centred at the integer coordinates
    `center` = (cz, cy, cx) on a grid `shape`, clipped at the volume's
    borders. Centre and diameter of shape (...) give (..., D, H, W)."""
    cz, cy, cx = (c.float() for c in center)
    d_odd = odd_ceil(torch.as_tensor(diameter, dtype=torch.float32,
                                     device=cz.device))
    radius = (d_odd / 2.0)[..., None, None, None]
    z, y, x = (torch.arange(n, dtype=torch.float32, device=cz.device)
               - c[..., None] for n, c in zip(shape, (cz, cy, cx)))
    dist2 = (z[..., :, None, None] ** 2 + y[..., None, :, None] ** 2
             + x[..., None, None, :] ** 2)
    return (dist2 <= radius * radius).float()
