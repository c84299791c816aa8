"""Ball kernels (counterpart of the part of ``rsuper_tpu/ops/balls.py`` that
``ops/morphology.py`` needs: sizes, rounding and the two kernel layouts).

Diameters are rounded up to the next odd integer and the ball's radius is
``d_odd / 2``, so a k = 7 kernel reaches Euclidean distance 3.5. The FFT-domain
ball convolution, the ball counts and the Gaussian search kernels belong to
the Ball Loss and are not ported yet.
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
    d_odd = odd_ceil(torch.as_tensor(diameter, dtype=torch.float32,
                                     device=dist2.device))
    radius = d_odd / 2.0
    mask = (dist2 <= radius * radius).to(dtype)
    if gaussian:
        std = gaussian_std * radius
        vals = torch.exp(-dist2 / (2.0 * std * std)).to(dtype) * mask
        return vals / vals.sum()
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
    index (0, 0, 0) with negative offsets wrapped to the high end."""
    cz, cy, cx = (_wrapped_coords(n, device) for n in shape)
    dist2 = cz[:, None, None] ** 2 + cy[None, :, None] ** 2 + cx[None, None, :] ** 2
    return _ball_values(dist2, diameter, gaussian, gaussian_std, dtype)
