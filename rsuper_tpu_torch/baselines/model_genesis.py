"""Model-Genesis self-supervised restoration pairs (counterpart of
``rsuper_tpu/baselines/model_genesis.py``; Zhou et al. 2019, the reference's
``baselines/model_genesis/utils.py`` ``generate_one_pair``): a corrupted and
an original volume, the corruption stacking random flips, local pixel
shuffling, a Bézier intensity remap and in- or out-painting. The network
learns to restore the original (voxel MSE, ``losses/genesis.py``).

Host-side numpy. Every draw is made from the caller's
``np.random.Generator`` in the JAX package's order, so one seed gives the
same pair in both packages, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _bezier_curve(points: np.ndarray, n: int = 1000
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """A cubic Bézier curve sampled at n points; `points` (4, 2) in [0, 1]²."""
    t = np.linspace(0.0, 1.0, n)[:, None]
    b = ((1 - t) ** 3 * points[0]
         + 3 * (1 - t) ** 2 * t * points[1]
         + 3 * (1 - t) * t ** 2 * points[2]
         + t ** 3 * points[3])
    return b[:, 0], b[:, 1]


def nonlinear_transformation(x: np.ndarray, rng) -> np.ndarray:
    """A random Bézier remap of values in [0, 1]."""
    pts = np.array([[0.0, 0.0], rng.random(2), rng.random(2), [1.0, 1.0]],
                   np.float64)
    xv, yv = _bezier_curve(pts, n=10000)
    if rng.random() < 0.5:
        xv = np.sort(xv)
    else:
        xv, yv = np.sort(xv), np.sort(yv)
    return np.interp(x, xv, yv).astype(x.dtype)


def local_pixel_shuffling(x: np.ndarray, rng,
                          num_blocks: int = 10000) -> np.ndarray:
    """Shuffle the voxels inside `num_blocks` random small boxes (each box
    read from the unshuffled input)."""
    out = x.copy()
    D, H, W = x.shape
    bx = rng.integers(1, max(D // 10, 2), num_blocks)
    by = rng.integers(1, max(H // 10, 2), num_blocks)
    bz = rng.integers(1, max(W // 10, 2), num_blocks)
    ox = rng.integers(0, D - bx + 1)
    oy = rng.integers(0, H - by + 1)
    oz = rng.integers(0, W - bz + 1)
    for i in range(num_blocks):
        sl = (slice(ox[i], ox[i] + bx[i]), slice(oy[i], oy[i] + by[i]),
              slice(oz[i], oz[i] + bz[i]))
        window = x[sl].flatten()
        rng.shuffle(window)
        out[sl] = window.reshape(bx[i], by[i], bz[i])
    return out


def image_in_painting(x: np.ndarray, rng) -> np.ndarray:
    """Up to 5 random boxes filled with uniform noise, in place; each box
    after the first drawn with probability 0.95."""
    D, H, W = x.shape
    cnt = 5
    while cnt > 0 and rng.random() < 0.95:
        b = [int(rng.integers(s // 6, s // 3)) for s in (D, H, W)]
        o = [int(rng.integers(3, s - bb - 3)) for s, bb in zip((D, H, W), b)]
        x[o[0]:o[0] + b[0], o[1]:o[1] + b[1], o[2]:o[2] + b[2]] = rng.random(b)
        cnt -= 1
    return x


def image_out_painting(x: np.ndarray, rng) -> np.ndarray:
    """Uniform noise everywhere but up to 5 random boxes of the input."""
    D, H, W = x.shape
    orig = x.copy()
    out = rng.random(x.shape).astype(x.dtype)
    cnt = 5
    while cnt > 0:
        b = [s - int(rng.integers(3 * s // 7, 4 * s // 7)) for s in (D, H, W)]
        o = [int(rng.integers(3, s - bb - 3)) for s, bb in zip((D, H, W), b)]
        sl = tuple(slice(oo, oo + bb) for oo, bb in zip(o, b))
        out[sl] = orig[sl]
        cnt -= 1
        if rng.random() >= 0.95:
            break
    return out


def generate_restoration_pair(
    img: np.ndarray,
    rng=None,
    flip_rate: float = 0.4,
    local_rate: float = 0.5,
    nonlinear_rate: float = 0.9,
    paint_rate: float = 0.9,
    inpaint_rate: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """(corrupted, target) for one (D, H, W) volume. The transforms see the
    volume min-max scaled to [0, 1]; both outputs are mapped back."""
    rng = rng or np.random.default_rng()
    img = img.astype(np.float32)
    mn, mx = img.min(), img.max()
    span = max(mx - mn, 1e-7)
    y = (img - mn) / span
    x = y.copy()

    # random flips of both
    cnt = 3
    while rng.random() < flip_rate and cnt > 0:
        ax = int(rng.integers(0, 3))
        x = np.flip(x, axis=ax)
        y = np.flip(y, axis=ax)
        cnt -= 1
    x = np.ascontiguousarray(x)
    y = np.ascontiguousarray(y)

    if rng.random() < local_rate:
        x = local_pixel_shuffling(x, rng)
    if rng.random() < nonlinear_rate:
        x = nonlinear_transformation(x, rng)
    if rng.random() < paint_rate:
        if rng.random() < inpaint_rate:
            x = image_in_painting(x, rng)
        else:
            x = image_out_painting(x, rng)
    return x * span + mn, y * span + mn
