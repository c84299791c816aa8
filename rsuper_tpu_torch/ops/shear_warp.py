"""The augment's image warp as shear-decomposed matrix products (the port's
counterpart of ``rsuper_tpu/ops/shear_warp.py``, the JAX package's default
image warp).

The affine map of the augment (rotations × positive anisotropic scale, plus
translation) is re-expressed as a sequence of one-axis linear resamples:

    M = Rx(a)·Ry(b)·Rz(g)·diag(d)
    each rotation = 3 Paeth shears  H(α)·V(β)·H(α), α = −tan(θ/2), β = sin θ
    diag + translate + crop = 3 per-axis 1-D resamples

Every pass resamples axis u at positions offset linearly by axis v: a
batched (n_v, n_u_out, n_u_in) product with hat-function (linear) weights,
``torch.einsum`` in float32. The passes multiply back to θ exactly; the
borders are zero (cval = 0); pure scale/translate is exactly trilinear, and
with rotation the result is the multi-pass approximation the JAX package
uses.

Float32 stays float32 on the card: nothing here turns TF32 on, and the
einsums run as TF32 only if the caller sets
``torch.backends.cuda.matmul.allow_tf32`` (the port never does).
``decompose_affine`` runs on the host, on θ drawn there, so the warp reads
nothing back from the device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

Pass = Tuple[str, Tuple]  # ("shear", (u, v, alpha)) | ("diag", (d, t))


def decompose_affine(theta) -> Tuple[List[Pass], np.ndarray]:
    """theta (3, 4) normalised-coordinate affine with M = R·diag(d), d > 0
    (the augment's family: shear parameters zero) → the passes in
    application order, whose coordinate maps multiply to theta, and d.
    Float32 on the host, as the JAX package computes it."""
    theta = np.asarray(theta, np.float32)
    M = theta[:, :3]
    t = theta[:, 3]
    d = np.sqrt(np.sum(M * M, axis=0, dtype=np.float32))  # M = R·diag(d)
    R = M / d[None, :]

    # Euler angles of R = rx(a)·ry(b)·rz(g) in the (z, y, x) convention of
    # augment._affine_theta:
    #   R[0] = [cb·cg, -cb·sg, -sb]
    #   R[1] = [ca·sg - sa·sb·cg, ca·cg + sa·sb·sg, -sa·cb]
    #   R[2] = [sa·sg + ca·sb·cg, sa·cg - ca·sb·sg,  ca·cb]
    b = np.arcsin(np.clip(-R[0, 2], np.float32(-1.0), np.float32(1.0)))
    a = np.arctan2(-R[1, 2], R[2, 2])
    g = np.arctan2(-R[0, 1], R[0, 0])

    def paeth(p, q, th):
        al = -np.tan(th / np.float32(2.0))
        be = np.sin(th)
        return [("shear", (p, q, al)), ("shear", (q, p, be)),
                ("shear", (p, q, al))]

    passes: List[Pass] = []
    passes += paeth(1, 2, a)  # Rx, applied first
    passes += paeth(0, 2, b)  # Ry
    passes += paeth(0, 1, g)  # Rz
    u = R.T @ t  # the translation folds into the final diag pass
    passes.append(("diag", (d, u.astype(np.float32))))
    return passes, d


def pass_matrix(p: Pass) -> np.ndarray:
    """(4, 4) homogeneous matrix of one pass (the product over the passes in
    application order reproduces theta)."""
    m = np.eye(4, dtype=np.float64)
    if p[0] == "shear":
        u, v, al = p[1]
        m[u, v] = al
        return m
    dvec, t = p[1]
    m[0, 0], m[1, 1], m[2, 2] = dvec
    m[:3, 3] = t
    return m


def norm_axis(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in float32, rounded as XLA computes it on
    the CPU: s = i·r with r = 1/(n−1) in float32, t = 1 − s, the point
    fma(i, r, −t) (one rounding, here through float64, where i·r and the
    sum are exact), and the last point exactly 1."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=torch.float32, device=device)
    i = torch.arange(n - 1, dtype=torch.float64, device=device)
    r = float(np.float32(1.0 / (n - 1)))
    t = 1.0 - (i * r).to(torch.float32)
    head = ((i * r) - t.to(torch.float64)).to(torch.float32)
    return torch.cat([head, torch.ones(1, dtype=torch.float32, device=device)])


def _hat_weights(src_idx: torch.Tensor, n_in: int) -> torch.Tensor:
    """Linear-interpolation weights of fractional source indices against an
    n_in iota: rows sum to 1 in range and taper to 0 outside (the order-1
    'constant' cval = 0 edges)."""
    iota = torch.arange(n_in, dtype=torch.float32, device=src_idx.device)
    return torch.clamp(1.0 - (src_idx[..., None] - iota).abs(), min=0.0)


_SHEAR_SPEC = {
    (0, 1): "yzi,iyx->zyx",
    (0, 2): "xzi,iyx->zyx",
    (1, 0): "zyi,zix->zyx",
    (1, 2): "xyi,zix->zyx",
    (2, 0): "zxi,zyi->zyx",
    (2, 1): "yxi,zyi->zyx",
}


def _apply_shear(vol: torch.Tensor, u: int, v: int, alpha: float) -> torch.Tensor:
    """out[..p_u..] = vol sampled at u_norm + α·v_norm (the other axes
    fixed): one batched product. vol (Z, Y, X) float32, u ≠ v ∈ {0, 1, 2}."""
    n_u, n_v = vol.shape[u], vol.shape[v]
    dev = vol.device
    # `alpha` is a float32 value: the scalar product rounds as float32's
    src_norm = norm_axis(n_u, dev)[None, :] + alpha * norm_axis(n_v, dev)[:, None]
    src_idx = (src_norm + 1.0) * 0.5 * (n_u - 1)
    w = _hat_weights(src_idx, n_u)  # (n_v, n_u_out, n_u_in)
    return torch.einsum(_SHEAR_SPEC[(u, v)], w, vol)


def _apply_diag(vol: torch.Tensor, d, t, out_size: Sequence[int],
                start: Sequence[int]) -> torch.Tensor:
    """The final per-axis resample at scale d and offset t, emitting only the
    [start, start + out) window of the full output grid (the fused centre
    crop)."""
    dev = vol.device
    for ax in range(3):
        n_in = vol.shape[ax]
        full_out = norm_axis(n_in, dev)[start[ax]: start[ax] + out_size[ax]]
        src_idx = (float(d[ax]) * full_out + float(t[ax]) + 1.0) * 0.5 * (n_in - 1)
        w = _hat_weights(src_idx, n_in)  # (n_out, n_in)
        vol = torch.movedim(torch.tensordot(w, vol, dims=([1], [ax])), 0, ax)
    return vol


def shear_affine_window(vol: torch.Tensor, theta, out_size: Sequence[int],
                        start: Sequence[int]) -> torch.Tensor:
    """The affine warp of a (D, H, W) image, sampled on the `out_size`
    window at `start` of the output grid: the same map and zero borders as
    a trilinear ``affine_sample_window``, by multi-pass linear
    interpolation. `theta` is a host (3, 4) array."""
    passes, _ = decompose_affine(theta)
    x = vol.to(torch.float32)
    for p in passes[:-1]:
        u, v, al = p[1]
        x = _apply_shear(x, u, v, float(al))
    d, t = passes[-1][1]
    return _apply_diag(x, d, t, tuple(out_size), tuple(start))
