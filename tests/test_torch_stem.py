"""The stem's conv route (bf16, C_in = 1) on the CPU.

The two stem kernels of ``csrc/conv_cf.cu`` and ``csrc/conv_cf_wgrad.cu``
run only on the card (``tests/test_torch_kernels_cuda.py``, ``-m cuda``).
What they compute is held here through a torch emulation of their K = 32
formulation, the JAX package's form "f": the patch of the 27 taps in
(kd, kh, kw) order, padded to 32 with zeros, times the packed weights
``_pack_w(w, bf16, "stem")`` padded as the kernels pad them in their
registers (K to 32, C_out to 16). The emulation is held against the port's
plain versions and against the JAX package's ``conv3x3x3_cf`` (its XLA path
and its Pallas kernels in interpret mode), the weight pack against the JAX
package's ``_prep_w_f``, and the grids the wrapper hands the kernels against
their invariants.

Tolerances, as max|Δ| ≤ tol·(1 + max|ref|):
* forward, float32: 1e-5 against the plain version (the same 27 products
  summed in another order), 1e-4 against JAX (as ``test_torch_ops.py``);
* forward, bf16: 2e-2 — products of bf16 operands are exact in float32, the
  sums differ in order, and the output is rounded once to bf16, which may
  round the other way near a tie;
* weight gradient, float32 sums of the same products: 1e-5 against the
  plain version; against JAX 1e-4 in float32 and 2e-2 in bf16, where the
  JAX package hands dw on rounded to the compute type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rsuper_tpu.ops import conv_cf as jconv
from rsuper_tpu_torch.ops import conv_cf

BF16, F32 = torch.bfloat16, torch.float32
TDT = {"float32": F32, "bfloat16": BF16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PATHS = {"xla": {}, "pallas": dict(force_pallas=True, interpret=True)}
# (B, D, 1, H, W, C_out): one-deep volumes, H and W that are not multiples
# of 8 or 16, a batch of 2, C_out of the model's stem (32) and odd ones
CASES = [(2, 1, 1, 9, 13, 32), (2, 3, 1, 10, 21, 7), (1, 4, 1, 6, 8, 3),
         (1, 5, 1, 11, 17, 32)]
# the production shapes and ragged ones, (B, D, H, W)
GRIDS = [(8, 96, 96, 96), (1, 96, 96, 96), (2, 96, 96, 96), (1, 1, 9, 13),
         (2, 3, 10, 21), (1, 40, 33, 70), (3, 7, 200, 5)]


def _assert_close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    bound = tol * (1.0 + float(np.abs(ref).max()))
    assert err <= bound, f"max|Δ| {err} > {bound}"


def _inputs(case, seed):
    B, D, Ci, H, W, Co = case
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, D, Ci, H, W)) * 2.0 + 0.5).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, Ci, Co)) / np.sqrt(27)).astype(np.float32)
    dy = rng.normal(size=(B, D, Co, H, W)).astype(np.float32)
    return x, w, dy


def _pad_a(wt: torch.Tensor) -> torch.Tensor:
    """(C_out, 27) weights as the (C_out↑16, 32) A operand: zeros in K's 5
    padded taps and in C_out's tail, as the kernels load it."""
    co = wt.shape[0]
    a = torch.zeros((-(-co // 16) * 16, 32), dtype=F32)
    a[:co, :27] = wt.float()
    return a


def _a_matrix(w: torch.Tensor) -> torch.Tensor:
    """The A operand the stem kernels hold: the bf16 pack, transposed."""
    return _pad_a(conv_cf._pack_w(w, BF16, "stem").t())


def _a_float32(w: np.ndarray) -> torch.Tensor:
    """The same formulation on the unrounded weights: JAX's ``_prep_w_f``."""
    return _pad_a(torch.tensor(np.asarray(jconv._prep_w_f(jnp.asarray(w)))))


def _patch32(x: torch.Tensor) -> torch.Tensor:
    """(32, B, D, H, W) float32: tap k of position (b, d, h, w) is
    x[b, d+kd−1, 0, h+kh−1, w+kw−1] (0 outside the volume), k = 9 kd + 3 kh
    + kw; taps 27..31 are zero."""
    B, D, _, H, W = x.shape
    xp = F.pad(x.float()[:, :, 0], (1, 1, 1, 1, 1, 1))
    taps = [xp[:, kd:kd + D, kh:kh + H, kw:kw + W]
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(taps + [torch.zeros_like(taps[0])] * 5)


def _stem_forward(x: torch.Tensor, a: torch.Tensor, co: int) -> torch.Tensor:
    """y = A · patch32 in float32, rounded once to x's type."""
    y = torch.einsum("ck,kbdhw->bdchw", a, _patch32(x))
    return y[:, :, :co].to(x.dtype)


def _emulated(x: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """The stem forward: bf16 weights in bf16 as the kernel holds them; in
    float32 the formulation alone, on the unrounded weights."""
    a = (_a_matrix(torch.from_numpy(w)) if x.dtype == BF16
         else _a_float32(w))
    return _stem_forward(x, a, w.shape[-1])


def _stem_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dwᵀ = dy · patch32ᵀ in float32, the 27 real taps as (3, 3, 3, 1, Co)."""
    dwt = torch.einsum("bdchw,kbdhw->ck", dy.float(), _patch32(x))
    return dwt[:, :27].t().reshape(3, 3, 3, 1, dy.shape[2])


@pytest.mark.parametrize("co", [32, 3, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stem_weight_pack_is_prep_w_f_transposed_in_bf16(co, seed):
    """(27, C_out) bf16: the JAX package's (C_out, 27) form-"f" weights,
    transposed and rounded to bf16, taps in (kd, kh, kw) order; with the
    kernels' zero padding, the (C_out↑16, 32) A operand."""
    w = np.random.default_rng(seed).normal(size=(3, 3, 3, 1, co)).astype(
        np.float32)
    want = np.asarray(jconv._prep_w_f(jnp.asarray(w)), np.float32).T
    want = torch.from_numpy(np.ascontiguousarray(want)).to(BF16).float()
    got = conv_cf._pack_w(torch.from_numpy(w), BF16, "stem")
    assert got.dtype == BF16 and got.is_contiguous()
    assert tuple(got.shape) == (27, co)
    assert torch.equal(got.float(), want)
    a = _a_matrix(torch.from_numpy(w))
    assert tuple(a.shape) == (-(-co // 16) * 16, 32)
    assert torch.equal(a[:co, :27], want.t())
    assert not a[co:].any() and not a[:, 27:].any()


def test_stem_weight_pack_takes_flipped_and_strided_weights():
    """The dgrad of a conv with one output channel is the stem route on
    flipped weights; the pack copies any strided view as it is."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 7, 1)).astype(np.float32))
    big = torch.from_numpy(rng.normal(size=(3, 3, 3, 1, 14)).astype(np.float32))
    for src in (conv_cf._flip_w(w), big[..., ::2]):
        want = src.contiguous().reshape(27, 7).to(BF16)
        assert torch.equal(conv_cf._pack_w(src, BF16, "stem"), want)
    assert not big[..., ::2].is_contiguous()


@pytest.mark.parametrize("shape", GRIDS, ids=str)
def test_stem_wgrad_splits_cover_every_tile_once(shape):
    """At most one block a tile (one depth row of an 8 × 32 column) and
    STEM_WGRAD_FILL at most; the kernel's shares [T s / S, T (s + 1) / S)
    cover the tiles once, in order; partial sums and arrival counters as the
    wrapper sizes them."""
    B, D, H, W = shape
    S = conv_cf._stem_wgrad_splits(B, D, H, W)
    T = B * -(-H // 8) * -(-W // 32) * D
    assert 1 <= S <= min(T, conv_cf.STEM_WGRAD_FILL)
    assert S == min(T, conv_cf.STEM_WGRAD_FILL)
    bounds = [T * s // S for s in range(S + 1)]
    assert bounds[0] == 0 and bounds[-1] == T
    assert all(b < c for b, c in zip(bounds, bounds[1:]))  # no empty share
    groups = -(-S // conv_cf.STEM_GROUP)
    assert (S + groups) * 27 * 32 * 4 <= 1 << 20  # partials at C_out = 32
    assert groups <= S


@pytest.mark.parametrize("co", [32, 7, 70])
@pytest.mark.parametrize("shape", GRIDS, ids=str)
def test_stem_forward_runs_cover_every_depth_once(shape, co):
    """Runs of at least one depth that cover D with no empty run; the grid
    comes within half of STEM_FWD_FILL blocks, or of one block a depth row
    of tiles where the volume has fewer (runs are whole divisions of D)."""
    B, D, H, W = shape
    run = conv_cf._stem_fwd_run(B, D, co, H, W)
    runs = -(-D // run)
    assert 1 <= run <= D
    assert (runs - 1) * run < D <= runs * run
    columns = B * -(-H // 8) * -(-W // 32) * -(-co // 32)
    assert 2 * columns * runs >= min(conv_cf.STEM_FWD_FILL, columns * D)


def test_the_stem_route_is_bf16_at_one_channel():
    assert conv_cf.conv_route(BF16, 1) == "stem"
    assert conv_cf.conv_route(F32, 1) == "cuda_core"
    assert conv_cf.conv_route(BF16, 2) == "cuda_core"
    assert conv_cf._ROUTE_CODES["stem"] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_the_k32_emulation_matches_the_plain_versions(case, dtype):
    x, w, dy = _inputs(case, 0)
    xt, wt, dyt = (torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w),
                   torch.from_numpy(dy).to(TDT[dtype]))
    got = _emulated(xt, w)
    assert got.dtype == TDT[dtype]
    _assert_close(got.float(), conv_cf._conv3_cf_plain(xt, wt).float(),
                  1e-5 if dtype == "float32" else 2e-2)
    _assert_close(_stem_wgrad(xt, dyt), conv_cf._wgrad_plain(xt, dyt), 1e-5)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_the_k32_emulation_matches_jax(case, dtype, path):
    """Forward and weight gradient against ``jax.vjp`` of the JAX
    package's ``conv3x3x3_cf`` at C_in = 1."""
    x, w, dy = _inputs(case, 1)
    xj = jnp.asarray(x).astype(JDT[dtype])
    y, vjp = jax.vjp(lambda b: jconv.conv3x3x3_cf(xj, b, **PATHS[path]),
                     jnp.asarray(w))
    (rw,) = vjp(jnp.asarray(dy).astype(y.dtype))
    xt = torch.from_numpy(x).to(TDT[dtype])
    dyt = torch.from_numpy(dy).to(TDT[dtype])
    tol = 1e-4 if dtype == "float32" else 2e-2
    _assert_close(_emulated(xt, w).float(), np.asarray(y, np.float32), tol)
    _assert_close(_stem_wgrad(xt, dyt), np.asarray(rw, np.float32), tol)
