"""Bisection top-N thresholds: the two kernels of ``csrc/topn.cu`` and their
plain PyTorch version.

Counterpart of ``rsuper_tpu/ops/pallas_topn.py``. For a volume x (flattened
to V values) and each target n, the threshold is the ``lo`` of `iters`
bisection steps on [0, max x]: ``mid = 0.5·(lo + hi)``, ``ok = count(x ≥ mid)
≥ n``, ``lo = mid`` if ok else ``hi = mid``.

* ``topn_threshold_multi(x, ns)``: one volume, K targets → (K,);
* ``topn_threshold_multi_batched(x, ns)``: (B, ...) volumes, (B, K) targets
  → (B, K).

On CUDA tensors each launches its own C entry of the kernel (the single
volume is the B = 1 case of the same ``__global__`` function); on CPU tensors
both run ``_bisect_plain``. Counts are integers, so kernel and plain version
return the same bits. The kernel takes any V (the TPU kernel's VMEM limit
does not apply), float32, bfloat16 and float16 input (converted to float32 on
load, as the JAX wrapper's ``astype`` does), and a non-contiguous input is
made contiguous first. Nothing here is differentiable: a threshold is
piecewise constant in x.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS, _CACHE, _KMAX = 512, 16, 8  # as in csrc/topn.cu
_MAX_BLOCKS: dict = {}  # (device index, dtype code) → blocks held at once


def _bisect_plain(x: torch.Tensor, ns: torch.Tensor, iters: int) -> torch.Tensor:
    """x (B, V), ns (B, K) float32 → (B, K) float32 thresholds."""
    x = x.float()
    lo = torch.zeros_like(ns)
    hi = x.max(dim=1, keepdim=True).values.expand_as(ns)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (x[:, None, :] >= mid[:, :, None]).sum(dim=-1)
        ok = cnt >= ns
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def _max_blocks(lib, device: torch.device, code: int) -> int:
    key = (device.index, code)
    if key not in _MAX_BLOCKS:
        fn = lib.rsuper_topn_max_blocks
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        n = fn(code)
        if n <= 0:
            raise RuntimeError("topn: the device takes no cooperative launch "
                               f"(rsuper_topn_max_blocks returned {n})")
        _MAX_BLOCKS[key] = n
    return _MAX_BLOCKS[key]


def _launch(x: torch.Tensor, ns: torch.Tensor, iters: int,
            batched: bool) -> torch.Tensor:
    """x (B, V) contiguous on the card, ns (B, K) float32 → (B, K), through
    the batched C entry or (B = 1) the single-volume one. One call of the
    entry for at most `_KMAX` targets and as many items as the card holds
    blocks for at once; more are taken in turns."""
    B, V = x.shape
    K = ns.shape[1]
    code = _DTYPE_CODES[x.dtype]
    lib = _build.load("topn")
    entry = "rsuper_topn_threshold_multi" + ("_batched" if batched else "")
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] * (2 if batched else 1)
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((B, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        most = _max_blocks(lib, x.device, code)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for b0 in range(0, B, most):
            xb = x[b0:b0 + most]
            Bc = xb.shape[0]
            S = max(1, min(-(-V // (_THREADS * _CACHE)), most // Bc))
            part_cnt = torch.empty((2, Bc, S, _KMAX), dtype=torch.int32,
                                   device=x.device)
            part_max = torch.empty((Bc, S), dtype=torch.float32,
                                   device=x.device)
            for k0 in range(0, K, _KMAX):
                nc = ns[b0:b0 + Bc, k0:k0 + _KMAX].contiguous()
                whole = Bc == B and K <= _KMAX  # the usual case: one call
                oc = out if whole else torch.empty_like(nc)
                sizes = (Bc, V) if batched else (V,)
                err = fn(xb.data_ptr(), nc.data_ptr(), oc.data_ptr(),
                         part_cnt.data_ptr(), part_max.data_ptr(), *sizes,
                         nc.shape[1], iters, code, S, stream)
                _build.check(err, f"topn ({entry})")
                if not whole:
                    out[b0:b0 + Bc, k0:k0 + _KMAX] = oc
    return out


def _prepare(x: torch.Tensor, ns, batch: int, iters: int):
    """(x (B, V), ns (B, K) float32 on x's device) after the checks."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if x.numel() == 0 or iters < 0:
        raise ValueError(f"a non-empty volume and iters >= 0 expected, got "
                         f"{tuple(x.shape)} and {iters}")
    ns = torch.as_tensor(ns, dtype=torch.float32, device=x.device
                         ).reshape(batch, -1)
    if ns.shape[1] == 0:
        raise ValueError("at least one target expected")
    return x.detach().reshape(batch, -1), ns


def topn_threshold_multi(x: torch.Tensor, ns, *, iters: int = 26) -> torch.Tensor:
    """Thresholds (K,) float32 of one volume x (any shape) for the targets
    `ns` (K,): for each n the bisection's largest t with count(x ≥ t) ≥ n."""
    xf, nf = _prepare(x, ns, 1, iters)
    if not dispatch.use_kernel(xf, nf):
        return _bisect_plain(xf, nf, iters)[0]
    out = _launch(xf.contiguous(), nf, iters, batched=False)
    topn_threshold_multi.launches += 1
    return out[0]


def topn_threshold_multi_batched(x: torch.Tensor, ns, *,
                                 iters: int = 26) -> torch.Tensor:
    """Thresholds (B, K) float32: per item x[b] (any shape) and target
    ns[b, k], the bisection's largest t with count(x[b] ≥ t) ≥ ns[b, k]."""
    if x.dim() < 1 or x.shape[0] == 0:
        raise ValueError(f"x (B, ...) expected, got {tuple(x.shape)}")
    xf, nf = _prepare(x, ns, x.shape[0], iters)
    if not dispatch.use_kernel(xf, nf):
        return _bisect_plain(xf, nf, iters)
    out = _launch(xf.contiguous(), nf, iters, batched=True)
    topn_threshold_multi_batched.launches += 1
    return out


topn_threshold_multi.launches = 0
topn_threshold_multi_batched.launches = 0
