"""Top-N thresholds by bisection: the kernel of ``csrc/topn.cu`` and its
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
both run ``_bisect_plain``. The kernel takes `PASS_LEVELS` bisection levels
in one counting pass (multisection: it counts against the 2^r − 1 mids of
the next r levels at once, in a histogram, and walks them with the
sequential test), with one thread-block cluster an item that sums what its
CTAs counted through distributed shared memory; ``_multisect_plain`` is the
same algorithm in plain PyTorch, for the tests. Counts are integers, so the
kernel, ``_multisect_plain`` and ``_bisect_plain`` return the same bits. One
launch a call for any B up to 65535 and up to 8 targets (more are taken in
turns), with no scratch memory. The kernel takes any V below 2^31, float32,
bfloat16 and float16 input (converted to float32, as the JAX wrapper's
``astype`` does), and a non-contiguous input is made contiguous first.
Nothing here is differentiable: a threshold is piecewise constant in x.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
# as in csrc/topn.cu
_THREADS, _KMAX, _RMAX = 512, 8, 13
_SMEM_MAX = 232448 - 1024  # dynamic shared memory a CTA may ask for
_QUEUE = 1024  # vectors a pass queues for binning (csrc/topn.cu QUEUE)
_MAX_ITEMS = 65535  # items (grid rows) of one launch
PASS_LEVELS = 9  # r: bisection levels of one counting pass (26 = 9 + 9 + 8)
HOLD = True  # keep the volume in shared memory as far as it fits
CLUSTER = None  # the largest cluster to take; None: what the card schedules
VALUES_PER_THREAD = 16  # the cluster doubles until a thread has at most these

_ARGTYPES = {
    "rsuper_topn_threshold_multi": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "rsuper_topn_threshold_multi_batched": [ctypes.c_void_p] * 3
    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "rsuper_topn_max_cluster": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}
_FNS: dict = {}
_MAX_CLUSTER: dict = {}  # (device index, dtype code) → (cluster, active)


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


def _tree_mids(lo: torch.Tensor, hi: torch.Tensor, levels: int) -> torch.Tensor:
    """(T,) bounds → (T, 2^levels − 1) mids of the next `levels` bisection
    levels, in order (in-order index j − 1), by the bisection's own float32
    recursion: node (lo, hi) has mid 0.5·(lo + hi), its left child the node
    (lo, mid) and its right child (mid, hi)."""
    m = (1 << levels) - 1
    lo = lo.float().clone()[:, None].expand(-1, m).clone()
    hi = hi.float().clone()[:, None].expand(-1, m).clone()
    mids = torch.empty_like(lo)
    j = torch.arange(1, m + 1)
    idx = torch.full((m,), 1 << (levels - 1))
    step = (1 << (levels - 1)) >> 1
    live = torch.ones(m, dtype=torch.bool)
    for _ in range(levels):
        md = 0.5 * (lo + hi)
        here = live & (j == idx)
        mids[:, here] = md[:, here]
        live &= ~here
        right = live & (j > idx)
        left = live & (j < idx)
        lo = torch.where(right, md, lo)
        hi = torch.where(left, md, hi)
        idx = torch.where(right, idx + step, torch.where(left, idx - step, idx))
        step >>= 1
    return mids


def _multisect_plain(x: torch.Tensor, ns: torch.Tensor, iters: int,
                     r: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: x (B, V), ns (B, K) float32
    → (B, K), bit-equal to ``_bisect_plain``. Passes of r levels: each tree's
    mids sorted (ascending, or descending where the item's maximum is
    negative and lo > hi), a value's bin the number of mids ≤ it (ties
    included), count(x ≥ the mid at sorted position p) the values with a bin
    above p, and each target's walk through the histogram's suffix sums with
    the sequential test. The first pass has one tree for every target."""
    x = x.float()
    B, K = ns.shape
    lo = torch.zeros_like(ns)
    hi = x.max(dim=1, keepdim=True).values.expand_as(ns).clone()
    done, first = 0, True
    while done < iters:
        rp = min(r, iters - done)
        m = (1 << rp) - 1
        trees = 1 if first else K
        tlo, thi = lo[:, :trees].reshape(-1), hi[:, :trees].reshape(-1)
        mids = _tree_mids(tlo, thi, rp)  # (B·trees, m) in order
        rev = tlo > thi
        keys = torch.where(rev[:, None], mids.flip(1), mids)  # sorted
        xs = x.repeat_interleave(trees, dim=0)
        bins = torch.searchsorted(keys.contiguous(), xs.contiguous(),
                                  right=True)  # #{keys ≤ v}
        hist = torch.zeros((B * trees, m + 1), dtype=torch.int64)
        hist.scatter_add_(1, bins, torch.ones_like(bins))
        # above[p] = #{bin > p} = count(x ≥ keys[p])
        above = hist.flip(1).cumsum(1).flip(1)[:, 1:]
        above = above.reshape(B, trees, m).expand(B, K, m) if first else \
            above.reshape(B, K, m)
        rev = rev.reshape(B, trees).expand(B, K)
        j = torch.full((B, K), 1 << (rp - 1))
        step = (1 << (rp - 1)) >> 1
        for _ in range(rp):
            pos = torch.where(rev, m - j, j - 1)
            cnt = above.gather(2, pos[:, :, None])[:, :, 0]
            mid = 0.5 * (lo + hi)
            ok = cnt >= ns
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
            j = torch.where(ok, j + step, j - step)
            step >>= 1
        done += rp
        first = False
    return lo


class Plan(NamedTuple):
    """A launch of the kernel: `cluster` CTAs an item, `cache_slots` 16-byte
    vectors a thread holds in shared memory, up to `targets` targets a
    launch, `smem` bytes of dynamic shared memory at that many targets."""
    cluster: int
    cache_slots: int
    targets: int
    smem: int


def _smem(cache_slots: int, targets: int, r: int, cluster: int) -> int:
    """Dynamic shared memory of a launch, as ``csrc/topn.cu`` lays it out:
    the cached vectors; for every target its histogram, the cluster's summed
    counts and the sorted mids (hb bins each); the queue of values to bin;
    the chunk totals of the suffix sums (a chunk is 32 bins); three buffers
    of the hb / cluster bins of every target this CTA sums."""
    hb = max(4, 1 << r, cluster)
    return (cache_slots * _THREADS * 16 + 12 * targets * hb + 16 * _QUEUE
            + 4 * targets * (hb // min(32, hb)) + 12 * targets * (hb // cluster))


@functools.lru_cache(maxsize=None)
def _plan(V: int, K: int, itemsize: int, r: int, cmax: int,
          hold: bool) -> Plan:
    """The launch for items of V values of `itemsize` bytes and K targets:
    the cluster doubles from 1 up to `cmax` while a thread would have more
    than ``VALUES_PER_THREAD`` values; the targets of a launch are as many
    as the histograms leave room for (8 at most); the volume is held in the
    shared memory they leave, as far as it goes."""
    if not 1 <= r <= _RMAX:
        raise ValueError(f"pass levels r must be in 1..{_RMAX}, got {r}")
    need = -(-V // (_THREADS * VALUES_PER_THREAD))
    cluster = 1
    while cluster < min(need, cmax):
        cluster *= 2
    cluster = min(cluster, cmax)
    per_target = _smem(0, 1, r, cluster) - 16 * _QUEUE
    targets = min(K, _KMAX, (_SMEM_MAX - 16 * _QUEUE) // per_target)
    slots = -(-(-(-V // (16 // itemsize))) // (cluster * _THREADS))
    fit = (_SMEM_MAX - _smem(0, targets, r, cluster)) // (_THREADS * 16)
    cache = min(slots, fit) if hold else 0
    return Plan(cluster, cache, targets, _smem(cache, targets, r, cluster))


def _grids(B: int, K: int, plan: Plan) -> list:
    """The launches of a call: (first item, items, first target, targets)
    each, at most 65535 items and the plan's targets a launch. A launch's
    grid is (plan.cluster, items) CTAs, one cluster of plan.cluster CTAs an
    item."""
    return [(b0, min(_MAX_ITEMS, B - b0), k0, min(plan.targets, K - k0))
            for b0 in range(0, B, _MAX_ITEMS)
            for k0 in range(0, K, plan.targets)]


def _fn(name: str):
    """The C entry `name` of csrc/topn.cu, its ctypes signature set once
    when the library loads."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("topn"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def max_cluster(device: torch.device, code: int) -> tuple:
    """(the largest cluster the card schedules for the kernel, 16 or 8, and
    how many of them it holds at once), asked once a device and dtype."""
    key = (device.index, code)
    if key not in _MAX_CLUSTER:
        active = ctypes.c_int(0)
        c = _fn("rsuper_topn_max_cluster")(code, ctypes.byref(active))
        if c <= 0:
            raise RuntimeError(f"topn: no cluster of the kernel fits the card "
                               f"(CUDA error {-c})")
        _MAX_CLUSTER[key] = (c, active.value)
    return _MAX_CLUSTER[key]


def plan_for(V: int, K: int, dtype: torch.dtype, device: torch.device,
             items: int = 1) -> Plan:
    """The plan of a launch of `items` items on `device` (the card's cluster
    limit asked once): clusters of 16 where the card holds that many at
    once, else of 8, which it holds twice as many of (so 9 items at 96³ take
    one wave, not two)."""
    if CLUSTER is not None:
        cmax = CLUSTER
    else:
        cmax, active = max_cluster(device, _DTYPE_CODES[dtype])
        if items > active and cmax > 8:
            cmax //= 2
    return _plan(V, K, _ITEMSIZE[dtype], PASS_LEVELS, cmax, HOLD)


def _launch(x: torch.Tensor, ns: torch.Tensor, iters: int,
            batched: bool) -> torch.Tensor:
    """x (B, V) contiguous on the card, ns (B, K) float32 → (B, K), through
    the batched C entry or (B = 1) the single-volume one: one launch for up
    to 65535 items and the plan's targets, more taken in turns."""
    B, V = x.shape
    K = ns.shape[1]
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x, ns, iters, batched)
    code = _DTYPE_CODES[x.dtype]
    plan = plan_for(V, K, x.dtype, dev, min(B, _MAX_ITEMS))
    entry = "rsuper_topn_threshold_multi" + ("_batched" if batched else "")
    fn = _fn(entry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    grids = _grids(B, K, plan)
    for b0, nb, k0, nk in grids:
        whole = len(grids) == 1  # the usual case: one launch
        nc = ns if whole else ns[b0:b0 + nb, k0:k0 + nk].contiguous()
        oc = out if whole else torch.empty_like(nc)
        sizes = (nb, V) if batched else (V,)
        err = fn(x.data_ptr() + b0 * V * x.element_size(), nc.data_ptr(),
                 oc.data_ptr(), *sizes, nk, iters, PASS_LEVELS,
                 plan.cache_slots, plan.cluster, code, stream)
        _build.check(err, f"topn ({entry})")
        if not whole:
            out[b0:b0 + nb, k0:k0 + nk] = oc
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
    out = _launch(xf.contiguous(), nf.contiguous(), iters, batched=False)
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
    out = _launch(xf.contiguous(), nf.contiguous(), iters, batched=True)
    topn_threshold_multi_batched.launches += 1
    return out


topn_threshold_multi.launches = 0
topn_threshold_multi_batched.launches = 0
