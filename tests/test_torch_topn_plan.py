"""The top-N kernel's algorithm and launch plan, on the CPU.

``csrc/topn.cu`` takes r bisection levels in one counting pass
(multisection) and one thread-block cluster an item. Its algorithm is
mirrored in plain PyTorch by ``topn._multisect_plain``: the same tree of
mids by the bisection's float32 recursion, bins with ties, counts by suffix
sums and a first pass shared by every target. Counts are integers, so the
mirror is asked to be bit-equal to ``topn._bisect_plain`` and to the JAX
Pallas kernels in interpret mode (as ``tests/test_ops.py`` runs them), for
every r the kernel takes and around the 26 steps the Ball Loss uses. The
launch plan (``topn._plan``, ``topn._grids``) is held to what the kernel
needs: the cluster size, the grid for a given B and K, and shared memory
within a CTA's 227 KB for every r and K.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.ops import pallas_topn as jpallas
from rsuper_tpu.ops import selection as jsel
from rsuper_tpu_torch.ops import topn
from tests.test_torch_selection import BATCHED, CASES

R_ALL = list(range(1, topn._RMAX + 1))
ITERS = [0, 1, 8, 9, 25, 26, 27]


@functools.lru_cache(maxsize=None)
def _pallas(case: str, iters: int) -> np.ndarray:
    x, ns = CASES[case]
    return np.asarray(jpallas.pallas_topn_threshold_multi(
        jnp.asarray(x), jnp.asarray(ns, jnp.float32), iters=iters,
        interpret=True))


@functools.lru_cache(maxsize=None)
def _pallas_batched(case: str, iters: int) -> np.ndarray:
    x, ns = BATCHED[case]
    return np.asarray(jpallas.pallas_topn_threshold_multi_batched(
        jnp.asarray(x), jnp.asarray(np.asarray(ns, np.float32)), iters=iters,
        interpret=True))


def _flat(x, batch):
    return torch.from_numpy(np.array(x, np.float32).reshape(batch, -1))


@pytest.mark.parametrize("r", R_ALL)
@pytest.mark.parametrize("case", CASES)
def test_multisection_equals_bisection_and_pallas(case, r):
    x, ns = CASES[case]
    xt, nt = _flat(x, 1), torch.tensor([ns], dtype=torch.float32)
    for iters in ITERS:
        got = topn._multisect_plain(xt, nt, iters, r)
        assert got.dtype == torch.float32
        assert torch.equal(got, topn._bisect_plain(xt, nt, iters)), iters
        np.testing.assert_array_equal(got[0].numpy(), _pallas(case, iters))


@pytest.mark.parametrize("r", R_ALL)
@pytest.mark.parametrize("case", BATCHED)
def test_batched_multisection_equals_bisection_and_pallas(case, r):
    x, ns = BATCHED[case]
    xt = _flat(x, x.shape[0])
    nt = torch.tensor(ns, dtype=torch.float32)
    for iters in ITERS:
        got = topn._multisect_plain(xt, nt, iters, r)
        assert torch.equal(got, topn._bisect_plain(xt, nt, iters)), iters
        np.testing.assert_array_equal(got.numpy(),
                                      _pallas_batched(case, iters))


def _edge_cases():
    """Inputs where mids repeat or order flips: (name, x (B, V), ns (B, K))."""
    tiny = np.float32(np.nextafter(np.float32(0), np.float32(1)))
    one = np.float32(1.0)
    ulps = one + np.arange(40, dtype=np.float32) * np.spacing(one)
    rng = np.random.default_rng(9)
    return {
        # lo = 0 and hi the smallest subnormal: one float apart from the start
        "lo_and_hi_one_float_apart": (
            np.array([[0.0, tiny, tiny, 0.0, 0.0]], np.float32),
            [[1.0, 2.0, 3.0]]),
        # distinct values a few ulps apart: after ~24 steps lo and hi are
        # adjacent floats and the tree's mids repeat
        "values_ulps_apart": (np.concatenate([ulps, np.zeros(30, np.float32)]
                                             )[None], [[7.0, 20.0, 39.0]]),
        "n_above_the_positive_count": (
            (rng.random((2, 300)) * (rng.random((2, 300)) < 0.2)
             ).astype(np.float32), [[1e4, 61.0], [500.0, 1.0]]),
        # negative maxima: lo = 0 > hi, the mids in descending order
        "negative_items": (-(rng.random((2, 200)) + 0.25).astype(np.float32),
                           [[1.0, 0.0, -1.0], [5.0, 300.0, 0.5]]),
        "all_zero_items": (np.zeros((2, 64), np.float32),
                           [[1.0, 0.0], [64.0, 65.0]]),
    }


EDGE = _edge_cases()


@functools.lru_cache(maxsize=None)
def _jax_edge(case: str):
    """The JAX package's thresholds at 26 steps: its XLA route item by item
    (``selection.topn_threshold``), and the Pallas kernel. The Pallas kernel
    pads the volume with zeros to whole (8, 128) tiles, so for an item whose
    maximum is negative its hi starts at 0, not at the maximum; only the
    XLA route is held there."""
    x, ns = EDGE[case]
    xla = np.array([[float(jsel.topn_threshold(jnp.asarray(x[b]), n))
                     for n in ns[b]] for b in range(x.shape[0])], np.float32)
    pal = np.asarray(jpallas.pallas_topn_threshold_multi_batched(
        jnp.asarray(x), jnp.asarray(np.asarray(ns, np.float32)), iters=26,
        interpret=True))
    return xla, pal


@pytest.mark.parametrize("r", R_ALL)
@pytest.mark.parametrize("case", EDGE)
def test_multisection_edge_cases(case, r):
    x, ns = EDGE[case]
    xt, nt = torch.from_numpy(x), torch.tensor(ns, dtype=torch.float32)
    for iters in ITERS + [40]:
        got = topn._multisect_plain(xt, nt, iters, r)
        assert torch.equal(got, topn._bisect_plain(xt, nt, iters)), iters
    got = topn._multisect_plain(xt, nt, 26, r).numpy()
    xla, pal = _jax_edge(case)
    np.testing.assert_array_equal(got, xla)
    if (x.max(axis=1) >= 0).all():
        np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("levels", [1, 2, 5, 9])
def test_tree_mids_are_the_mids_the_bisection_visits(levels):
    """Walking the tree by any sequence of outcomes gives the bisection's
    mids: the node reached by a path is the mid the steps compute."""
    lo, hi = torch.tensor([0.0, 0.25, 3.0]), torch.tensor([1.7, 0.25, -2.0])
    mids = topn._tree_mids(lo, hi, levels)
    rng = np.random.default_rng(levels)
    for _ in range(8):
        a, b = lo.clone(), hi.clone()
        j = 1 << (levels - 1)
        step = j >> 1
        for _ in range(levels):
            md = 0.5 * (a + b)
            assert torch.equal(mids[:, j - 1], md)
            ok = bool(rng.integers(2))
            a, b = (md, b) if ok else (a, md)
            j, step = (j + step if ok else j - step), step >> 1
    assert torch.all(mids[0, 1:] >= mids[0, :-1])  # lo <= hi: ascending
    assert torch.all(mids[2, 1:] <= mids[2, :-1])  # lo > hi: descending


# ------------------------------------------------------------ launch plan
PLAN_V = [1, 127, 4099, 32 ** 3, 96 ** 3, 128 ** 3]


@pytest.mark.parametrize("cmax", [16, 8])
@pytest.mark.parametrize("V", PLAN_V)
def test_cluster_size(V, cmax):
    p = topn._plan(V, 3, 4, 9, cmax, True)
    assert p.cluster in (1, 2, 4, 8, 16) and p.cluster <= cmax
    need = -(-V // (topn._THREADS * topn.VALUES_PER_THREAD))
    # the smallest power of two that leaves a thread at most
    # VALUES_PER_THREAD values, unless the card's limit stops it first
    assert p.cluster == min(cmax, 1 << max(0, (need - 1).bit_length()))
    if V >= 96 ** 3:  # the Ball Loss's volumes take the whole cluster
        assert p.cluster == cmax


@pytest.mark.parametrize("items,cluster", [(1, 16), (2, 16), (7, 16), (8, 8),
                                           (9, 8), (300, 8)])
def test_clusters_of_8_where_the_card_holds_too_few_of_16(monkeypatch, items,
                                                          cluster):
    """A card that holds 7 clusters of 16 at once runs up to 7 items in
    clusters of 16, more in clusters of 8 (one wave, not two)."""
    monkeypatch.setattr(topn, "max_cluster", lambda device, code: (16, 7))
    p = topn.plan_for(96 ** 3, 3, torch.float32, torch.device("cpu"), items)
    assert p.cluster == cluster
    monkeypatch.setattr(topn, "CLUSTER", 16)  # a fixed cluster stays
    assert topn.plan_for(96 ** 3, 3, torch.float32, torch.device("cpu"),
                         items).cluster == 16


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("V", [96 ** 3, 128 ** 3])
def test_the_volume_is_held_on_chip_as_far_as_it_fits(V, itemsize):
    p = topn._plan(V, 3, itemsize, 9, 16, True)
    per_slot = 16 // itemsize
    held = p.cache_slots * p.cluster * topn._THREADS * per_slot
    room = (topn._SMEM_MAX - topn._smem(0, 3, 9, p.cluster)) // (topn._THREADS * 16)
    need = -(-(-(-V // per_slot)) // (p.cluster * topn._THREADS))
    if need <= room:  # all of it, in as few slots as hold it
        assert p.cache_slots == need and held >= V
    else:  # as much as fits, the rest from L2
        assert p.cache_slots == room and held < V
    # the Ball Loss's 96³ volume: in bf16 whole; in float32 (3.54 MB) all
    # but the slots that the histograms and the queue leave no room for
    if V == 96 ** 3:
        assert held >= (V if itemsize == 2 else 0.85 * V)
    assert topn._plan(V, 3, itemsize, 9, 16, False).cache_slots == 0


@pytest.mark.parametrize("K", range(1, topn._KMAX + 1))
@pytest.mark.parametrize("r", R_ALL)
def test_shared_memory_fits_a_cta(r, K):
    for V in PLAN_V:
        for itemsize in (4, 2):
            for hold in (True, False):
                p = topn._plan(V, K, itemsize, r, 16, hold)
                assert 1 <= p.targets <= min(K, topn._KMAX)
                assert p.smem == topn._smem(p.cache_slots, p.targets, r,
                                            p.cluster)
                assert p.smem <= topn._SMEM_MAX <= 227 * 1024
                # the histograms, counts and mids of a launch's targets, the
                # queue
                assert p.smem >= 12 * p.targets * max(4, 1 << r) + 16 * 1024
    hb = max(4, 1 << r, 16)
    per_target = 12 * hb + 4 * (hb // min(32, hb)) + 12 * (hb // 16)
    assert topn._plan(96 ** 3, K, 4, r, 16, True).targets == min(
        K, (topn._SMEM_MAX - 16 * topn._QUEUE) // per_target)


@pytest.mark.parametrize("B,K,launches", [
    (1, 3, 1), (2, 3, 1), (9, 3, 1), (300, 3, 1), (300, 9, 2),
    (65535, 8, 1), (65536, 3, 2), (70000, 9, 4)])
def test_grids(B, K, launches):
    p = topn._plan(127, K, 4, 9, 16, True)
    grids = topn._grids(B, K, p)
    assert len(grids) == launches
    covered = np.zeros((B, K), np.int64)
    for b0, nb, k0, nk in grids:
        assert 1 <= nb <= topn._MAX_ITEMS and 1 <= nk <= p.targets
        covered[b0:b0 + nb, k0:k0 + nk] += 1
    assert (covered == 1).all()  # every (item, target) once
    # the kernel's grid is (cluster, items): the first launch takes every
    # item up to the grid's limit, one cluster of 1 CTA each at V = 127
    assert grids[0][1] == min(B, topn._MAX_ITEMS) and p.cluster == 1


def test_plan_refuses_levels_the_kernel_does_not_take():
    for r in (0, topn._RMAX + 1):
        with pytest.raises(ValueError):
            topn._plan(96 ** 3, 3, 4, r, 16, True)
