"""The PyTorch port's top-N selection against the JAX package, on the CPU.

Same numpy inputs on both sides. The bisection is the same float32
arithmetic with integer counts, so thresholds are asked to be bit-equal and
masks equal: against ``rsuper_tpu.ops.selection`` (the plain XLA route) and
against the Pallas kernels of ``rsuper_tpu.ops.pallas_topn`` in interpret
mode, as ``tests/test_ops.py`` runs them. On CPU tensors the port's wrappers
run their plain version and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rsuper_tpu.ops import pallas_topn as jpallas
from rsuper_tpu.ops import selection as jsel
from rsuper_tpu_torch.ops import selection, topn


def _ball_volume(seed, shape=(20, 24, 28)):
    """Uniform values inside one ball, exactly 0 outside (most voxels)."""
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    inside = sum((a - s // 2) ** 2 for a, s in zip(g, shape)) <= 8.5 ** 2
    return (rng.random(shape) * inside).astype(np.float32)


def _dense(seed, shape=(16, 20, 24)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


CASES = {
    "ball": (_ball_volume(0), [400.0, 320.0, 480.0]),
    "dense_with_negatives": (_dense(1), [5.0, 200.0, 2000.0]),
    "all_zero": (np.zeros((8, 9, 10), np.float32), [1.0, 10.0]),
    "n_above_the_positive_count": (_ball_volume(2), [1e6, 5000.0]),
    "n_zero_and_negative": (_dense(3), [0.0, -3.0, 1.0]),
    "all_negative": (-np.abs(_dense(4)) - 0.1, [1.0, 50.0]),
    "one_voxel": (np.array([0.7], np.float32), [1.0, 2.0]),
    "odd_size": (np.random.default_rng(5).random(4099).astype(np.float32),
                 [7.0, 4000.0]),
}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("case", CASES)
def test_topn_threshold_matches_jax(case):
    x, ns = CASES[case]
    for n in ns:
        got = selection.topn_threshold(_t(x), n)
        ref = jsel.topn_threshold(jnp.asarray(x), n)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == float(ref), (case, n)
    got = selection.topn_threshold(_t(x), ns[0], iters=7, hi=2.0)
    assert got.item() == float(jsel.topn_threshold(jnp.asarray(x), ns[0],
                                                   iters=7, hi=2.0))


@pytest.mark.parametrize("case", CASES)
def test_topn_threshold_multi_matches_jax_and_pallas(case):
    x, ns = CASES[case]
    before = topn.topn_threshold_multi.launches
    got = topn.topn_threshold_multi(_t(x), ns).numpy()
    assert topn.topn_threshold_multi.launches == before  # plain on the CPU
    assert got.dtype == np.float32 and got.shape == (len(ns),)
    ref = np.array([float(jsel.topn_threshold(jnp.asarray(x), n)) for n in ns],
                   np.float32)
    np.testing.assert_array_equal(got, ref)
    pal = np.asarray(jpallas.pallas_topn_threshold_multi(
        jnp.asarray(x), jnp.asarray(ns), interpret=True))
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("case", CASES)
def test_topn_mask_and_masks_multi_match_jax(case):
    x, ns = CASES[case]
    got = selection.topn_masks_multi(_t(x), ns)
    ref = np.asarray(jsel.topn_masks_multi(jnp.asarray(x), jnp.asarray(ns)))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (len(ns),) + x.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    one = selection.topn_mask(_t(x), ns[-1])
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jsel.topn_mask(jnp.asarray(x), ns[-1])))
    np.testing.assert_array_equal(one.numpy(), ref[-1])
    assert not (got.numpy() * (x <= 0)).any()  # zeros are never selected


def test_masks_hold_about_n_voxels_and_every_positive_one_on_shortfall():
    x, _ = CASES["ball"]
    masks = selection.topn_masks_multi(_t(x), [400.0, 1e6]).numpy()
    assert abs(masks[0].sum() - 400) <= 2
    np.testing.assert_array_equal(masks[1], (x > 0).astype(np.float32))
    assert not selection.topn_mask(_t(CASES["all_zero"][0]), 5.0).any()


BATCHED = {
    "balls": (np.stack([_ball_volume(10), _ball_volume(11), _ball_volume(12)]),
              [[400.0, 320.0, 480.0], [50.0, 40.0, 60.0], [1.0, 1.0, 1e6]]),
    "dense_one_item": (_dense(13)[None], [[5.0, 2000.0]]),
    "a_zero_item": (np.stack([_dense(14, (6, 7, 8)),
                              np.zeros((6, 7, 8), np.float32)]),
                    [[10.0], [10.0]]),
}


@pytest.mark.parametrize("case", BATCHED)
def test_topn_batched_matches_jax_and_pallas(case):
    x, ns = BATCHED[case]
    ns = np.asarray(ns, np.float32)
    before = topn.topn_threshold_multi_batched.launches
    ts = topn.topn_threshold_multi_batched(_t(x), _t(ns)).numpy()
    assert topn.topn_threshold_multi_batched.launches == before
    assert ts.shape == ns.shape and ts.dtype == np.float32
    pal = np.asarray(jpallas.pallas_topn_threshold_multi_batched(
        jnp.asarray(x), jnp.asarray(ns), interpret=True))
    np.testing.assert_array_equal(ts, pal)
    for b in range(x.shape[0]):
        for k in range(ns.shape[1]):
            assert ts[b, k] == float(jsel.topn_threshold(
                jnp.asarray(x[b]), float(ns[b, k])))
    got = selection.topn_masks_multi_batched(_t(x), _t(ns))
    ref = np.asarray(jsel.topn_masks_multi_batched(jnp.asarray(x),
                                                   jnp.asarray(ns)))
    assert tuple(got.shape) == ns.shape + x.shape[1:]
    np.testing.assert_array_equal(got.numpy(), ref)
    # the single-volume form gives the batched form's masks item by item
    for b in range(x.shape[0]):
        np.testing.assert_array_equal(
            selection.topn_masks_multi(_t(x[b]), ns[b]).numpy(),
            got[b].numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_types_are_converted_like_astype(dtype):
    x = _t(CASES["dense_with_negatives"][0]).to(dtype)
    ns = [5.0, 200.0]
    got = topn.topn_threshold_multi(x, ns)
    ref = topn.topn_threshold_multi(x.float(), ns)
    assert torch.equal(got, ref)
    assert selection.topn_masks_multi(x, ns).dtype == torch.float32


def test_non_contiguous_input_and_no_gradient():
    x = _t(_dense(20, (12, 10, 8)))
    xt = x.permute(2, 0, 1)  # not contiguous
    assert torch.equal(topn.topn_threshold_multi(xt, [30.0]),
                       topn.topn_threshold_multi(xt.contiguous(), [30.0]))
    xg = x.clone().requires_grad_()
    assert not selection.topn_mask(xg, 30.0).requires_grad
    assert not topn.topn_threshold_multi_batched(xg, [[3.0]] * 12).requires_grad


def test_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        topn.topn_threshold_multi(torch.zeros(8, dtype=torch.float64), [1.0])
    with pytest.raises(ValueError):
        topn.topn_threshold_multi(torch.zeros(0), [1.0])
    with pytest.raises(ValueError):
        topn.topn_threshold_multi(torch.zeros(8), [])
    with pytest.raises(ValueError):
        topn.topn_threshold_multi_batched(torch.zeros(0, 8), torch.zeros(0, 1))


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), size=st.integers(1, 600),
       frac=st.floats(0.0, 1.0))
def test_threshold_brackets_n_for_untied_inputs(seed, size, frac):
    """count(x ≥ t) ≥ n, and one bisection resolution above t fewer than n:
    for distinct values on a grid far coarser than hi / 2^25."""
    rng = np.random.default_rng(seed)
    x = (rng.permutation(size).astype(np.float32) + 1.0) / 1024.0
    n = int(round(frac * (size - 1))) + 1
    t = selection.topn_threshold(_t(x), float(n)).item()
    hi = float(x.max())
    assert (x >= t).sum() >= n
    assert (x.astype(np.float64) >= t + hi / 2 ** 25).sum() < n
    mask = selection.topn_mask(_t(x), float(n)).numpy()
    assert mask.sum() == n
