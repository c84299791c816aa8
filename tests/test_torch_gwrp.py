"""The port's Global Weighted Rank Pooling against the JAX package, on the
CPU, same numpy inputs.

The binned ranks are integer counts (a bincount, a reversed cumsum and a
lookup here; one-hot contractions there) and must be equal; the weights are
``d^rank`` in float32 on both sides and agree to rtol 1e-5 (``pow`` may round
differently), as do the sort-based functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.ops import gwrp as jgwrp
from rsuper_tpu_torch.ops import gwrp


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _volume(seed, shape=(10, 11, 12), zero_below=0.3):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    x[x < zero_below] = 0.0  # non-positive voxels: rank L
    return x


def _ranks_from_weights(w, n, c):
    """Invert w ∝ d^rank on the support: log ratios to the largest weight."""
    d = (1.0 - c) ** (1.0 / max(n, 1.0))
    sup = w > 0
    r = np.full(w.shape, -1.0)
    r[sup] = np.log(w[sup] / w.max()) / np.log(d)
    return np.round(r - r[sup].min()), sup


@pytest.mark.parametrize("n", [1.0, 140.0, 5000.0])
@pytest.mark.parametrize("levels", [256, 100, 1024])
def test_gwrp_weights_binned_matches_jax(levels, n):
    x = _volume(0)
    got = gwrp.gwrp_weights_binned(_t(x), n, c=0.5, levels=levels).numpy()
    ref = np.asarray(jgwrp.gwrp_weights_binned(jnp.asarray(x), n, c=0.5,
                                               levels=levels))
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got > 0, ref > 0)  # the same cut-off
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
    assert abs(got.sum() - 1.0) <= 1e-5
    ranks_got, sup = _ranks_from_weights(got.astype(np.float64), n, 0.5)
    ranks_ref, _ = _ranks_from_weights(ref.astype(np.float64), n, 0.5)
    np.testing.assert_array_equal(ranks_got[sup], ranks_ref[sup])


@pytest.mark.parametrize("levels", [256, 64])
def test_binned_ranks_equal_the_numpy_oracle(levels):
    """The integer ranks themselves, against numpy's bincount on bins
    computed with the same float32 operation order."""
    x = _volume(1, (9, 14, 13))
    flat = x.reshape(-1)
    hi = np.float32(max(flat.max(), 1e-30))
    b = np.clip(np.ceil(flat / hi * np.float32(levels)).astype(np.int64), 0,
                levels) - 1
    counts = np.bincount(b[b >= 0], minlength=levels)
    higher = counts[::-1].cumsum()[::-1] - counts
    ranks = np.where(b < 0, float(flat.size), higher[np.maximum(b, 0)])
    n = float(flat.size)  # no cut-off below L: every positive voxel weighs
    got = gwrp.gwrp_weights_binned(_t(x), n, c=0.5, levels=levels).numpy()
    d = 0.5 ** (1.0 / n)
    w = np.where(ranks < n, d ** ranks, 0.0)
    np.testing.assert_allclose(got.reshape(-1), w / w.sum(), rtol=1e-5)


def test_binned_batched_equals_item_by_item():
    x = np.stack([_volume(2), _volume(3), np.zeros((10, 11, 12), np.float32)])
    n = np.array([50.0, 300.0, 1.0], np.float32)
    got = gwrp.gwrp_weights_binned_batched(_t(x), _t(n), 0.5, levels=256)
    assert tuple(got.shape) == x.shape
    for i in range(3):
        one = gwrp.gwrp_weights_binned(_t(x[i]), float(n[i]), 0.5)
        assert torch.equal(one, got[i])
        ref = np.asarray(jgwrp.gwrp_weights_binned(jnp.asarray(x[i]),
                                                   float(n[i]), 0.5))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-5, atol=1e-12)
    assert not got[2].any()  # an all-zero item has no weight


def test_zero_voxels_get_no_weight():
    x = np.zeros((8, 8, 8), np.float32)
    x[0, 0, :4] = [0.4, 0.3, 0.2, 0.1]
    w = gwrp.gwrp_weights(_t(x), 2, c=0.5, method="binned").numpy()
    ref = np.asarray(jgwrp.gwrp_weights(jnp.asarray(x), 2, c=0.5,
                                        method="binned"))
    np.testing.assert_allclose(w, ref, rtol=1e-5)
    assert (w.ravel()[4:] == 0).all() and (w[0, 0, :2] > 0).all()
    assert w[0, 0, 3] == 0


@pytest.mark.parametrize("n", [1.0, 77.0, 2000.0])
def test_gwrp_weights_exact_matches_jax(n):
    x = _volume(4)  # ties among the zeros: the stable order decides
    got = gwrp.gwrp_weights_exact(_t(x), n, c=0.75).numpy()
    ref = np.asarray(jgwrp.gwrp_weights_exact(jnp.asarray(x), n, c=0.75))
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("n", [1.0, 40.0])
def test_gwrp_pool_matches_jax(n):
    x = np.random.default_rng(5).normal(size=(6, 7, 8)).astype(np.float32)
    got = gwrp.gwrp_pool(_t(x), n, c=0.75)
    ref = jgwrp.gwrp_pool(jnp.asarray(x), n, c=0.75)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    assert got.item() <= x.max()


def test_decay_matches_jax():
    n = np.array([0.0, 1.0, 3.0, 4000.0], np.float32)
    np.testing.assert_allclose(gwrp._decay(_t(n), 0.5).numpy(),
                               np.asarray(jgwrp._decay(jnp.asarray(n), 0.5)),
                               rtol=1e-6)


def test_gwrp_weights_auto_switches_at_64_cubed():
    rng = np.random.default_rng(6)
    small = rng.random((64, 64, 64)).astype(np.float32)
    big = rng.random((64, 64, 65)).astype(np.float32)
    n = 500.0
    assert torch.equal(gwrp.gwrp_weights(_t(small), n, 0.5),
                       gwrp.gwrp_weights_exact(_t(small), n, 0.5))
    assert torch.equal(gwrp.gwrp_weights(_t(big), n, 0.5),
                       gwrp.gwrp_weights_binned(_t(big), n, 0.5))
    assert not torch.equal(gwrp.gwrp_weights(_t(big), n, 0.5),
                           gwrp.gwrp_weights_exact(_t(big), n, 0.5))
    ref = np.asarray(jgwrp.gwrp_weights(jnp.asarray(big), n, 0.5))
    np.testing.assert_allclose(gwrp.gwrp_weights(_t(big), n, 0.5).numpy(),
                               ref, rtol=1e-5, atol=1e-12)
