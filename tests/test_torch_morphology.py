"""The PyTorch port's binary morphology against the JAX package, on the CPU:
exact equality on binary inputs (both sides threshold exact small-integer
counts or maxes of {0, 1}; the FFT counts are thresholded at 0.5, far from
their rounding error)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.ops import balls as jballs
from rsuper_tpu.ops import morphology as jmorph
from rsuper_tpu_torch.ops import balls, morphology

KERNELS = [1, 3, 5, 7, 9, 31]
METHODS = ["auto", "fast", "direct", "fft", "iter", "maxpool"]


def _mask(shape, seed, density):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("k", KERNELS)
def test_dilate_cf_matches_jax(k, method):
    # sparse seeds in a volume larger than the largest ball, two leading dims
    x = _mask((2, 2, 36, 30, 41), k, 0.0008 if k > 9 else 0.01)
    x[0, 0, 0, 0, 0] = x[1, 1, -1, -1, 5] = 1.0  # corners: the zero boundary
    got = morphology.dilate_cf(torch.from_numpy(x), k, method)
    ref = np.asarray(jmorph.dilate_cf(jnp.asarray(x), k, method))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert 0.0 < ref.mean() < 1.0
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [4, 6])
def test_dilate_cf_rounds_even_kernels_up(k):
    x = _mask((1, 12, 13, 14), 7, 0.01)
    got = morphology.dilate_cf(torch.from_numpy(x), k)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmorph.dilate_cf(jnp.asarray(x), k)))
    np.testing.assert_array_equal(
        got.numpy(), morphology.dilate_cf(torch.from_numpy(x), k + 1).numpy())


def test_dilate_cf_keeps_type_and_takes_bf16():
    x = _mask((1, 3, 10, 11, 12), 8, 0.02)
    got = morphology.dilate_cf(torch.from_numpy(x).bfloat16(), 5)
    assert got.dtype == torch.bfloat16
    ref = jmorph.dilate_cf(jnp.asarray(x), 5)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(14, 12, 13), (14, 12, 13, 2),
                                   (2, 14, 12, 13, 3)])
@pytest.mark.parametrize("k,method", [(5, "auto"), (11, "fft"),
                                      (3, "direct")])
def test_dilate_channels_last_matches_jax(shape, k, method):
    x = _mask(shape, 9, 0.01)
    got = morphology.dilate(torch.from_numpy(x), k, method)
    ref = jmorph.dilate(jnp.asarray(x), k, method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dilate_raises_on_unknown_method():
    with pytest.raises(ValueError):
        morphology.dilate(torch.zeros(4, 4, 4), 3, "iter")


def test_binary_union_matches_jax():
    a, b, c = (_mask((3, 4, 5), s, 0.3) for s in (1, 2, 3))
    got = morphology.binary_union(*(torch.from_numpy(m) for m in (a, b, c)))
    ref = jmorph.binary_union(*(jnp.asarray(m) for m in (a, b, c)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("d", [1, 3, 4, 5.5, 7, 31])
def test_ball_kernels_match_jax(d):
    np.testing.assert_array_equal(balls.ball_kernel(d).numpy(),
                                  np.asarray(jballs.ball_kernel(d)))
    shape = (40, 36, 45)
    np.testing.assert_array_equal(
        balls.ball_kernel_wrapped(shape, d).numpy(),
        np.asarray(jballs.ball_kernel_wrapped(shape, d)))
    g = balls.ball_kernel(d, gaussian=True).numpy()
    np.testing.assert_allclose(
        g, np.asarray(jballs.ball_kernel(d, gaussian=True)), rtol=1e-5,
        atol=1e-8)
    assert balls.odd_ceil(d) == jballs.odd_ceil(d)
    assert balls.reference_kernel_size(d) == jballs.reference_kernel_size(d)
    t = balls.odd_ceil(torch.tensor([float(d), d + 0.5]))
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jballs.odd_ceil(jnp.asarray([float(d), d + 0.5]))))


@pytest.mark.parametrize("n", [1, 97, 112, 113, 128, 4000])
def test_good_fft_size_matches_jax(n):
    assert balls.good_fft_size(n) == jballs.good_fft_size(n)


def test_good_fft_size_raises_beyond_its_table():
    with pytest.raises(ValueError):
        balls.good_fft_size(5000)
