"""The port's FFT ball convolution, closed-form ball counts and inserted
balls against the JAX package, on the CPU, same numpy inputs.

Tolerances: ``fft_ball_conv`` max|Δ| ≤ 1e-5 (two float32 FFT libraries; the
inputs are in [0, 1] and a binary ball sums at most a few thousand of them,
a normalised Gaussian ball at most 1); counts and inserted balls are integer
arithmetic in float32 and must be equal. Both paddings of the Ball Loss are
run: ``max_diameter`` 64 (``LossConfig``) and 96 (``BallLossConfig``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.ops import balls as jballs
from rsuper_tpu_torch.ops import balls


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("max_diameter", [64, 96])
@pytest.mark.parametrize("shape", [(24, 24, 24), (40, 32, 28)], ids=str)
def test_padded_shape_matches_jax(shape, max_diameter):
    assert balls._padded_shape(shape, max_diameter) == \
        jballs._padded_shape(shape, max_diameter)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("max_diameter", [64, 96])
@pytest.mark.parametrize("shape,diameter", [((24, 24, 24), 7.0),
                                            ((40, 32, 28), 12.4),
                                            ((32, 32, 32), 31.0)], ids=str)
def test_fft_ball_conv_matches_jax(shape, diameter, max_diameter, gaussian):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    got = balls.fft_ball_conv(_t(x), diameter, gaussian=gaussian,
                              max_diameter=max_diameter)
    ref = np.asarray(jballs.fft_ball_conv(
        jnp.asarray(x), jnp.float32(diameter), gaussian=gaussian,
        max_diameter=max_diameter))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    scale = 1.0 if gaussian else float(np.abs(ref).max())
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * max(1.0, scale)


def test_fft_ball_conv_batched_is_one_kernel_an_item():
    x = np.random.default_rng(1).random((3, 24, 20, 28)).astype(np.float32)
    d = np.array([5.0, 9.5, 16.0], np.float32)
    got = balls.fft_ball_conv(_t(x), _t(d), gaussian=True, max_diameter=64)
    ref = jax.vmap(lambda a, b: jballs.fft_ball_conv(
        a, b, gaussian=True, max_diameter=64))(jnp.asarray(x), jnp.asarray(d))
    assert tuple(got.shape) == x.shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5
    for i in range(3):
        one = balls.fft_ball_conv(_t(x[i]), float(d[i]), gaussian=True,
                                  max_diameter=64)
        assert np.abs(one.numpy() - got[i].numpy()).max() <= 1e-6
    with pytest.raises(ValueError):
        balls.fft_ball_conv(torch.zeros(4, 4), 3.0)


def test_fft_ball_conv_of_a_point_is_the_ball():
    x = np.zeros((24, 24, 24), np.float32)
    x[12, 10, 14] = 1.0
    got = balls.fft_ball_conv(_t(x), 9.0, max_diameter=64).numpy()
    want = balls.insert_ball((24, 24, 24), tuple(_t(np.array(c)) for c in
                                                 (12, 10, 14)), 9.0).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_floor_sqrt_is_exact():
    t = np.arange(0, 70000, dtype=np.float32)
    got = balls._floor_sqrt(_t(t)).numpy()
    want = np.floor(np.sqrt(t.astype(np.float64)))
    np.testing.assert_array_equal(got, want.astype(np.float32))
    t = np.arange(-5, 3000, dtype=np.float32)  # callers mask t < 0
    np.testing.assert_array_equal(
        balls._floor_sqrt(_t(t)).numpy(),
        np.asarray(jballs._floor_sqrt(jnp.asarray(t))))
    quarter = np.arange(0, 4000, dtype=np.float32) + 0.25  # r² of odd d / 2
    np.testing.assert_array_equal(
        balls._floor_sqrt(_t(quarter)).numpy(),
        np.floor(np.sqrt(quarter.astype(np.float64))).astype(np.float32))


DIAMETERS = [1.0, 3.0, 8.0, 12.4, 23.0, 40.0, 77.0, 115.2]


@pytest.mark.parametrize("shape", [(24, 24, 24), (135, 135, 135),
                                   (40, 33, 18)], ids=str)
def test_ball_count_wrapped_matches_jax_and_the_kernel(shape):
    d = np.asarray(DIAMETERS, np.float32)
    got = balls.ball_count_wrapped(shape, _t(d)).numpy()
    ref = np.array([float(jballs.ball_count_wrapped(shape, jnp.float32(v)))
                    for v in d], np.float32)
    np.testing.assert_array_equal(got, ref)
    if shape[0] <= 40:  # and against the materialised kernel
        want = [float(balls.ball_kernel_wrapped(shape, float(v)).sum())
                for v in d]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert float(balls.ball_count_wrapped(shape, 8.0)) == ref[2]


CENTERS = [(0, 0, 0), (3, 20, 11), (23, 23, 23), (12, 0, 17)]


@pytest.mark.parametrize("center", CENTERS, ids=str)
def test_ball_count_clipped_and_insert_ball_match_jax(center):
    shape = (24, 26, 28)
    d = np.asarray(DIAMETERS, np.float32)
    c_t = tuple(_t(np.array(c)) for c in center)
    c_j = tuple(jnp.asarray(c) for c in center)
    counts = balls.ball_count_clipped(
        shape, tuple(c[None] for c in c_t), _t(d)).numpy()
    assert counts.shape == d.shape
    for i, v in enumerate(d):
        ball = balls.insert_ball(shape, c_t, float(v))
        ref = np.asarray(jballs.insert_ball(shape, c_j, jnp.float32(v)))
        assert ball.dtype == torch.float32 and tuple(ball.shape) == shape
        np.testing.assert_array_equal(ball.numpy(), ref)
        assert counts[i] == ref.sum()
        assert counts[i] == float(jballs.ball_count_clipped(
            shape, c_j, jnp.float32(v)))


def test_counts_and_balls_broadcast_over_items_and_rungs():
    """The Ball Loss's call: centres (B, 1) against a (B, G) ladder."""
    shape = (20, 22, 24)
    cz, cy, cx = (_t(np.array(v)) for v in ([0, 10, 19], [5, 11, 0],
                                            [23, 12, 3]))
    ladder = _t(np.array([[4.0, 6.0, 9.0, 14.0]] * 3, np.float32)) * 1.2
    counts = balls.ball_count_clipped(
        shape, (cz[:, None], cy[:, None], cx[:, None]), ladder)
    assert tuple(counts.shape) == (3, 4)
    for b in range(3):
        stack = balls.insert_ball(
            shape, (cz[b].expand(4), cy[b].expand(4), cx[b].expand(4)),
            ladder[b])
        assert tuple(stack.shape) == (4,) + shape
        np.testing.assert_array_equal(counts[b].numpy(),
                                      stack.sum(dim=(1, 2, 3)).numpy())
    items = balls.insert_ball(shape, (cz, cy, cx), ladder[:, 2])
    assert tuple(items.shape) == (3,) + shape
    np.testing.assert_array_equal(items.sum(dim=(1, 2, 3)).numpy(),
                                  counts[:, 2].numpy())
