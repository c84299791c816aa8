"""The port's metrics (``rsuper_tpu_torch/metrics/``) against the JAX
package's (``rsuper_tpu/metrics/``), on the CPU: every function returns the
same floats (bit-equal) on the same masks — random masks, boxes, empty
masks, masks touching the volume's border, and anisotropic spacing. The
port computes the surface distances on the masks' bounding box, one voxel
wider; the JAX package on the whole volume."""

import numpy as np
import pytest

from rsuper_tpu.metrics import dice as jdice
from rsuper_tpu.metrics import surface as jsurface
from rsuper_tpu_torch import metrics
from rsuper_tpu_torch.metrics import dice, surface


def _box(shape, lo, hi):
    m = np.zeros(shape, bool)
    m[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
    return m


def _pair(kind, seed):
    """(pred, target, sampling) of one kind of case."""
    rng = np.random.default_rng(seed)
    shape = (18, 22, 20)
    if kind == "random":
        return (rng.random(shape) < 0.3, rng.random(shape) < 0.2,
                (1.0, 1.0, 1.0))
    if kind == "boxes":
        return (_box(shape, (3, 4, 5), (12, 15, 14)),
                _box(shape, (5, 2, 6), (14, 12, 18)), (1.0, 1.0, 1.0))
    if kind == "border":  # both masks touch the volume's faces
        t = _box(shape, (0, 0, 3), (9, 22, 20))
        return t | (rng.random(shape) < 0.05), t, (1.0, 1.0, 1.0)
    if kind == "anisotropic":
        return (_box(shape, (2, 3, 4), (10, 18, 9)),
                rng.random(shape) < 0.1, (1.5, 0.8, 1.25))
    if kind == "empty_pred":
        return np.zeros(shape, bool), _box(shape, (2, 2, 2), (6, 7, 8)), \
            (1.0, 1.0, 1.0)
    if kind == "empty_target":
        return _box(shape, (2, 2, 2), (6, 7, 8)), np.zeros(shape, bool), \
            (1.0, 1.0, 1.0)
    if kind == "both_empty":
        return np.zeros(shape, bool), np.zeros(shape, bool), (1.0, 1.0, 1.0)
    if kind == "solid":  # no surface inside the box: a filled volume
        return np.ones(shape, bool), _box(shape, (1, 1, 1), (17, 21, 19)), \
            (1.0, 1.0, 1.0)
    raise ValueError(kind)


KINDS = ["random", "boxes", "border", "anisotropic", "empty_pred",
         "empty_target", "both_empty", "solid"]


@pytest.mark.parametrize("kind", KINDS)
def test_surface_metrics_bit_equal_to_jax(kind):
    for seed in range(3):
        p, t, s = _pair(kind, seed)
        got, want = (surface.surface_distances(p, t, s),
                     jsurface.surface_distances(p, t, s))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        asd = jsurface.average_surface_distance(p, t, s)
        hd = jsurface.hausdorff95(p, t, s)
        assert surface.average_surface_distance(p, t, s) == asd
        assert surface.hausdorff95(p, t, s) == hd
        assert surface.asd_hd95(p, t, s) == (asd, hd)
        for tol in (0.5, 1.0, 2.5):
            assert (surface.normalized_surface_dice(p, t, tol, s)
                    == jsurface.normalized_surface_dice(p, t, tol, s))


@pytest.mark.parametrize("kind", KINDS)
def test_dice_bit_equal_to_jax(kind):
    p, t, _ = _pair(kind, 0)
    assert dice.dice_score(p, t) == jdice.dice_score(p, t)
    stack_p = np.stack([p, t, p & t], -1)
    stack_t = np.stack([t, t, p], -1)
    got = dice.dice_per_class(stack_p, stack_t)
    want = jdice.dice_per_class(stack_p, stack_t)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_the_clamp_and_the_public_names():
    p, t, s = _pair("empty_pred", 0)
    assert metrics.asd_hd95(p, t, s) == (surface.MAX_DISTANCE,) * 2
    far = np.zeros((4, 4, 1200), bool)
    far[..., 0] = far[..., -1] = True
    near = np.zeros_like(far)
    near[..., 0] = True  # half of `far`'s surface lies 1199 voxels away
    assert metrics.hausdorff95(near, far) == surface.MAX_DISTANCE
    assert metrics.hausdorff95(near, far) == jsurface.hausdorff95(near, far)
