"""The port's device augmentation against the JAX package's, on the CPU.

JAX draws from a key stream PyTorch cannot reproduce, so the port's
functions take their draws as arguments; these tests replay the values JAX
draws from its own keys (the ``jax.random.split`` chain of
``rsuper_tpu/data/pipeline.py:_augment_items`` and
``rsuper_tpu/data/augment.py:intensity_augment``).

Tolerances (float32 on both sides):
* each intensity op, the blur and ``_affine_theta`` from given uniforms:
  max|Δ| ≤ 1e-6·(1 + max|ref|) (the same formulas; reductions and
  transcendental functions round differently);
* ``shear_affine_window`` and the augmented image: max|Δ| ≤
  1e-5·(1 + max|ref|) (ten passes of sums in another order);
* the bit packing, ``norm_axis`` against ``jnp.linspace``: exact;
* the nearest label window and the augmented masks: equal, except voxels
  whose source coordinate lies within 1e-4 of a half (where an ulp of
  ``theta @ coords`` flips the rounding); those are counted, and must be
  under 1% of the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.data import augment as jaug
from rsuper_tpu.data import pipeline as jpipe
from rsuper_tpu.ops import shear_warp as jshear
from rsuper_tpu_torch.data import augment as aug
from rsuper_tpu_torch.data import pipeline as pipe
from rsuper_tpu_torch.ops import shear_warp

OP_TOL, WARP_TOL, HALF_EPS, HALF_SHARE = 1e-6, 1e-5, 1e-4, 0.01
ROT, SCALE, TRANS = (30.0, 30.0, 30.0), (0.1, 0.2, 0.0), (0.05, 0.0, 0.1)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * (1 + np.abs(ref).max()), err


def _vol(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ intensity ops
@pytest.mark.parametrize("seed", range(3))
def test_intensity_ops_match_jax(seed):
    """Each op on the parameter JAX draws from `key` inside it."""
    x = _vol((12, 14, 10), seed) * 3.0
    key = jax.random.PRNGKey(7 + seed)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    u = lambda lo, hi: float(jax.random.uniform(key, (), minval=lo,  # noqa
                                                maxval=hi))
    _close(aug.brightness_multiply(t, u(0.7, 1.3)),
           jaug.brightness_multiply(j, key), OP_TOL)
    _close(aug.gamma(t, u(0.7, 1.5)), jaug.gamma(j, key), OP_TOL)
    _close(aug.contrast(t, u(0.7, 1.3)), jaug.contrast(j, key), OP_TOL)
    n = float(jax.random.normal(key, (), jnp.float32))
    _close(aug.brightness_additive(t, n), jaug.brightness_additive(j, key),
           OP_TOL)
    noise = jax.random.normal(key, x.shape, jnp.float32)
    std = u(0.0, 0.2)
    _close(aug.gaussian_noise(t, torch.from_numpy(np.array(noise)), std),
           jaug.gaussian_noise(j, key, jnp.float32(std)), OP_TOL)


@pytest.mark.parametrize("sigma", [0.5, 0.83, 1.5])
def test_blur_matches_jax(sigma):
    x = _vol((11, 13, 9), 2)
    got = aug.gaussian_blur(torch.from_numpy(x), sigma)
    _close(got, jaug.gaussian_blur(jnp.asarray(x), jnp.float32(sigma)), OP_TOL)
    np.testing.assert_allclose(aug._gauss_kernel1d(sigma, 4),
                               jaug._gauss_kernel1d(jnp.float32(sigma), 4),
                               rtol=1e-6)


def _jax_intensity_draws(k_int, shape):
    """The intensity stack's draws from JAX's own functions on its keys
    (``augment.py:intensity_augment``)."""
    keys = jax.random.split(k_int, 12)
    f = lambda v: np.float32(v)  # noqa: E731
    return dict(
        coins=np.asarray(jax.random.uniform(keys[0], (6,))),
        multiply=f(jax.random.uniform(keys[1], (), minval=0.7, maxval=1.3)),
        additive=f(jax.random.normal(keys[2], (), jnp.float32)),
        gamma_g=f(jax.random.uniform(keys[3], (), minval=0.7, maxval=1.5)),
        contrast_f=f(jax.random.uniform(keys[4], (), minval=0.7, maxval=1.3)),
        sigma=f(jax.random.uniform(keys[5], (), minval=0.5, maxval=1.5)),
        noise_std=f(jax.random.uniform(keys[6], (), minval=0.0, maxval=0.2)),
        noise=torch.from_numpy(np.array(
            jax.random.normal(keys[7], shape, jnp.float32))))


def test_intensity_stack_matches_jax_key_stream():
    x = _vol((10, 12, 8), 3)
    fired = np.zeros(6, int)
    for s in range(24):
        k = jax.random.PRNGKey(100 + s)
        d = _jax_intensity_draws(k, x.shape)
        fired += d["coins"] < 0.3
        got = aug.intensity_augment(torch.from_numpy(x), p=0.3, **d)
        _close(got, jaug.intensity_augment(jnp.asarray(x), k, p=0.3), OP_TOL)
    assert (fired > 0).all()  # every op ran in some draw


# ----------------------------------------------------------------- affine
def _theta_uniforms(key):
    """JAX's unit floats behind ``_affine_theta(key, ...)``: its uniform is
    max(lo, u·(hi − lo) + lo) of these."""
    ks = jax.random.split(key, 4)
    return [np.asarray(jax.random.uniform(k, (n,)))
            for k, n in zip(ks, (3, 6, 3, 3))]


@pytest.mark.parametrize("seed", range(4))
def test_affine_theta_from_uniforms_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    u = _theta_uniforms(key)
    for scale, rot, tr in ((SCALE, ROT, TRANS), ((0.0,) * 3, ROT, (0.0,) * 3)):
        got = aug._affine_theta(*u, scale, rot, tr)
        want = jaug._affine_theta(key, scale, rot, tr, (0.0, 0.0, 0.0))
        assert got.dtype == np.float32 and got.shape == (3, 4)
        _close(got, want, OP_TOL)


def test_norm_axis_equals_jnp_linspace():
    # every edge up to 352 rounds alike (checked); the pipeline's are ≤ 168
    for n in (1, 2, 3, 16, 36, 97, 128, 148, 168, 352):
        np.testing.assert_array_equal(shear_warp.norm_axis(n).numpy(),
                                      np.asarray(jnp.linspace(-1.0, 1.0, n)))


@pytest.mark.parametrize("seed", range(3))
def test_decompose_affine_matches_jax(seed):
    key = jax.random.PRNGKey(10 + seed)
    theta = np.asarray(jaug._affine_theta(key, SCALE, ROT, TRANS,
                                          (0.0, 0.0, 0.0)))
    passes, d = shear_warp.decompose_affine(theta)
    jpasses, jd = jshear.decompose_affine(jnp.asarray(theta))
    _close(d, jd, OP_TOL)
    prod = np.eye(4)
    for p, jp in zip(passes, jpasses):
        assert p[0] == jp[0]
        if p[0] == "shear":
            assert p[1][:2] == jp[1][:2]
            _close(p[1][2], jp[1][2], OP_TOL)
        prod = prod @ shear_warp.pass_matrix(p)
    np.testing.assert_allclose(prod[:3], theta, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_shear_affine_window_matches_jax(seed):
    key = jax.random.PRNGKey(20 + seed)
    theta = np.asarray(jaug._affine_theta(key, SCALE, ROT, TRANS,
                                          (0.0, 0.0, 0.0)))
    vol = _vol((30, 36, 32), seed)
    crop, start = (16, 20, 18), (7, 8, 7)
    got = shear_warp.shear_affine_window(torch.from_numpy(vol), theta, crop,
                                         start)
    want = jshear.shear_affine_window(jnp.asarray(vol), jnp.asarray(theta),
                                      crop, start)
    _close(got, want, WARP_TOL)


# ------------------------------------------------------ bits and labels
def test_bit_packing_matches_jax_exactly():
    rng = np.random.default_rng(9)
    m = (rng.random((4, 5, 3, 50)) > 0.5).astype(np.float32)
    packed = np.packbits(m.astype(np.uint8), axis=-1, bitorder="little")
    words = pipe._bytes_to_words(torch.from_numpy(packed))
    np.testing.assert_array_equal(words.numpy(), np.asarray(
        jpipe._bytes_to_words(jnp.asarray(packed))))
    # the host's bytes make the words JAX packs from the one-hot channels
    np.testing.assert_array_equal(words.numpy(), np.asarray(
        jpipe._pack_bits(jnp.asarray(m))))
    assert tuple(words.shape) == (4, 5, 3, 3)
    np.testing.assert_array_equal(pipe._unpack_bits(words, 50).numpy(), m)


def _half_voxels(full, theta, out, start):
    """Voxels whose source coordinate (by JAX's own arithmetic) lies within
    HALF_EPS of a half on any axis."""
    vox = np.asarray(jaug._window_vox(full, jnp.asarray(theta), out, start))
    near = np.abs(vox - np.floor(vox) - 0.5) < HALF_EPS
    return near.any(axis=0).reshape(out)


def _mask_mismatches(got, want, half):
    diff = (np.asarray(got) != np.asarray(want)).any(axis=-1)
    assert not (diff & ~half).any(), "a mask voxel differs off a half"
    assert half.mean() < HALF_SHARE
    return int(diff.sum())


@pytest.mark.parametrize("seed", range(3))
def test_nearest_window_matches_jax(seed):
    key = jax.random.PRNGKey(30 + seed)
    theta = np.asarray(jaug._affine_theta(key, SCALE, ROT, TRANS,
                                          (0.0, 0.0, 0.0)))
    rng = np.random.default_rng(seed)
    full, crop, start = (26, 30, 28), (14, 18, 16), (6, 6, 6)
    words = rng.integers(0, 2 ** 24, size=full + (2,)).astype(np.float32)
    got = aug._nearest_window_multichannel(torch.from_numpy(words), theta,
                                           crop, start)
    want = jaug._nearest_window_multichannel(jnp.asarray(words),
                                             jnp.asarray(theta), crop, start)
    _mask_mismatches(got.numpy(), want, _half_voxels(full, theta, crop, start))
    vz, vy, vx = aug._window_vox(full, theta, crop, start)
    jv = np.asarray(jaug._window_vox(full, jnp.asarray(theta), crop, start))
    for i, v in enumerate((vz, vy, vx)):
        np.testing.assert_allclose(v.numpy().reshape(-1), jv[i], atol=1e-4)


# --------------------------------------------------------- whole augment
LOAD, CROP, C = (26, 34, 30), (16, 20, 18), 5


def _host_batch(B=4, seed=0):
    rng = np.random.default_rng(seed)
    lab = np.zeros((B,) + LOAD + (C,), np.uint8)
    lab[:, 6:20, 8:26, 5:24, 1] = 1
    lab[:, 10:14, 12:18, 9:15, 3] = 1
    unk = (rng.random((B,) + LOAD + (C,)) < 0.05).astype(np.uint8)
    seg = np.zeros_like(lab)
    seg[1, 8:16, 10:20, 8:20, 4] = 1
    return {
        "image": rng.normal(size=(B,) + LOAD + (1,)).astype(np.float32),
        "label": lab, "unk": unk, "segment_mask": seg,
        "volumes": rng.random((B, 10)).astype(np.float32),
        "diameters": rng.random((B, 10, 3)).astype(np.float32),
        "apply_affine": np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)[:B],
    }


def _packed(host):
    """The host batch as the loader sends it: the mask stacks as one
    ``masks_packed`` byte plane and the image as float16 (the JAX package's
    ``pack_record_masks``, item by item)."""
    B = host["image"].shape[0]
    recs = [jpipe.pack_record_masks({k: v[i] for k, v in host.items()})
            for i in range(B)]
    return {k: np.stack([r[k] for r in recs]) for k in recs[0]}


def _jax_draws(key, B):
    """``_augment_items``'s draws for ``device_augment(batch, key)``: one key
    an item (``jax.random.split(key, B)``), split into the affine, coin and
    intensity keys."""
    out = {k: [] for k in ("theta", "affine_coin", "coins", "multiply",
                           "additive", "gamma", "contrast", "sigma",
                           "noise_std", "noise")}
    for k in jax.random.split(key, B):
        k_aff, k_coin, k_int = jax.random.split(k, 3)
        out["theta"].append(np.asarray(jaug._affine_theta(
            k_aff, SCALE, ROT, TRANS, (0.0, 0.0, 0.0))))
        out["affine_coin"].append(np.float32(jax.random.uniform(k_coin)))
        d = _jax_intensity_draws(k_int, CROP)
        for name, src in (("coins", "coins"), ("multiply", "multiply"),
                          ("additive", "additive"), ("gamma", "gamma_g"),
                          ("contrast", "contrast_f"), ("sigma", "sigma"),
                          ("noise_std", "noise_std"), ("noise", "noise")):
            out[name].append(d[src])
    noise = torch.stack(out.pop("noise"))
    return pipe.AugmentDraws(noise=noise,
                             **{k: np.stack(v) for k, v in out.items()})


def test_augment_items_match_jax_device_augment():
    host = _packed(_host_batch())
    B = host["image"].shape[0]
    key = jax.random.PRNGKey(4)
    draws = _jax_draws(key, B)
    warp = (host["apply_affine"] > 0) & (draws.affine_coin < 0.4)
    assert warp.any() and not warp.all()  # both branches run
    want = jpipe.device_augment(
        {k: jnp.asarray(v) for k, v in host.items()}, key, crop_size=CROP,
        scale=SCALE, rotate=ROT, translate=TRANS, num_classes=C)
    got = pipe.device_augment(pipe.to_device(host, "cpu"), draws,
                              crop_size=CROP, num_classes=C)
    assert sorted(got) == sorted(want)
    _close(got["image"].numpy(), want["image"], WARP_TOL)
    masks = np.concatenate([got[k].numpy() for k in
                            ("label", "unk", "segment_mask")], -1)
    jmasks = np.concatenate([np.asarray(want[k]) for k in
                             ("label", "unk", "segment_mask")], -1)
    starts = tuple((s - c) // 2 for s, c in zip(LOAD, CROP))
    flipped = 0
    for i in range(B):
        half = (_half_voxels(LOAD, draws.theta[i], CROP, starts) if warp[i]
                else np.zeros(CROP, bool))
        flipped += _mask_mismatches(masks[i], jmasks[i], half)
    for k in ("volumes", "diameters"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["image"].shape == (B,) + CROP + (1,)
    assert got["label"].dtype == torch.float32 and set(
        np.unique(masks)) <= {0.0, 1.0}


def test_draw_augment_is_seeded_and_in_range():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return pipe.draw_augment(g, torch.Generator().manual_seed(seed), 3,
                                 CROP, SCALE, ROT, TRANS)

    a, b, c = draw(1), draw(1), draw(2)
    for name in ("theta", "coins", "multiply", "sigma", "noise_std"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.theta, c.theta)
    assert torch.equal(a.noise, b.noise) and tuple(a.noise.shape) == (3,) + CROP
    assert ((0.7 <= a.multiply) & (a.multiply <= 1.3)).all()
    assert ((0.5 <= a.sigma) & (a.sigma <= 1.5)).all()
    assert ((0.0 <= a.noise_std) & (a.noise_std <= 0.2)).all()
    out = pipe.device_augment(
        pipe.to_device(_packed(_host_batch(3)), "cpu"), a, crop_size=CROP,
        out_dtype=torch.bfloat16, num_classes=C)
    assert out["image"].dtype == torch.bfloat16
    assert torch.isfinite(out["image"].float()).all()
