"""Host-side (loader-worker) augmentation: the reference's pipeline mode
(the port's counterpart of ``rsuper_tpu/data/host_augment.py``).

The default pipeline augments on the device (``pipeline.device_augment``).
The reference augments in DataLoader workers that overlap with GPU compute
(``rsuper_train/train_ddp.py:114`` num_workers + ``AugmentEternal.py``):
this module is that mode, the same geometric and intensity stack in
numpy/scipy inside ``PrefetchLoader`` workers (``host_augment`` in the
config). Given the same ``np.random.Generator`` and record, every output
equals the JAX package's: the same draws in the same order, the same theta,
window coordinates, ``map_coordinates`` calls and intensity ops.

All 3·C binary mask channels travel through the warp as ONE float64 word
per voxel (exact up to 52 channels), so the nearest-neighbour resample is a
single ``map_coordinates`` call. The words are built from the loader's
packed bytes (``pipeline.pack_masks``), and unpacked with integer bit
operations: the same exact integers as the JAX package's float64 matmul and
floor/mod, without its float64 copy of every channel. Records leave the
worker with the image in float32 and the masks as uint8 0/1 (the JAX
package emits both in the step's type through ``ml_dtypes``, which the port
does not use); ``to_step_dtype`` casts them on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .pipeline import pack_masks

AUGMENTED = ("image", "label", "unk", "segment_mask")  # what the step casts
MAX_MASK_CHANNELS = 52  # exact integers in a float64 word
AFFINE_PROB = 0.4  # the reference's odds of a random affine a record
INTENSITY_PROB = 0.3  # ... and of each of the six intensity ops


def _theta_np(rng: np.random.Generator, scale, rotate_deg, translate,
              shear=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Numpy mirror of `augment._affine_theta` (same composition
    rx·ry·rz·A, same parameter distributions)."""
    scale = np.asarray(scale, np.float32)
    sc = rng.uniform(1.0 - scale, 1.0 / np.maximum(1.0 - scale, 1e-3))
    sh2 = np.repeat(np.asarray(shear, np.float32), 2)
    sh = rng.uniform(-sh2, sh2 + 1e-12)
    tr3 = np.asarray(translate, np.float32)
    tr = rng.uniform(-tr3, tr3 + 1e-8)
    rot = np.asarray(rotate_deg, np.float32)
    ang = rng.uniform(-rot, np.maximum(rot, 1.0)) * (np.pi / 180.0)

    A = np.array([
        [sc[0], sh[0], sh[1], tr[0]],
        [sh[2], sc[1], sh[3], tr[1]],
        [sh[4], sh[5], sc[2], tr[2]],
        [0.0, 0.0, 0.0, 1.0],
    ], np.float32)

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                         [0, 0, 0, 1]], np.float32)

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0],
                         [0, 0, 0, 1]], np.float32)

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]], np.float32)

    theta = rx(ang[0]) @ ry(ang[1]) @ rz(ang[2]) @ A
    return theta[:3, :]


def _window_coords(full_shape, theta, out_size, start):
    """Voxel-space source coordinates for the `out_size` window of the
    affine output grid — the exact formula of `augment._sample_window`
    (align-corners normalized coords)."""
    axes = [
        np.linspace(-1.0, 1.0, n, dtype=np.float32)[s: s + o]
        for n, o, s in zip(full_shape, out_size, start)
    ]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([zz, yy, xx, np.ones_like(zz)], 0).reshape(4, -1)
    src = theta.astype(np.float32) @ coords
    shp = np.asarray(full_shape, np.float32)
    return (src + 1.0) * 0.5 * (shp[:, None] - 1.0)


def affine_window_np(vol: np.ndarray, theta: np.ndarray, out_size, start,
                     order: int) -> np.ndarray:
    """scipy counterpart of `augment.affine_sample_window` on a (D, H, W)
    volume (same trilinear/nearest semantics, zero-padded)."""
    from scipy import ndimage

    vox = _window_coords(vol.shape, theta, out_size, start)
    out = ndimage.map_coordinates(vol, vox, order=order, mode="constant",
                                  cval=0.0)
    return out.reshape(out_size)


def _pack_f64(packed: np.ndarray) -> np.ndarray:
    """(..., W8) little-bitorder packed bytes → one float64 word per voxel
    whose bit j is channel j (exact: every partial sum is an integer below
    2^53)."""
    words = np.zeros(packed.shape[:-1], np.float64)
    for k in range(packed.shape[-1]):
        words += packed[..., k] * float(256 ** k)
    return words


def _unpack_f64(words: np.ndarray, C: int) -> np.ndarray:
    """Float64 words → (..., C) uint8 0/1: bit j of each word."""
    b = np.ascontiguousarray(words.astype("<u8")).view(np.uint8)
    b = b.reshape(words.shape + (8,))
    return np.unpackbits(b, axis=-1, count=C, bitorder="little")


def _center_crop(a: np.ndarray, size) -> np.ndarray:
    starts = [(s - c) // 2 for s, c in zip(a.shape[:3], size)]
    sl = tuple(slice(st, st + c) for st, c in zip(starts, size))
    return a[sl]


def intensity_augment_np(img: np.ndarray, rng: np.random.Generator,
                         noise_std_max: float = 0.2):
    """Numpy mirror of `augment.intensity_augment` (reference
    dataset_abdomenatlas_UFO.py:493-507: six ops, each with probability
    ``INTENSITY_PROB``)."""
    from scipy import ndimage

    p = INTENSITY_PROB
    img = img.astype(np.float32)
    if rng.uniform() < p:  # brightness multiplicative
        img = img * rng.uniform(0.7, 1.3)
    if rng.uniform() < p:  # brightness additive
        img = img + rng.normal(0.0, 0.1)
    if rng.uniform() < p:  # gamma, retain stats
        mean, std = img.mean(), img.std() + 1e-7
        mn = img.min()
        rngv = img.max() - mn + 1e-7
        g = rng.uniform(0.7, 1.5)
        img = ((img - mn) / rngv) ** g * rngv + mn
        img = (img - img.mean()) / (img.std() + 1e-7) * std + mean
    if rng.uniform() < p:  # contrast, preserve range
        mean, mn, mx = img.mean(), img.min(), img.max()
        img = np.clip((img - mean) * rng.uniform(0.7, 1.3) + mean, mn, mx)
    if rng.uniform() < p:  # gaussian blur
        sigma = rng.uniform(0.5, 1.5)
        # device path uses a static radius ceil(2.5*max_sigma)=4 and
        # zero-pads borders (lax conv); match both
        img = ndimage.gaussian_filter(img, sigma, truncate=4.0 / sigma,
                                      mode="constant", cval=0.0)
    if rng.uniform() < p:  # gaussian noise
        img = img + rng.normal(0.0, rng.uniform(0.0, noise_std_max),
                               img.shape).astype(np.float32)
    return img.astype(np.float32)


def make_host_augment(crop_size, scale=(0.0, 0.0, 0.0),
                      rotate=(30.0, 30.0, 30.0), translate=(0.0, 0.0, 0.0)):
    """`transform(rec, rng) -> rec` for `PrefetchLoader(transform=...)`:
    random affine (with probability ``AFFINE_PROB``, gated by the record's
    ``apply_affine``) + centre crop +
    intensity stack, computed in the loader worker on a channel-first
    record of ``RSuperDataset.sample``. Records leave channels-last at
    `crop_size` (image (*crop, 1) float32, masks (*crop, C) uint8) with
    ``apply_affine`` consumed, so the train loop runs NO device augmentation
    in this mode."""
    crop_size = tuple(crop_size)

    def transform(rec: Dict[str, np.ndarray], rng: np.random.Generator):
        img = np.asarray(rec["image"], np.float32)
        C = rec["label"].shape[0]
        if 3 * C > MAX_MASK_CHANNELS:
            raise ValueError(f"{3 * C} mask channels do not fit a float64 "
                             f"word ({MAX_MASK_CHANNELS} at most)")
        do_aff = (float(rec.get("apply_affine", 1.0)) > 0
                  and rng.uniform() < AFFINE_PROB)
        if do_aff:
            theta = _theta_np(rng, scale, rotate, translate)
            starts = tuple(
                (s - c) // 2 for s, c in zip(img.shape, crop_size))
            img = affine_window_np(img, theta, crop_size, starts, order=1)
            words = _pack_f64(pack_masks(rec["label"], rec["unk"],
                                         rec["segment_mask"]))
            words = affine_window_np(words, theta, crop_size, starts, order=0)
            masks = _unpack_f64(words, 3 * C)
            label, unk, seg = (masks[..., :C], masks[..., C: 2 * C],
                               masks[..., 2 * C:])
        else:
            img = _center_crop(img, crop_size)
            label, unk, seg = (
                _center_crop(np.moveaxis(rec[k], 0, -1), crop_size)
                for k in ("label", "unk", "segment_mask"))
        img = intensity_augment_np(img, rng)
        out = {k: v for k, v in rec.items() if k != "apply_affine"}
        out.update(image=img[..., None],
                   label=np.asarray(label, np.uint8),
                   unk=np.asarray(unk, np.uint8),
                   segment_mask=np.asarray(seg, np.uint8))
        return out

    return transform


def to_step_dtype(batch: Dict, dtype: torch.dtype) -> Dict:
    """A host-augmented batch on the device with its image and mask stacks
    in the step's type (the other entries as they are)."""
    return {k: v.to(dtype) if k in AUGMENTED else v for k, v in batch.items()}
