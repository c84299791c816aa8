"""The 2D slice training dataset (the port's own copy of
``rsuper_tpu/data/dataset2d.py``).

Axial slices sampled from the same preprocessed 3D npz cases
(``data/preprocess.py`` layout), foreground-biased, randomly cropped with
padding, with host-side flips and intensity augmentation. A record is
``{image (H, W), label (C, H, W), unk, segment_mask, volumes (10,),
diameters (10, 3)}``, float32; report supervision does not exist in 2D, so
``unk``, ``segment_mask``, ``volumes`` and ``diameters`` are zeros that keep
the record contract. From the same ``np.random.Generator`` the records are
bit-equal to the JAX package's: the same draws in the same order.

Each record loads a whole case (``load_case``) for one slice: the loader's
cost a record is that of a 3D case.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from .dataset import Case
from .preprocess import load_case


@dataclasses.dataclass
class SliceDataConfig:
    classes: Tuple[str, ...]
    crop_size: Tuple[int, int] = (256, 256)
    fg_bias: float = 0.9  # probability of sampling a slice with foreground
    augment: bool = True


class SliceDataset:
    """Index-based sampler of augmented 2D slices: ``sample(i, rng)`` →
    fixed-shape records."""

    def __init__(self, cases: Sequence[Case], cfg: SliceDataConfig):
        self.cases = list(cases)
        self.cfg = cfg

    def __len__(self):
        return len(self.cases)

    def _pick_slice(self, labels: np.ndarray, rng) -> int:
        """Foreground-biased axial slice index. `labels`: (C, D, H, W) with
        channel 0 = background."""
        D = labels.shape[1]
        if self.cfg.fg_bias > 0 and rng.random() < self.cfg.fg_bias:
            fg = labels[1:].any(axis=(0, 2, 3))
            idx = np.flatnonzero(fg)
            if idx.size:
                return int(idx[rng.integers(idx.size)])
        return int(rng.integers(D))

    def _crop(self, img: np.ndarray, lab: np.ndarray, rng):
        """A crop_size window at a uniform offset; a slice smaller than the
        window is zero-padded at its high ends first."""
        H, W = self.cfg.crop_size
        h, w = img.shape
        ph, pw = max(0, H - h), max(0, W - w)
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw)))
            lab = np.pad(lab, ((0, 0), (0, ph), (0, pw)))
            h, w = img.shape
        y = int(rng.integers(h - H + 1))
        x = int(rng.integers(w - W + 1))
        return img[y:y + H, x:x + W], lab[:, y:y + H, x:x + W]

    def _augment(self, img: np.ndarray, lab: np.ndarray, rng):
        """Flips in W and H (p 0.5 each), then brightness ×U(0.8, 1.2),
        shift +U(−0.1, 0.1) and Gaussian noise of std U(0, 0.1) (p 0.3
        each), drawn in this order."""
        if rng.random() < 0.5:
            img, lab = img[:, ::-1], lab[:, :, ::-1]
        if rng.random() < 0.5:
            img, lab = img[::-1], lab[:, ::-1]
        if rng.random() < 0.3:  # brightness
            img = img * float(rng.uniform(0.8, 1.2))
        if rng.random() < 0.3:  # additive shift
            img = img + float(rng.uniform(-0.1, 0.1))
        if rng.random() < 0.3:  # gaussian noise
            img = img + rng.normal(0, float(rng.uniform(0, 0.1)), img.shape)
        return np.ascontiguousarray(img), np.ascontiguousarray(lab)

    def sample(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        case = self.cases[index % len(self.cases)]
        image, labels = load_case(case.path, num_classes=len(self.cfg.classes))
        z = self._pick_slice(labels, rng)
        img, lab = self._crop(image[z], labels[:, z], rng)
        if self.cfg.augment:
            img, lab = self._augment(img, lab, rng)
        return {
            "image": img.astype(np.float32),
            "label": lab.astype(np.float32),
            "unk": np.zeros_like(lab, np.float32),
            "segment_mask": np.zeros_like(lab, np.float32),
            "volumes": np.zeros((10,), np.float32),
            "diameters": np.zeros((10, 3), np.float32),
        }
