#!/usr/bin/env python
"""Where a loader item's time goes: one ``RSuperDataset.sample`` →
``pack_record_cf`` item split into its stages (the counterpart of the JAX
package's ``tools/profile_loader.py``). Host only; needs no card.

    python -m rsuper_tpu_torch.profile_loader [D H W] [--case_dir DIR]

One synthetic case of D × H × W voxels (default 140³, the loop bench's
96³ crop and its margin; ``bench_loop.make_cases``) and the loop bench's
data configuration. Each stage is timed over REPS calls after one
warm-up call, with the JAX tool's labels: ``dataset.sample`` whole,
``np.load`` of every array and of the image alone, ``np.unpackbits`` of
the labels, ``load_case``, ``pad_pair``, ``random_crop_on_tumor``,
``to_channels_last`` of a sample, and ``sample`` + ``pack_record_cf``,
then the packed record's size. The JAX tool's ``pack_record_masks`` ("old
CL path") has no counterpart in the port and is left out. Prints a line a
stage, then one JSON line with each stage's ms, the packed MB and
``os.cpu_count()``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict

import numpy as np

from .bench_loop import CASE_DIR, CLASSES, MARGIN, make_cases

REPS = 5  # timed calls a stage, as in the JAX tool


def stages(npz: str, seed: int = 0) -> Dict[str, Callable[[], object]]:
    """The stages of one item of the case at `npz`, by label, in order: each
    a call without arguments that returns the stage's output, the random
    ones drawing from a generator seeded with `seed` at each call."""
    from .data import crops
    from .data.dataset import (Case, RSuperDataConfig, RSuperDataset,
                               to_channels_last)
    from .data.pipeline import pack_record_cf
    from .data.preprocess import load_case

    with np.load(npz) as z:
        size = tuple(int(s) for s in z["image"].shape)
    dcfg = RSuperDataConfig(
        classes=tuple(CLASSES),
        report_classes=tuple(c for c in CLASSES if "lesion" not in c),
        crop_size=tuple(s - MARGIN for s in size),
        tumor_classes=("pancreas",))
    ds = RSuperDataset([Case("BDMAP_L0", npz, False)], dcfg)
    rng = lambda: np.random.default_rng(seed)  # noqa: E731

    def arrays():
        with np.load(npz) as z:
            return dict(z.items())

    def image():
        with np.load(npz) as z:
            return z["image"]

    packed = arrays()["labels"]
    img, lab = load_case(npz, num_classes=len(CLASSES))
    return {
        "dataset.sample (total)": lambda: ds.sample(0, rng()),
        "np.load+read arrays": arrays,
        "  np.load image only": image,
        "  unpackbits(labels)":
            lambda: np.unpackbits(packed, axis=0)[:len(CLASSES)],
        "load_case": lambda: load_case(npz, num_classes=len(CLASSES)),
        "pad_pair": lambda: crops.pad_pair(img, lab, dcfg.load_size),
        "random_crop_on_tumor": lambda: crops.random_crop_on_tumor(
            img, lab, dcfg.lesion_class_indices(), dcfg.load_size, True,
            foreground_classes=dcfg.foreground_class_indices(), rng=rng()),
        "to_channels_last": lambda: to_channels_last(ds.sample(0, rng())),
        "sample+pack_record_cf (fast path)":
            lambda: pack_record_cf(ds.sample(0, rng())),
    }


def timed(fn: Callable[[], object]) -> float:
    """ms a call of `fn`, over REPS calls after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) / REPS * 1e3


def main(argv=None):
    """Runs the profile and returns its JSON line's dict."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", type=int, nargs="*", default=[140, 140, 140],
                    help="the case's D H W")
    ap.add_argument("--case_dir", default=str(CASE_DIR))
    args = ap.parse_args(argv)
    if len(args.size) != 3:
        ap.error("give the case's size as D H W")
    npz = make_cases(1, tuple(args.size), args.case_dir)[0]
    ms = {}
    parts = stages(npz)
    for label, fn in parts.items():
        ms[label.strip()] = timed(fn)
        print(f"{label:34s} {ms[label.strip()]:8.1f} ms", flush=True)
    rec = parts["sample+pack_record_cf (fast path)"]()
    mb = sum(np.asarray(v).nbytes for v in rec.values()) / 1e6
    print(f"{'packed payload':34s} {mb:8.1f} MB", flush=True)
    result = {"stages_ms": ms, "packed_mb": mb, "size": list(args.size),
              "reps": REPS, "host_cpus": os.cpu_count()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
