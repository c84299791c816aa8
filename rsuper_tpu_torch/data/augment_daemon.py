"""Offline crop pre-computation daemon (counterpart of
``rsuper_tpu/data/augment_daemon.py``; the reference's ``AugmentEternal.py``):
a second process samples the dataset without end and writes each case's
cropped record, which a reader takes in place of sampling online.

The expensive host work is reading and the report-targeted cropping; the
geometric and intensity augmentation stay on the device, fresh every epoch
(``pipeline.device_augment``), so a saved crop never goes stale. A record
keeps its affine flag. Masks are stored as bits along the channel axis.

Writes are atomic (a temporary file, then ``os.replace``), so a reader never
sees a torn file; a reader that fails on one case tries another index, then
samples online.

    python -m rsuper_tpu_torch.data.augment_daemon --data_root masks_npz/ \\
        --report_root reports_npz/ --reports per_tumor.csv \\
        --save_destination crops/ [--rounds N]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np

from .dataset import RSuperDataset

_PACKED_KEYS = ("label", "unk", "segment_mask")


def save_record(rec: Dict[str, np.ndarray], dest: str, case_id: str) -> str:
    """Write one record to ``<dest>/<case_id>.npz`` atomically; returns the
    path."""
    os.makedirs(dest, exist_ok=True)
    out = {"image": rec["image"].astype(np.float32),
           "volumes": rec["volumes"], "diameters": rec["diameters"],
           "apply_affine": np.asarray(rec.get("apply_affine", 1.0),
                                      np.float32)}
    for k in _PACKED_KEYS:
        out[k] = np.packbits(rec[k].astype(bool), axis=0)
        out[k + "_channels"] = np.asarray(rec[k].shape[0])
    path = os.path.join(dest, f"{case_id}.npz")
    tmp = os.path.join(dest, f".tmp_{os.getpid()}_{case_id}.npz")
    np.savez_compressed(tmp, **out)
    os.replace(tmp, path)
    return path


def load_record(dest: str, case_id: str) -> Dict[str, np.ndarray]:
    """The record `save_record` wrote, masks unpacked to uint8."""
    z = np.load(os.path.join(dest, f"{case_id}.npz"))
    rec = {"image": z["image"], "volumes": z["volumes"],
           "diameters": z["diameters"], "apply_affine": z["apply_affine"]}
    for k in _PACKED_KEYS:
        c = int(z[k + "_channels"])
        rec[k] = np.unpackbits(z[k], axis=0)[:c]
    return rec


class AugmentedRecordDataset:
    """``RSuperDataset.sample`` from the precomputed crops: on a failed read,
    another random index, then the record computed online."""

    def __init__(self, dataset: RSuperDataset, destination: str):
        self.dataset = dataset
        self.destination = destination

    def __len__(self):
        return len(self.dataset)

    def sample(self, index: int, rng=None):
        rng = rng or np.random.default_rng()
        for attempt in range(2):
            i = index if attempt == 0 else int(rng.integers(len(self.dataset)))
            case = self.dataset.cases[i % len(self.dataset.cases)]
            try:
                return load_record(self.destination, case.case_id)
            except Exception:
                continue
        return self.dataset.sample(index, rng)


def run_daemon(dataset: RSuperDataset, destination: str, seed: int = 0,
               max_rounds: Optional[int] = None,
               sleep_on_error: float = 10.0) -> None:
    """Recompute every case's crop, round after round (`max_rounds` rounds,
    or without end); a case that fails is reported, waited on and skipped,
    as the reference daemon keeps serving."""
    rng = np.random.default_rng(seed)
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        for i in range(len(dataset)):
            case = dataset.cases[i]
            try:
                rec = dataset.sample(i, rng)
                save_record(rec, destination, case.case_id)
            except Exception as e:  # noqa: BLE001 — keep serving
                print(f"augment daemon error on {case.case_id}: {e}",
                      flush=True)
                time.sleep(sleep_on_error)
        rounds += 1


def main(argv=None):
    """The daemon's CLI, with the training CLI's case discovery."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_root", default=None)
    p.add_argument("--report_root", default=None)
    p.add_argument("--reports", default=None)
    p.add_argument("--save_destination", required=True)
    p.add_argument("--crop_size", type=int, nargs=3, default=(128, 128, 128))
    p.add_argument("--tumor_classes", nargs="+", default=["kidney", "pancreas"])
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..train.__main__ import discover_cases, load_classes
    from .dataset import RSuperDataConfig, build_case_list
    from .reports import clean_reports, load_reports

    classes = load_classes(args.data_root) if args.data_root else ()
    report_classes = load_classes(args.report_root) if args.report_root else ()
    mask_cases = discover_cases(args.data_root) if args.data_root else []
    report_cases = discover_cases(args.report_root) if args.report_root else []
    report_rows = None
    if args.reports:
        rows = load_reports(args.reports)
        rows = rows.filter(rows["BDMAP_ID"].isin({c for c, _ in report_cases}))
        rows, usable, _ = clean_reports(rows, list(args.tumor_classes))
        report_cases = [(c, p) for c, p in report_cases if c in set(usable)]
        report_rows = rows

    cases = build_case_list(mask_cases, report_cases, seed=args.seed)
    cfg = RSuperDataConfig(
        classes=tuple(classes), report_classes=tuple(report_classes),
        crop_size=tuple(args.crop_size),
        tumor_classes=tuple(args.tumor_classes),
    )
    dataset = RSuperDataset(cases, cfg, report_rows=report_rows)
    run_daemon(dataset, args.save_destination, seed=args.seed,
               max_rounds=args.rounds)


if __name__ == "__main__":
    main()
