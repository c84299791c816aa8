#!/usr/bin/env python
"""End-to-end training throughput of the port on one GPU: the real loop's
machinery over synthetic preprocessed cases (the counterpart of the JAX
package's ``tools/bench_loop.py``).

    python -m rsuper_tpu_torch.bench_loop [--steps 24] [--warmup 4]
        [--size 96] [--batch 1] [--workers 4] [--augment device|host|off]
        [--no-overlap] [--device cpu] [--case_dir DIR]

``rsuper_tpu_torch/bench_train.py`` times the training step alone; the loop
also pays the host loader, the host→device transfer and the augmentation.
Each iteration here runs what the training CLI runs: ``RSuperDataset``
records (four synthetic CT-Mask cases written through ``preprocess_case``,
``make_cases``) → ``PrefetchLoader`` (`--workers` threads, records packed
for the transfer) → ``DevicePrefetcher`` (the transfer and the augmentation
of the next batches on a side stream; ``--no-overlap`` runs them inline) →
the augmentation (``device``: ``draw_augment`` + ``device_augment``;
``host``: ``make_host_augment`` in the loader's workers; ``off``: the
centre crop alone, in the workers) → the training step of the default
MedFormer (bf16 compute, float32 parameters, seeded) with
``LossConfig(loss="ball_dice_last")``, AdamW and EMA, as the JAX tool
builds it.

Prints one JSON line: the JAX tool's keys (``metric``
``e2e_train_patches_per_sec_per_gpu_<S>``, suffixed ``_host`` or ``_off``
and ``_inline`` as there; ``value``; ``unit``; ``loss``;
``h2d_ms_per_item``; ``h2d_mb_per_item``), the card's name and power
limit (``card``), the median and 90th-percentile ms of an iteration, the
median ms an iteration waits for its batch (``wait_ms_median``: the
prefetcher's output, or the loader inline), the median ms of a loader item
in its worker and the host's CPU count. A CPU run (``--device cpu``) names
its metric ``..._per_cpu_...``.

Every case is a mask case, so the Ball Loss finds no live report slot and
the top-N kernels are not launched, as in the JAX tool. Not ported: the JAX
tool's ``--cpu-mesh`` (a virtual-device dry run of its mesh; the port's
multi-rank runs are the training CLI's ``--dist_*`` flags) and
``RSUPER_AUG_FULLWARP`` (an A/B of an older JAX warp that the port does
not have).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .bench_train import CLASSES

CASE_DIR = Path(__file__).resolve().parent.parent / ".bench_cases" / "torch"
SCALE = (0.1, 0.1, 0.1)  # the JAX tool's affine ranges
ROTATE = (30.0, 30.0, 30.0)
MARGIN = 44  # a case's edge beyond the crop: room for the load window


def make_cases(n: int, size, case_dir=CASE_DIR):
    """`n` synthetic preprocessed cases of `size` voxels (a noisy CT with a
    pancreas box and a lesion box in it, written as NIfTI and put through
    ``preprocess_case``), the arrays those of the JAX tool's ``make_cases``.
    They land in ``<case_dir>/<D>x<H>x<W>/`` and are reused from there;
    returns their paths."""
    from .data.nifti import write_nifti
    from .data.preprocess import preprocess_case

    size = tuple(int(s) for s in size)
    root = Path(case_dir) / "x".join(map(str, size))
    root.mkdir(parents=True, exist_ok=True)
    out = []
    for i in range(n):
        npz = root / f"BDMAP_L{i}.npz"
        out.append(str(npz))
        if npz.exists():
            continue
        rng = np.random.default_rng(i)
        ct = rng.normal(scale=30.0, size=size).astype(np.float32)
        organ = np.zeros(size, np.uint8)
        organ[30:90, 40:100, 40:100] = 1
        lesion = np.zeros_like(organ)
        lesion[50:70, 60:84, 60:84] = 1
        ct[organ > 0] += 120.0
        ct[lesion > 0] += 160.0
        aff = np.eye(4)
        write_nifti(str(root / "ct.nii.gz"), ct, aff)
        write_nifti(str(root / "organ.nii.gz"), organ, aff)
        write_nifti(str(root / "lesion.nii.gz"), lesion, aff)
        tmp = root / f"BDMAP_L{i}.partial.npz"  # a reader never sees half
        preprocess_case(
            str(root / "ct.nii.gz"),
            {"background": None,
             "pancreas": str(root / "organ.nii.gz"),
             "pancreatic_lesion": str(root / "lesion.nii.gz")},
            str(tmp), classes=CLASSES, min_size=size)
        os.replace(tmp, npz)
        os.replace(tmp.with_suffix(".json"), npz.with_suffix(".json"))
    return out


def build_dataset(size: int, case_dir=CASE_DIR, n: int = 4):
    """The bench's ``RSuperDataset``: `n` mask cases of (size + MARGIN)³
    and the JAX tool's data configuration (crop size³, pancreas as the
    tumour class)."""
    from .data.dataset import Case, RSuperDataConfig, RSuperDataset

    crop = (size,) * 3
    npzs = make_cases(n, tuple(c + MARGIN for c in crop), case_dir)
    dcfg = RSuperDataConfig(
        classes=tuple(CLASSES),
        report_classes=tuple(c for c in CLASSES if "lesion" not in c),
        crop_size=crop, tumor_classes=("pancreas",))
    return RSuperDataset(
        [Case(f"BDMAP_L{i}", p, False) for i, p in enumerate(npzs)], dcfg)


def host_transform(augment: str, crop):
    """The loader workers' transform of an `augment` mode: None for the
    device augmentation (records packed for it), else the host
    augmentation (``off``: the centre crop alone)."""
    from .data.host_augment import make_host_augment

    if augment == "device":
        return None
    if augment == "host":
        return make_host_augment(crop, scale=SCALE, rotate=ROTATE)
    return make_host_augment(crop, affine_prob=0.0, intensity_prob=0.0)


def _h2d(probe, device, reps: int = 3) -> float:
    """ms of one record's transfer to `device` (after two warm-up calls)."""
    from .data.pipeline import to_device

    batch = {k: np.asarray(v)[None] for k, v in probe.items()}

    def once():
        out = to_device(batch, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    once(), once()
    t = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t) / reps * 1e3


def main(argv=None, model_args=None):
    """Runs the bench and returns its JSON line's dict. `model_args`
    overrides MedFormer arguments from Python (a small model for a run on
    the CPU); the command line always runs the default model."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--augment", choices=("device", "host", "off"),
                    default="device")
    ap.add_argument("--no-overlap", action="store_true",
                    help="transfer and augment inline, on the step's path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--case_dir", default=str(CASE_DIR),
                    help="where the synthetic cases are written and reused")
    args = ap.parse_args(argv)
    if args.warmup < 1 or args.steps < 1:
        ap.error("--warmup and --steps must be at least 1")

    from .bench_train import build_state
    from .data.host_augment import to_step_dtype
    from .data.pipeline import (DevicePrefetcher, PrefetchLoader,
                                device_augment, draw_augment,
                                pack_record_cf, to_device)
    from .losses import LesionChannelMap, LossConfig
    from .train import build_train_step
    from .utils.device import card_line, resolve_device

    device = resolve_device(args.device)  # before anything is written
    S = args.size
    crop = (S, S, S)
    dataset = build_dataset(S, args.case_dir)
    state = build_state(device, model_args=model_args)
    step_fn = build_train_step(LesionChannelMap.from_classes(CLASSES),
                               LossConfig(loss="ball_dice_last"))
    transform = host_transform(args.augment, crop)
    total = args.warmup + args.steps
    indices = [i % len(dataset) for i in range(total * args.batch)]
    loader = PrefetchLoader(dataset, args.batch, indices,
                            num_workers=args.workers, transform=transform)

    # the transfer alone: one loader record, as the loader ships it
    probe_rng = np.random.default_rng(0)
    probe = dataset.sample(0, probe_rng)
    probe = (pack_record_cf(probe) if transform is None
             else transform(probe, probe_rng))
    h2d_bytes = sum(np.asarray(v).nbytes for v in probe.values())
    h2d_ms = _h2d(probe, device)

    gen_host = torch.Generator().manual_seed(1)
    gen_dev = torch.Generator(device=device).manual_seed(1)

    def prepare(index, host):
        """A host batch on the device, augmented, in the step's type."""
        batch = to_device(host, device)
        if transform is not None:
            return to_step_dtype(batch, torch.bfloat16)
        draws = draw_augment(gen_host, gen_dev, args.batch, crop,
                             scale=SCALE, rotate=ROTATE)
        return device_augment(batch, draws, num_classes=len(CLASSES),
                              crop_size=crop, out_dtype=torch.bfloat16)

    host_batches = iter(loader)
    if args.no_overlap:
        source = (prepare(i, h) for i, h in enumerate(host_batches))
    else:
        source = iter(DevicePrefetcher(enumerate(host_batches), prepare,
                                       device, depth=2))

    def sync():
        if device.type == "cuda":
            torch.cuda.current_stream().synchronize()

    iter_ms, wait_ms, losses, n, t0 = [], [], None, 0, None
    try:
        t_prev = time.perf_counter()
        while True:
            t = time.perf_counter()
            batch = next(source, None)
            if batch is None:
                break
            waited = time.perf_counter() - t
            state, losses = step_fn(state, batch)
            sync()
            n += 1
            now = time.perf_counter()
            if n == args.warmup:
                _ = float(losses["overall"])  # drain the warm-up steps
                t0 = now = time.perf_counter()
            elif n > args.warmup:
                iter_ms.append((now - t_prev) * 1e3)
                wait_ms.append(waited * 1e3)
            t_prev = now
        final = float(losses["overall"])  # a host read: the chain is done
        elapsed = time.perf_counter() - t0
    finally:
        source.close()
        host_batches.close()
    steps = n - args.warmup
    unit = "gpu" if device.type == "cuda" else "cpu"
    result = {
        "metric": f"e2e_train_patches_per_sec_per_{unit}_{S}"
                  + ("" if args.augment == "device" else f"_{args.augment}")
                  + ("_inline" if args.no_overlap else ""),
        "value": steps * args.batch / elapsed,
        "unit": f"{S}^3 patches/s/{unit.upper()} (loader+h2d+augment+step, "
                f"{steps} steps)",
        "loss": final,
        "h2d_ms_per_item": h2d_ms,
        "h2d_mb_per_item": h2d_bytes / 1e6,
        "card": card_line() if device.type == "cuda" else None,
        "iter_ms_median": float(np.median(iter_ms)),
        "iter_ms_p90": float(np.percentile(iter_ms, 90)),
        "wait_ms_median": float(np.median(wait_ms)),
        "loader_item_ms_median": float(np.median(loader.item_seconds)) * 1e3,
        "steps": steps, "warmup": args.warmup, "batch": args.batch,
        "workers": args.workers, "augment": args.augment,
        "overlap": not args.no_overlap, "host_cpus": os.cpu_count(),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
