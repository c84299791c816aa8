"""Phantom accuracy benchmark on the port: does report supervision beat
mask-only? (Counterpart of ``tools/phantom_benchmark.py``, same functions,
flags and outputs.)

The reference's core claim is that training on CT-Report cases through the
Volume/Ball losses improves tumour detection over mask-only training. This
script builds a synthetic stand-in with KNOWN ground truth and runs the
port's whole pipeline:

  generate phantoms -> train (A: mask-only, B: mask+report ball_dice_last)
  -> sliding-window predict on held-out cases -> lesion Dice, NSD and
  case-level detection F1 -> one JSON line comparing A vs B.

Phantom design: each case is a noisy CT with a bright pancreas ellipsoid
split into head/body/tail thirds; tumours are brighter spheres placed in a
random third. Tumour contrast varies per case, so a handful of mask cases
cannot cover the appearance distribution; the report cases (organ masks +
per-tumour CSV rows only, no voxel tumour labels) carry the missing
coverage, the R-Super data regime.

    python -m rsuper_tpu_torch.phantom_benchmark --out OUT [--steps 240]
    python -m rsuper_tpu_torch.phantom_benchmark --device cpu --out OUT \\
        --n_mask 1 --n_report 2 --n_test 2 --steps 2 --crop 16

It runs on CUDA unless ``--device cpu`` is given, and never falls back to
the CPU. The generated arrays and CSVs are those of the JAX tool for the
same seed; ``summary.json`` and ``seed<k>/result.json`` have its layout, so
``tools/summarize_phantom.py`` reads them. Each seed's record also holds a
``timing`` entry (seconds a stage, ms a step an arm), and ``timing.json``
holds the run's wall time and the card it ran on.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

MASK_CLASSES = ["background", "pancreas", "pancreatic_lesion"]
REPORT_CLASSES = ["background", "pancreas_body", "pancreas_head",
                  "pancreas_tail"]
SIZE = 64  # phantom volume side (1 mm voxels)
KEYS = ("lesion_dice", "lesion_nsd", "f1", "sensitivity")
THRESHOLDS = (5, 10, 20, 40, 80, 160, 320, 640)  # detection volume sweep


# --------------------------------------------------------------- generation
def _ellipsoid(shape, center, radii):
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    d = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
    return d <= 1.0


def make_phantom(seed: int, with_tumor_prob: float = 0.8,
                 contrast_range=(0.5, 1.6), radius_range=(3.0, 6.5)):
    """One phantom: returns (image, organ(3 thirds), lesion, tumor_rows)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(scale=1.0, size=(SIZE, SIZE, SIZE)).astype(
        np.float32) * 0.3
    center = rng.uniform(24, 40, 3)
    radii = rng.uniform(10, 16, 3)
    organ = _ellipsoid((SIZE,) * 3, center, radii)
    img[organ] += 1.0
    # head/body/tail thirds along x relative to the organ extent
    xs = np.where(organ.any(axis=(1, 2)))[0]
    t1, t2 = xs[len(xs) // 3], xs[2 * len(xs) // 3]
    x = np.arange(SIZE)[:, None, None]
    head = organ & (x < t1)
    body = organ & (x >= t1) & (x < t2)
    tail = organ & (x >= t2)

    lesion = np.zeros_like(organ)
    rows = []
    if rng.random() < with_tumor_prob:
        n_tumors = int(rng.integers(1, 3))
        # per-case appearance shift: mask cases can't cover the range
        contrast = float(rng.uniform(*contrast_range))
        for _ in range(n_tumors):
            r = float(rng.uniform(*radius_range))
            # place inside the organ
            for _ in range(50):
                c = center + rng.uniform(-0.55, 0.55, 3) * radii
                if organ[tuple(np.round(c).astype(int))]:
                    break
            ball = _ellipsoid((SIZE,) * 3, c, (r, r, r)) & organ
            if not ball.any():
                continue
            lesion |= ball
            img[ball] += contrast
            at = tuple(np.round(c).astype(int))
            third = "head" if head[at] else "tail" if tail[at] else "body"
            rows.append({
                "Standardized Organ": "pancreas",
                "Standardized Location": third,
                "Tumor Size (mm)": f"{2 * r:.1f}",
                "Unknow Tumor Size": "no",
                "no lesion": 0,
            })
    if not rows:
        rows.append({
            "Standardized Organ": "", "Standardized Location": "",
            "Tumor Size (mm)": "", "Unknow Tumor Size": "no", "no lesion": 1,
        })
    return img, (head, body, tail), lesion, rows


def _save_npz(path, image, channels):
    labels = np.stack([c.astype(bool) for c in channels])
    np.savez_compressed(path, image=image.astype(np.float32),
                        labels=np.packbits(labels, axis=0),
                        num_classes=len(channels))


def generate(root: str, n_mask: int, n_report: int, n_test: int, seed: int = 0,
             contrast_range=(0.5, 1.6), radius_range=(3.0, 6.5),
             mask_contrast_range=None):
    """Writes ``masks_npz/``, ``reports_npz/``, ``test_npz/`` (each with its
    ``classes.json``), ``per_tumor.csv`` and ``test_gt.csv`` under `root`.
    `mask_contrast_range`: contrast slice of the CT-Mask cases (default the
    upper 40 % of `contrast_range`): few mask cases that cannot cover the
    appearance distribution, so the held-out low-contrast tumours are
    learnable only through the report cases."""
    from .data.table import Table

    mask_dir = os.path.join(root, "masks_npz")
    rep_dir = os.path.join(root, "reports_npz")
    test_dir = os.path.join(root, "test_npz")
    for d, classes in ((mask_dir, MASK_CLASSES), (rep_dir, REPORT_CLASSES),
                       (test_dir, MASK_CLASSES)):
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "classes.json"), "w") as f:
            json.dump(classes, f)

    all_rows = []
    k = 0
    if mask_contrast_range is None:
        lo, hi = contrast_range
        mask_contrast_range = (lo + 0.6 * (hi - lo), hi)
    for i in range(n_mask):
        img, (h, b, t), lesion, _ = make_phantom(
            seed + k, contrast_range=mask_contrast_range,
            radius_range=radius_range)
        k += 1
        organ = h | b | t
        _save_npz(os.path.join(mask_dir, f"BDMAP_M{i:03d}.npz"), img,
                  [~(organ | lesion), organ & ~lesion, lesion])
    for i in range(n_report):
        cid = f"BDMAP_R{i:03d}"
        img, (h, b, t), lesion, rows = make_phantom(
            seed + k, contrast_range=contrast_range, radius_range=radius_range)
        k += 1
        organ = h | b | t
        _save_npz(os.path.join(rep_dir, f"{cid}.npz"), img,
                  [~organ, b, h, t])
        all_rows += [{"BDMAP_ID": cid, **r} for r in rows]
    gt = []
    for i in range(n_test):
        cid = f"BDMAP_T{i:03d}"
        img, (h, b, t), lesion, rows = make_phantom(
            seed + 10_000 + k, contrast_range=contrast_range,
            radius_range=radius_range)
        k += 1
        organ = h | b | t
        _save_npz(os.path.join(test_dir, f"{cid}.npz"), img,
                  [~(organ | lesion), organ & ~lesion, lesion])
        gt.append({"BDMAP_ID": cid, "has_tumor": int(lesion.any()),
                   "tumor_voxels": int(lesion.sum())})
    Table.from_rows(all_rows).to_csv(os.path.join(root, "per_tumor.csv"))
    Table.from_rows(gt).to_csv(os.path.join(root, "test_gt.csv"))
    return mask_dir, rep_dir, test_dir


# ----------------------------------------------------------------- training
def _discover(d: str):
    return sorted((os.path.splitext(f)[0], os.path.join(d, f))
                  for f in os.listdir(d) if f.endswith(".npz"))


def variant_config(root: str, with_reports: bool, steps: int, seed: int = 0,
                   batch: int = 4, crop: int = 32, report_weight: float = 0.1):
    """The TrainConfig of one arm: the ``abdomenatlas/resunet_3d`` preset
    with the JAX tool's overrides."""
    from .config import load_config

    name = "report" if with_reports else "mask_only"
    return load_config("abdomenatlas/resunet_3d", None, dict(
        classes=tuple(MASK_CLASSES), report_classes=tuple(REPORT_CLASSES),
        tumor_classes=("pancreas",),
        training_size=(crop,) * 3,
        model_args=dict(base_chan=8, block="BasicBlock", norm="in"),
        compute_dtype="float32",
        batch_size=batch, iter_per_epoch=max(1, steps), epochs=1,
        base_lr=2e-3, warmup_epochs=0,
        loss="ball_dice_last",
        # the reference demo trains with report-loss weight 0.1: full
        # weight lets the weak pseudo-masks corrupt the mask supervision
        report_volume_loss_basic=report_weight if with_reports else 0.0,
        # one loader worker: batches in a fixed order, so the two arms of
        # a seed differ by their supervision, not by the loader's timing
        num_workers=1, val_freq=0, save_every=10_000,
        unique_name=f"phantom_{name}", cp_path=os.path.join(root, "exp"),
        seed=seed,
    ))


def train_variant(root: str, with_reports: bool, steps: int, seed: int = 0,
                  batch: int = 4, crop: int = 32, report_weight: float = 0.1,
                  device="cuda"):
    """Train a small ResUNet (float32) on `device`; returns (model, params)
    for inference: the EMA copy when the config keeps one, as the JAX tool
    does, else the parameters (a name → tensor dict)."""
    import torch

    from .data.dataset import RSuperDataConfig, RSuperDataset, build_case_list
    from .data.reports import clean_reports, load_reports
    from .models import get_model, init_params
    from .train.loop import train

    mask_cases = _discover(os.path.join(root, "masks_npz"))
    report_cases, report_rows = [], None
    if with_reports:
        rows = load_reports(os.path.join(root, "per_tumor.csv"))
        rows, usable, _ = clean_reports(rows, ["pancreas"])
        usable = set(usable)
        report_cases = [(c, p) for c, p in
                        _discover(os.path.join(root, "reports_npz"))
                        if c in usable]
        report_rows = rows

    cases = build_case_list(mask_cases, report_cases, balance=True, seed=seed)
    cfg = variant_config(root, with_reports, steps, seed=seed, batch=batch,
                         crop=crop, report_weight=report_weight)
    dcfg = RSuperDataConfig(
        classes=tuple(MASK_CLASSES), report_classes=tuple(REPORT_CLASSES),
        crop_size=(crop,) * 3, tumor_classes=("pancreas",),
    )
    dataset = RSuperDataset(cases, dcfg, report_rows=report_rows)
    model = init_params(get_model(cfg.arch, len(MASK_CLASSES), cfg.model_args,
                                  dtype=torch.float32), seed)
    state = train(cfg, model, dataset, test_cases=None, max_steps=steps,
                  device=device)
    if cfg.ema:
        params = {k: v.detach().clone() for k, v in state.ema_params.items()}
    else:
        params = {k: p.detach().clone()
                  for k, p in state.model.named_parameters()}
    return state.model, params


# ---------------------------------------------------------------- evaluation
def evaluate(model, params, root: str, crop: int = 32, device="cuda"):
    """Dice and NSD on tumour cases + the detection sweep of the real eval
    pipeline: per case, the DENOISED predicted volume (erode+dilate,
    ``eval/detection.py``) is swept over volume thresholds and the best-F1
    operating point reported."""
    import torch

    from .data.preprocess import load_case
    from .data.table import Table
    from .eval.detection import detect_volume_from_mask
    from .eval.sens_spec import sensitivity_specificity_f1
    from .inference import sliding_window_inference
    from .metrics import dice_score, normalized_surface_dice
    from .utils.device import resolve_device

    device = resolve_device(device)
    test_dir = os.path.join(root, "test_npz")
    gt = Table.read_csv(os.path.join(root, "test_gt.csv"))
    has_tumor = dict(zip(gt["BDMAP_ID"], gt["has_tumor"]))
    li = MASK_CLASSES.index("pancreatic_lesion")
    model = model.to(device).eval()
    params = {k: v.to(device) for k, v in params.items()}

    def model_fn(x):
        out = torch.func.functional_call(model, params, (x,))["segmentation"]
        return out[0] if isinstance(out, (list, tuple)) else out

    dices, nsds, vols, labels_gt = [], [], [], []
    with torch.inference_mode():
        for f in sorted(os.listdir(test_dir)):
            if not f.endswith(".npz"):
                continue
            cid = os.path.splitext(f)[0]
            image, labels = load_case(os.path.join(test_dir, f))
            probs = sliding_window_inference(
                model_fn, image, len(MASK_CLASSES), window=(crop,) * 3,
                batch=4, device=device)
            pred = np.asarray(probs[..., li]) > 0.5
            has_gt = bool(has_tumor[cid])
            vols.append(float(detect_volume_from_mask(pred)))
            labels_gt.append(1.0 if has_gt else 0.0)
            if has_gt:
                dices.append(dice_score(pred, labels[li] > 0))
                nsds.append(normalized_surface_dice(pred, labels[li] > 0,
                                                    tolerance=1.5))

    vols = np.asarray(vols)
    labels_gt = np.asarray(labels_gt)
    best = {"f1": -1.0}
    for th in THRESHOLDS:
        m = sensitivity_specificity_f1(labels_gt, vols, float(th))
        if m["f1"] > best["f1"]:
            best = {**m, "volume_threshold": th}
    return {
        "lesion_dice": float(np.mean(dices)) if dices else 0.0,
        "lesion_nsd": float(np.mean(nsds)) if nsds else 0.0,
        "sensitivity": best["sens"], "specificity": best["spec"],
        "f1": best["f1"], "volume_threshold": best["volume_threshold"],
        "cases": len(vols),
    }


def _step_ms(root: str, name: str):
    """The loop's median ms of a step and of an iteration (the step with
    its wait for the loader) of arm `name`'s last run, from its
    ``metrics.jsonl``."""
    path = os.path.join(root, "exp", f"phantom_{name}", "metrics.jsonl")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                for key in ("step", "iteration"):
                    if f"phase/{key}_median_ms" in rec:
                        out[f"{key}_median_ms"] = rec[f"phase/{key}_median_ms"]
    return out


def run_one_seed(out: str, args, seed: int):
    """Generate + train both arms + evaluate for one seed; returns
    {'mask_only': metrics, 'report': metrics, 'timing': seconds}."""
    os.makedirs(out, exist_ok=True)
    print(f"[phantom] seed {seed}: generating dataset ...", flush=True)
    t0 = time.perf_counter()
    generate(out, args.n_mask, args.n_report, args.n_test, seed=seed,
             contrast_range=tuple(args.contrast),
             radius_range=tuple(args.radius),
             mask_contrast_range=(tuple(args.mask_contrast)
                                  if args.mask_contrast else None))
    results, timing = {}, {"generate_s": time.perf_counter() - t0}
    for with_reports in (False, True):
        name = "report" if with_reports else "mask_only"
        print(f"[phantom] seed {seed}: training {name} "
              f"({args.steps} steps) ...", flush=True)
        t0 = time.perf_counter()
        model, params = train_variant(out, with_reports, args.steps,
                                      seed=seed, crop=args.crop,
                                      report_weight=args.report_weight,
                                      device=args.device)
        t1 = time.perf_counter()
        results[name] = evaluate(model, params, out, crop=args.crop,
                                 device=args.device)
        timing[name] = dict(train_s=t1 - t0, eval_s=time.perf_counter() - t1,
                            steps=args.steps, **_step_ms(out, name))
        print(f"seed {seed} {name}", results[name], flush=True)
    results["timing"] = timing
    return results


def aggregate(rows):
    """Mean and std of each arm's metrics over `rows` (one a seed) and the
    paired per-seed gains of the report arm."""
    def agg(arm, key):
        vals = np.array([r[arm][key] for r in rows], np.float64)
        return {"mean": float(vals.mean()), "std": float(vals.std()),
                "values": [float(v) for v in vals]}

    gains = {k: np.array([r["report"][k] - r["mask_only"][k] for r in rows])
             for k in KEYS}
    return {
        "mask_only": {k: agg("mask_only", k) for k in KEYS},
        "report": {k: agg("report", k) for k in KEYS},
        # paired per-seed gains: both arms share each seed's data, so the
        # data-draw variance cancels and the supervision effect remains;
        # sem = std/sqrt(n) for the 1σ interval
        "paired_gain": {
            k: {"mean": float(g.mean()), "std": float(g.std()),
                "sem": float(g.std() / max(1, math.sqrt(len(g)))),
                "values": [float(v) for v in g]}
            for k, g in gains.items()
        },
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="phantom_benchmark")
    p.add_argument("--n_mask", type=int, default=4)
    p.add_argument("--n_report", type=int, default=20)
    p.add_argument("--n_test", type=int, default=12)
    p.add_argument("--steps", type=int, default=240)
    p.add_argument("--crop", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", type=int, default=1,
                   help="number of seeds: >1 runs the paired multi-seed "
                        "study (each seed regenerates data AND reshuffles "
                        "training) and reports mean±std + paired gains")
    p.add_argument("--report_weight", type=float, default=0.1,
                   help="report-loss weight (reference demo: 0.1)")
    p.add_argument("--contrast", type=float, nargs=2, default=(0.5, 1.6),
                   help="per-case tumor contrast range (lower = harder)")
    p.add_argument("--mask_contrast", type=float, nargs=2, default=None,
                   help="contrast slice the scarce CT-Mask cases are drawn "
                        "from (default: upper 40%% of --contrast); narrow+"
                        "high = the mask set cannot cover the appearance "
                        "distribution, the R-Super data regime")
    p.add_argument("--radius", type=float, nargs=2, default=(3.0, 6.5),
                   help="tumor radius range in mm")
    p.add_argument("--exclude_degenerate", type=float, default=None,
                   metavar="THRESH",
                   help="PRE-REGISTERED exclusion for the multi-seed study: "
                        "drop seeds where BOTH arms score lesion Dice below "
                        "THRESH (the seed's scarce mask draw failed to train "
                        "any usable segmenter: it measures the data draw, "
                        "not the supervision effect). Raw aggregates over "
                        "all seeds are always reported alongside.")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    from .utils.device import card_line, resolve_device

    device = resolve_device(args.device)
    start = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    per_seed = []
    for s in range(args.seed, args.seed + args.seeds):
        out = (args.out if args.seeds == 1
               else os.path.join(args.out, f"seed{s}"))
        # incremental persistence + resume: a killed multi-seed run keeps
        # every completed seed; rerun with the same --out to pick up where
        # it stopped, or aggregate the result.json files by hand
        done_path = os.path.join(out, "result.json")
        if args.seeds > 1 and os.path.exists(done_path):
            with open(done_path) as f:
                per_seed.append(json.load(f))
            print(f"[phantom] seed {s}: cached result.json", flush=True)
            continue
        rec = run_one_seed(out, args, s)
        per_seed.append(rec)
        if args.seeds > 1:
            os.makedirs(out, exist_ok=True)
            tmp = done_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f, indent=2)
            os.replace(tmp, done_path)

    summary = {
        "metric": "phantom_report_vs_mask_only",
        "seeds": args.seeds,
        **aggregate(per_seed),
    }
    if args.exclude_degenerate is not None:
        thr = args.exclude_degenerate
        kept = [r for r in per_seed
                if max(r["mask_only"]["lesion_dice"],
                       r["report"]["lesion_dice"]) >= thr]
        summary["excluded_degenerate"] = {
            "threshold": thr,
            "n_excluded": len(per_seed) - len(kept),
            "n_kept": len(kept),
        }
        if kept and len(kept) < len(per_seed):
            summary["filtered"] = aggregate(kept)
    if args.seeds == 1:
        summary["mask_only"] = per_seed[0]["mask_only"]
        summary["report"] = per_seed[0]["report"]
        summary["f1_gain"] = float(per_seed[0]["report"]["f1"]
                                   - per_seed[0]["mask_only"]["f1"])
        summary["dice_gain"] = float(per_seed[0]["report"]["lesion_dice"]
                                     - per_seed[0]["mask_only"]["lesion_dice"])
    print(json.dumps(summary))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    timing = {
        "wall_s": time.perf_counter() - start,
        "device": card_line() if device.type == "cuda" else "cpu",
        "seeds": {str(args.seed + i): r.get("timing")
                  for i, r in enumerate(per_seed)},
    }
    with open(os.path.join(args.out, "timing.json"), "w") as f:
        json.dump(timing, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
