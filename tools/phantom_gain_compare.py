#!/usr/bin/env python
"""Pool phantom-study seeds from several runs and set the paired report
gain beside another study's with Welch's t.

    python tools/phantom_gain_compare.py DIR [DIR ...] \\
        [--exclude_degenerate 0.05] [--against MEAN STD N] [--metric KEY]

Each DIR holds ``seed<k>/result.json`` files as ``--seeds N`` runs of
``tools/phantom_benchmark.py`` or ``python -m
rsuper_tpu_torch.phantom_benchmark`` write them (a seed in two DIRs counts
once, the first). The seeds are aggregated as ``tools/summarize_phantom.py``
does (means, population std, the paired per-seed gains, the pre-registered
exclusion of seeds where both arms score lesion Dice below the threshold),
all seeds and the kept ones. ``--against MEAN STD N`` is the other study's
paired gain of ``--metric`` (default sensitivity) as those tools print it
(population std of N seeds); Welch's t of the difference of the two mean
gains uses sample variances (ddof 1) and the Welch–Satterthwaite degrees of
freedom, with the two-sided p. Prints one JSON line.
"""

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from summarize_phantom import KEYS, aggregate, load_seeds  # noqa: E402


def welch(a, b_mean, b_std_pop, b_n):
    """Welch's t of mean(a) − b_mean, b given as mean, population std and
    count: (t, degrees of freedom, two-sided p)."""
    from scipy import stats

    a = np.asarray(a, np.float64)
    va = a.var(ddof=1) / len(a)
    vb = b_std_pop ** 2 * b_n / (b_n - 1) / b_n
    t = (a.mean() - b_mean) / math.sqrt(va + vb)
    df = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (b_n - 1))
    return float(t), float(df), float(2 * stats.t.sf(abs(t), df))


def summary(rows, metric, against):
    out = aggregate(rows)
    out["seeds"] = [r["_seed"] for r in rows]
    gains = [r["report"][metric] - r["mask_only"][metric] for r in rows]
    out["paired_gain"][metric]["equal_seeds"] = int(
        sum(g == 0 for g in gains))
    out["paired_gain"][metric]["negative_seeds"] = int(
        sum(g < 0 for g in gains))
    if against:
        t, df, p = welch(gains, *against)
        out["welch"] = dict(metric=metric, t=t, df=df, p_two_sided=p,
                            against=dict(zip(("mean", "std", "n"), against)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--exclude_degenerate", type=float, default=0.05)
    ap.add_argument("--against", type=float, nargs=3, default=None,
                    metavar=("MEAN", "STD", "N"))
    ap.add_argument("--metric", default="sensitivity", choices=KEYS)
    args = ap.parse_args(argv)

    rows, seen = [], set()
    for d in args.dirs:
        for r in load_seeds(d):
            if r["_seed"] not in seen:
                seen.add(r["_seed"])
                rows.append(r)
    if not rows:
        print(f"no seed*/result.json under {args.dirs}", file=sys.stderr)
        return 1
    rows.sort(key=lambda r: r["_seed"])
    against = None
    if args.against:
        mean, std, n = args.against
        against = (mean, std, int(n))
    kept = [r for r in rows
            if not (r["mask_only"]["lesion_dice"] < args.exclude_degenerate
                    and r["report"]["lesion_dice"] < args.exclude_degenerate)]
    print(json.dumps({
        "all": summary(rows, args.metric, against),
        "kept": summary(kept, args.metric, against),
        "excluded_seeds": sorted(set(r["_seed"] for r in rows)
                                 - set(r["_seed"] for r in kept)),
        "exclude_degenerate": args.exclude_degenerate,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
