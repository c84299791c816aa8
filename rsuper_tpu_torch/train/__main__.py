#!/usr/bin/env python
"""Training CLI of the port — the counterpart of the JAX package's
``train.py``, on one device:

    python -m rsuper_tpu_torch.train --preset abdomenatlas_ufo/medformer_3d \\
        --data_root /data/masks_npz --report_root /data/reports_npz \\
        --reports /data/per_tumor.csv --unique_name run1 [--device cpu]

It reads preprocessed CT-Mask and CT-Report cases (``*.npz`` written by
``data/preprocess.preprocess_case``, with a sorted ``classes.json`` in each
root) and the per-tumour report CSV, and trains with ``train/loop.train``.
It runs on CUDA unless ``--device cpu`` is given. ``--k_fold K --fold I``
trains fold I of a K-fold split into ``<cp_path>/<name>_fold<I>/``,
validates it on the fold's CT-Mask test cases (``fold_results.json``) and
writes ``<cp_path>/<name>_cross_validation.txt`` once every fold has
results. ``--pretrained`` warm-starts from a port checkpoint directory (its
``best``) or a flax ``.npz``, with class surgery of the heads when
``--old_classes`` names the donor's classes. ``--clip_pretrain
--clip_source DIR`` pretrains the encoder and its CLIP head with symmetric
InfoNCE against precomputed report embeddings (one ``<case_id>.npy`` a case
in DIR; a case without one gets zeros), over batches that share one crop
organ. A 2D configuration (``--preset slices/resunet_2d``, or
``--dimension 2d`` / a 2D ``training_size``) trains a 2D model on axial
slices of the CT-Mask cases (``SliceDataset``) and validates slice by
slice; it refuses CT-Report cases, as the JAX CLI does. The options the
port does not have yet (``--zero_opt``, ``--zero_ema``, ``--spatial_shard``
> 1, the ``--dist_*`` flags) raise ``NotImplementedError`` naming their
item of ``ROADMAP.md`` §1.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # the CLI imports torch only once the flags are parsed
    import torch

    from ..config import TrainConfig
    from ..data.clip import ClipRecordAdapter
    from ..data.dataset import RSuperDataset
    from ..data.dataset2d import SliceDataset

# command-line arguments that are not TrainConfig fields
_NOT_CONFIG = ("preset", "config", "all_train", "max_steps",
               "class_weights_csv", "report_only", "mask_only",
               "profile_steps", "k_fold", "fold", "dist_coordinator",
               "dist_num_processes", "dist_process_id", "local_device_ids",
               "device")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--preset", default="abdomenatlas_ufo/medformer_3d")
    p.add_argument("--config", default=None,
                   help="YAML config overriding the preset (needs PyYAML)")
    p.add_argument("--data_root", default=None, help="mask-dataset npz dir")
    p.add_argument("--report_root", default=None, help="report-dataset npz dir")
    p.add_argument("--reports", default=None, help="per-tumor metadata CSV")
    p.add_argument("--arch", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--iter_per_epoch", type=int, default=None)
    p.add_argument("--lr", dest="base_lr", type=float, default=None)
    p.add_argument("--loss", default=None)
    p.add_argument("--report_volume_loss_basic", type=float, default=None)
    p.add_argument("--unique_name", default=None)
    p.add_argument("--cp_path", default=None)
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--old_classes", default=None)
    p.add_argument("--all_train", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--class_weights", action="store_true",
                   help="inverse-prevalence class weighting")
    p.add_argument("--class_weights_csv", default=None,
                   help="per-CT metadata CSV with lesion-instance counts")
    p.add_argument("--report_only", action="store_true",
                   help="train on CT-Report cases only")
    p.add_argument("--mask_only", action="store_true",
                   help="train on CT-Mask cases only")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="torch.profiler window over N steps (a Chrome trace "
                        "in <cp_path>/<unique_name>/trace/)")
    p.add_argument("--clip_pretrain", action="store_true")
    p.add_argument("--clip_source", default=None)
    p.add_argument("--k_fold", type=int, default=0)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--zero_opt", action="store_true")
    p.add_argument("--zero_ema", action="store_true")
    p.add_argument("--spatial_shard", type=int, default=None)
    p.add_argument("--dimension", default=None, choices=("auto", "2d", "3d"),
                   help="the config's dimension: auto (from training_size),"
                        " 2d or 3d")
    p.add_argument("--dist_coordinator", default=None)
    p.add_argument("--dist_num_processes", type=int, default=None)
    p.add_argument("--dist_process_id", type=int, default=None)
    p.add_argument("--local_device_ids", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """Raise for the flags that are not config fields; ``check_config``
    raises for the fields."""
    from .loop import unported

    for flag in ("dist_coordinator", "dist_num_processes", "dist_process_id",
                 "local_device_ids"):
        if getattr(args, flag) is not None:
            raise unported(f"--{flag}", "multi_gpu")


def discover_cases(root):
    """All preprocessed cases under `root`: (case_id, path) from *.npz."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "*.npz"))):
        out.append((os.path.splitext(os.path.basename(path))[0], path))
    return out


def load_classes(root):
    meta = os.path.join(root, "classes.json")
    if os.path.exists(meta):
        with open(meta) as f:
            return tuple(sorted(json.load(f)))
    raise FileNotFoundError(
        f"{meta} not found: write the sorted class list used at preprocessing"
    )


@dataclasses.dataclass
class Run:
    """What ``main`` trains: the parsed flags, the config, the initialised
    model, the training set, the held-out cases, the device, the class
    list and the experiment's name before a fold's suffix."""

    args: argparse.Namespace
    cfg: TrainConfig
    model: torch.nn.Module
    dataset: RSuperDataset | ClipRecordAdapter | SliceDataset
    test_cases: list
    device: torch.device
    classes: tuple
    base_name: str

    def held_out(self):
        """The held-out CT-Mask cases as (image, labels), re-iterable and
        loaded lazily (CT-Report cases carry no voxel labels); None without
        held-out cases."""
        return _HeldOut(self.test_cases, len(self.classes)) \
            if self.test_cases else None


class _HeldOut:
    """Re-iterable (image, labels) of the CT-Mask cases among `cases`,
    loaded as they are reached: validation may run every ``val_freq``
    epochs."""

    def __init__(self, cases, num_classes: int):
        self.cases, self.num_classes = cases, num_classes

    def __iter__(self):
        from ..data.preprocess import load_case

        for c in self.cases:
            if not c.is_report:
                yield load_case(c.path, num_classes=self.num_classes)


def build_run(argv=None) -> Run:
    """Parse `argv` and build the run: config, cases and their split (a
    fold's with ``--k_fold``), dataset and the seeded model."""
    args = parse_args(argv)
    _refuse_unported(args)
    import torch

    from ..config import load_config
    from ..data.class_weights import class_proportions
    from ..data.clip import ClipRecordAdapter, ReportEmbeddingStore
    from ..data.dataset import (RSuperDataConfig, RSuperDataset,
                                build_case_list, kfold_split,
                                split_train_test)
    from ..data.dataset2d import SliceDataConfig, SliceDataset
    from ..data.reports import clean_reports, load_reports
    from ..data.table import Table
    from ..models import get_model, init_params
    from ..utils.device import resolve_device
    from .crossval import fold_dir_name
    from .loop import check_config

    overrides = {k: v for k, v in vars(args).items()
                 if k not in _NOT_CONFIG and v is not None}
    for flag in ("resume", "class_weights", "clip_pretrain", "zero_opt",
                 "zero_ema"):
        if not getattr(args, flag):
            overrides.pop(flag, None)
    cfg = load_config(args.preset, args.config, overrides)
    check_config(cfg)
    device = resolve_device(args.device)

    classes = cfg.classes or load_classes(cfg.data_root)
    report_classes = cfg.report_classes or (
        load_classes(cfg.report_root) if cfg.report_root else ()
    )
    cfg = dataclasses.replace(cfg, classes=tuple(classes),
                              report_classes=tuple(report_classes))

    mask_cases = discover_cases(cfg.data_root) if cfg.data_root else []
    report_cases = discover_cases(cfg.report_root) if cfg.report_root else []
    report_rows = None
    if cfg.reports:
        rows = load_reports(cfg.reports)
        ids = {c for c, _ in report_cases}
        rows = rows.filter(rows["BDMAP_ID"].isin(ids))
        rows, usable, _ = clean_reports(rows, list(cfg.tumor_classes))
        report_cases = [(c, p) for c, p in report_cases if c in set(usable)]
        report_rows = rows

    if args.report_only and args.mask_only:
        raise SystemExit("--report_only and --mask_only are mutually exclusive")
    if args.report_only:
        mask_cases = []
    if args.mask_only:
        report_cases = []
    cases = build_case_list(mask_cases, report_cases,
                            balance=cfg.balance_supervision, seed=cfg.seed)
    base_name = cfg.unique_name
    if args.all_train:
        train_cases, test_cases = cases, []
    elif args.k_fold:
        train_cases, test_cases = kfold_split(cases, args.k_fold, args.fold,
                                              seed=cfg.seed)
        # fold i trains into <cp_path>/<name>_fold<i>/ (crossval.py contract)
        cfg = dataclasses.replace(
            cfg, unique_name=fold_dir_name(base_name, args.fold))
    else:
        train_cases, test_cases = split_train_test(cases, seed=cfg.seed)

    dcfg = RSuperDataConfig(
        classes=tuple(classes),
        report_classes=tuple(report_classes),
        crop_size=tuple(cfg.training_size),
        tumor_classes=tuple(cfg.tumor_classes),
    )
    proportions = None
    if cfg.class_weights and args.class_weights_csv:
        lesion_names = [c for c in classes if "lesion" in c]
        proportions = class_proportions(
            Table.read_csv(args.class_weights_csv),
            [c.case_id for c in train_cases], lesion_names,
        )
    model_args = dict(cfg.model_args)
    if cfg.is_2d:
        if any(c.is_report for c in train_cases):
            raise SystemExit("the 2D pathway trains on CT-Mask slices only "
                             "(report supervision is volumetric)")
        dataset = SliceDataset(train_cases, SliceDataConfig(
            classes=tuple(classes), crop_size=tuple(cfg.training_size)))
        # the 2D models whose parameter shapes follow the input size are
        # built for the training slices, as the JAX model is initialised
        model_args.setdefault("img_size", tuple(cfg.training_size))
    else:
        dataset = RSuperDataset(train_cases, dcfg, report_rows=report_rows,
                                class_proportions=proportions)

    if cfg.clip_pretrain:
        if not cfg.clip_source:
            raise SystemExit("--clip_pretrain needs --clip_source "
                             "(per-case report-embedding .npy directory)")
        model_args.setdefault("clip_branch", True)
        dataset = ClipRecordAdapter(
            dataset, ReportEmbeddingStore(cfg.clip_source),
            dim=model_args.get("clip_feats", 768))

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = init_params(get_model(cfg.arch, len(classes), model_args,
                                  dtype=dtype), seed=cfg.seed)
    return Run(args=args, cfg=cfg, model=model, dataset=dataset,
               test_cases=test_cases, device=device, classes=tuple(classes),
               base_name=base_name)


def main(argv=None):
    """Train; with ``--k_fold``, validate the fold and summarise the folds.
    Returns the final TrainState."""
    from .crossval import summarize_cross_validation, write_fold_results
    from .loop import train
    from .validation import run_validation, validation_model

    run = build_run(argv)
    cfg, args = run.cfg, run.args
    state = train(cfg, run.model, run.dataset, test_cases=run.held_out(),
                  max_steps=args.max_steps, profile_steps=args.profile_steps,
                  device=run.device)

    if args.k_fold and run.test_cases:
        # the fold's own validation, then the cross-validation summary when
        # the last fold completes (reference train_ddp.py:751-779)
        results = run_validation(validation_model(state.model), state, cfg,
                                 run.held_out(), len(run.classes),
                                 device=run.device)
        write_fold_results(f"{cfg.cp_path}/{cfg.unique_name}", args.fold,
                           args.k_fold, run.classes, results)
        out = summarize_cross_validation(cfg.cp_path, run.base_name,
                                         args.k_fold, run.classes)
        if out:
            print(f"[crossval] wrote {out}", flush=True)
    return state


if __name__ == "__main__":
    main()
