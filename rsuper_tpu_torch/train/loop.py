"""The training loop on one device: epochs × steps with device or host
augmentation, the loss-NaN guard, EMA, checkpoints, resume, warm starts and
periodic validation (the port's counterpart of ``rsuper_tpu/train/loop.py``
without the mesh).

Each step: ``ChunkedSampler`` indices (``OrganBatchSampler`` batches for
CLIP pretraining) → ``PrefetchLoader`` (packed records,
or records augmented in its workers with ``host_augment``) → the transfer to
the device (``pipeline.to_device``) → ``device_augment`` (or the cast of the
host-augmented batch) → ``build_train_step`` → meters and logging. On the
2D pathway (``cfg.is_2d``) the dataset is a ``SliceDataset`` whose records
come augmented: the loader moves their channels last, and the float32
batch goes to the step without device augmentation; validation runs
``validate_cases_2d``. With
``device_prefetch`` > 0 a ``DevicePrefetcher`` runs the transfer and the
augmentation of the next batches on a side stream while the step runs. A
resumed run goes on from the step it saved, also in the middle of an epoch
(where the JAX loop starts the epoch again). The model's parameters are
initialised by the caller; ``pretrained`` then loads a donor's before
``resume``. At the end of every ``val_freq``-th epoch the run validates on
its test cases and keeps the best checkpoint by mean Dice. The options of
the JAX loop that the port does not have yet raise ``NotImplementedError``
naming their item of ``ROADMAP.md`` §1 before anything runs.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..data.dataset import to_channels_last
from ..data.host_augment import make_host_augment, to_step_dtype
from ..data.pipeline import (AugmentDraws, DevicePrefetcher, PrefetchLoader,
                             device_augment, draw_augment, to_device)
from ..data.sampler import ChunkedSampler, OrganBatchSampler
from ..losses import LesionChannelMap
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger, dump_config, setup_logger
from ..utils.meters import AverageMeter
from ..utils.profiling import PhaseTimer, TraceCapture
from .checkpoint import (CheckpointManager, load_pretrained_params,
                         parse_class_list)
from .optim import make_optimizer
from .state import TrainState, create_train_state
from .step import build_train_step
from .validation import run_validation, validation_model

# the items of ROADMAP.md §1 that hold what the port does not have yet
ROADMAP = {
    "multi_gpu": "ROADMAP.md §1 item 8 (multi-GPU)",
}

Draws = Callable[[int, int, int], AugmentDraws]


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {ROADMAP[item]}")


def check_config(cfg: TrainConfig) -> None:
    """Raise for each option of the JAX loop the port does not have."""
    for name, item in (("zero_opt", "multi_gpu"), ("zero_ema", "multi_gpu")):
        if getattr(cfg, name):
            raise unported(name, item)
    if cfg.spatial_shard > 1:
        raise unported(f"spatial_shard={cfg.spatial_shard}", "multi_gpu")


def _epoch_indices(cfg: TrainConfig, dataset,
                   start_epoch: int) -> Callable[[int], np.ndarray]:
    """`epoch → dataset indices` of the run. CLIP pretraining draws
    organ-homogeneous batches from the dataset's ``crop_organs``
    (``OrganBatchSampler``: a batch depends on the seed and the global step
    alone); otherwise the ``ChunkedSampler``'s cycles, the epochs before
    `start_epoch` replayed so a resumed run sees the same indices."""
    if cfg.clip_pretrain:
        # a loader batch must be exactly one global organ batch: with more
        # data shards on this one process it would span several steps' batches
        # and mix organs (the JAX loop's condition)
        if cfg.data_shards != 1:
            raise ValueError("clip_pretrain requires data_shards == process "
                             f"count (got {cfg.data_shards} shards over 1 "
                             "process)")
        organ = OrganBatchSampler(dataset.crop_organs(), cfg.batch_size,
                                  seed=cfg.seed, shard=cfg.shard_index)
        return lambda e: organ.epoch_indices(e, cfg.iter_per_epoch)
    sampler = ChunkedSampler(
        len(dataset), cfg.iter_per_epoch * cfg.batch_size,
        shard=cfg.shard_index, num_shards=cfg.data_shards, seed=cfg.seed,
    )
    for e in range(start_epoch):
        sampler.epoch_indices(e)
    return sampler.epoch_indices


def seeded_draws(cfg: TrainConfig, device: torch.device) -> Draws:
    """The default augmentation draws: batch i of epoch e draws from a CPU
    generator and a device generator seeded from (seed + 1, e, i), so a
    resumed run draws what an uninterrupted one draws, also when it resumes
    in the middle of an epoch."""

    def draws(epoch: int, index: int, batch_size: int) -> AugmentDraws:
        s = int(np.random.SeedSequence([cfg.seed + 1, epoch, index])
                .generate_state(1)[0])
        gen_host = torch.Generator().manual_seed(s)
        gen_dev = torch.Generator(device=device).manual_seed(s)
        return draw_augment(gen_host, gen_dev, batch_size,
                            tuple(cfg.training_size), tuple(cfg.scale),
                            tuple(cfg.rotate), tuple(cfg.translate))

    return draws


def train(
    cfg: TrainConfig,
    model: torch.nn.Module,
    dataset,
    test_cases: Optional[Iterable] = None,
    max_steps: Optional[int] = None,
    profile_steps: int = 0,
    device="cuda",
    draws: Optional[Draws] = None,
) -> TrainState:
    """Run the training job on `device` (CUDA unless the CPU is asked for);
    returns the final TrainState. `model` holds its initial parameters.
    `test_cases` (re-iterable (image, labels) pairs) are validated at the
    end of every ``val_freq``-th epoch. `draws(epoch, index, batch_size)`
    gives each batch's device-augmentation draws (default:
    `seeded_draws`)."""
    check_config(cfg)
    device = resolve_device(device)
    if len(dataset) == 0:
        raise ValueError("no training cases: check --data_root, "
                         "--report_root and --reports")
    exp_dir = f"{cfg.cp_path}/{cfg.unique_name}"
    logger = setup_logger(exp_dir)
    metrics_log = MetricsLogger(exp_dir)
    dump_config(exp_dir, cfg)

    lmap = LesionChannelMap.from_classes(cfg.classes)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = model.to(device).train()
    opt = make_optimizer(
        model.parameters(), cfg.optimizer, cfg.base_lr, cfg.warmup_epochs,
        cfg.epochs, cfg.iter_per_epoch, cfg.weight_decay, cfg.betas,
        clip_norm=cfg.clip_norm)
    state = create_train_state(model, opt, ema=cfg.ema)

    ckpt = CheckpointManager(exp_dir, save_every=cfg.save_every)
    if cfg.pretrained:
        old = parse_class_list(cfg.old_classes) if cfg.old_classes else None
        state = load_pretrained_params(state, cfg.pretrained,
                                       old_classes=old,
                                       new_classes=list(cfg.classes))
        logger.info("loaded pretrained weights from %s (%s)", cfg.pretrained,
                    "class surgery" if old else "non-strict")
    if cfg.resume and ckpt.has("latest"):
        state = ckpt.restore(state, "latest")
        logger.info("resumed from step %d", state.step)
    start_epoch, done = divmod(state.step, cfg.iter_per_epoch)

    step_fn = build_train_step(lmap, cfg.loss_config(),
                               ema_alpha=cfg.ema_alpha,
                               model_genesis=cfg.model_genesis_pretrain,
                               clip_only=cfg.clip_pretrain)
    epoch_indices = _epoch_indices(cfg, dataset, start_epoch)
    draws = draws or seeded_draws(cfg, device)
    # host augmentation: the loader's workers augment (reference-style), and
    # the device only casts; else the loader packs and the device augments.
    # 2D slices are augmented by the dataset (data/dataset2d.py): the
    # loader only moves their channels last, and the batch goes to the step
    # as it is, as the JAX loop feeds it
    host_transform = None
    if cfg.is_2d:
        host_transform = lambda rec, rng: to_channels_last(rec)  # noqa: E731
    elif cfg.host_augment:
        host_transform = make_host_augment(
            tuple(cfg.training_size), scale=tuple(cfg.scale),
            rotate=tuple(cfg.rotate), translate=tuple(cfg.translate))

    tracer = None
    if profile_steps:
        start = 10 if max_steps is None else max(0, min(
            10, max_steps - profile_steps))
        tracer = TraceCapture(f"{exp_dir}/trace", start_step=start,
                              num_steps=profile_steps)
    timer = PhaseTimer()
    val_model = None

    def log_phases(loader):
        for s in loader.item_seconds:
            timer.add("loader_item", s)
        loader.item_seconds.clear()
        summary = timer.summary()
        metrics_log.log(state.step, summary, prefix="phase/")
        return summary

    def prepare(epoch, index, host):
        """A host batch on the device, augmented, in the step's type."""
        with timer.phase("h2d"):
            batch = to_device(host, device)
        if cfg.is_2d:
            return batch
        if host_transform is not None:
            return to_step_dtype(batch, dtype)
        with timer.phase("augment"):
            return device_augment(
                batch, draws(epoch, index, cfg.batch_size),
                crop_size=tuple(cfg.training_size), out_dtype=dtype,
                num_classes=len(cfg.classes))

    def loaded(batches, first, wait):
        """(index, host batch) of the epoch from `first` on, the wait for
        the loader timed as phase `wait`."""
        for index in range(first, cfg.iter_per_epoch):
            with timer.phase(wait):
                host = next(batches, None)
            if host is None:
                return
            yield index, host

    total_steps = 0
    check_every = max(1, cfg.nan_check_every)
    batches = source = None
    try:
        for epoch in range(start_epoch, cfg.epochs):
            loader = PrefetchLoader(
                dataset, cfg.batch_size, epoch_indices(epoch),
                num_workers=cfg.num_workers, transform=host_transform,
            )
            batches = iter(loader)
            # a run resumed in the middle of an epoch loads the batches it
            # already trained and drops them, so the loader's draws and the
            # epoch's length stay those of an uninterrupted run
            first = done if epoch == start_epoch else 0
            for _ in range(first):
                next(batches, None)
            # `load` is the loop's wait for the stage before it: the loader
            # inline (h2d and augment then follow on the loop's thread), the
            # prefetcher with `device_prefetch`, whose feeder thread waits
            # for the loader as `feeder_load`
            prefetching = cfg.device_prefetch > 0
            if prefetching:
                source = iter(DevicePrefetcher(
                    loaded(batches, first, "feeder_load"),
                    lambda i, h, e=epoch: prepare(e, i, h), device,
                    depth=cfg.device_prefetch))
            else:
                source = (prepare(epoch, i, h)
                          for i, h in loaded(batches, first, "load"))
            loss_meter = AverageMeter("loss")
            t_meter = AverageMeter("s/it")
            t0 = time.time()
            losses = None
            for _ in range(first, cfg.iter_per_epoch):
                if tracer is not None:  # the window holds whole iterations
                    tracer.step(total_steps)
                if prefetching:
                    with timer.phase("load"):
                        batch = next(source, None)
                else:
                    batch = next(source, None)
                if batch is None:
                    break
                with timer.phase("step"):
                    state, losses = step_fn(state, batch)
                total_steps += 1
                # read the loss only every `check_every` steps: a read waits
                # for the device
                if (total_steps % check_every == 0 or total_steps == 1
                        or total_steps % 50 == 0 or total_steps == max_steps):
                    with timer.phase("host_read"):
                        loss = float(losses["overall"])
                    if not np.isfinite(loss):
                        raise FloatingPointError(
                            f"loss is NaN/Inf at step {state.step}: aborting "
                            "before it poisons further weights (detection "
                            f"lags up to {check_every - 1} steps by design)")
                    loss_meter.update(loss)
                dt = time.time() - t0
                t_meter.update(dt)
                timer.add("iteration", dt)
                t0 = time.time()
                if total_steps % 50 == 0 or total_steps == 1:
                    logger.info("epoch %d step %d %s %s", epoch, state.step,
                                loss_meter, t_meter)
                    with timer.phase("host_read"):
                        vals = torch.stack([v.float() for v in
                                            losses.values()]).cpu().tolist()
                    metrics_log.log(state.step, dict(zip(losses, vals)),
                                    prefix="train/")
                if max_steps is not None and total_steps >= max_steps:
                    ckpt.save_epoch(state, epoch)
                    ckpt.wait()
                    logger.info("stopped at step %d: phases=%s", state.step,
                                log_phases(loader))
                    return state

            source.close()
            batches.close()
            if loss_meter.count == 0 and losses is not None:
                loss_meter.update(float(losses["overall"]))

            val_metric = None
            if (test_cases is not None and cfg.val_freq
                    and (epoch + 1) % cfg.val_freq == 0):
                if val_model is None:  # one instance for every validation
                    val_model = validation_model(state.model)
                results = run_validation(val_model, state, cfg, test_cases,
                                         len(cfg.classes), device=device,
                                         timer=timer)
                val_metric = float(np.mean(results["dice"]))
                logger.info("epoch %d val dice %.4f", epoch, val_metric)
                metrics_log.log(state.step, {"dice_mean": val_metric},
                                prefix="val/")

            ckpt.save_epoch(state, epoch, metric=val_metric)
            logger.info("epoch %d done: %s phases=%s", epoch, loss_meter,
                        log_phases(loader))
        ckpt.wait()
        return state
    finally:
        if source is not None:  # stops a prefetcher's feeder first
            source.close()
        if batches is not None:
            batches.close()
        if tracer is not None:
            tracer.close()
