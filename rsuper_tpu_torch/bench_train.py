#!/usr/bin/env python
"""Benchmark of the port's training step on one GPU — counterpart of the JAX
package's ``bench.py``.

    python -m rsuper_tpu_torch.bench_train [--size 96] [--batch 1]
        [--steps 10] [--remat] [--loss dice] [--device cpu]

Default MedFormer (16 classes, bf16 compute, float32 parameters, seeded
random weights) on ``bench.py``'s synthetic batch: forward, the full R-Super
losses (``LossConfig()``, ``loss="ball_dice_last"``: masked BCE +
adaptive-Tversky Dice on both heads, the Ball Loss on the final head, the
Volume Loss on the auxiliary head), backward, clipping, AdamW and EMA 0.99.
``--loss dice`` runs the Volume Loss on both heads and no Ball Loss, as
``bench.py`` does with ``RSUPER_BENCH_LOSS=dice``. One warm-up step, then
`steps` timed steps; prints one JSON line with ``bench.py``'s shape
(``metric`` ``train_patches_per_sec_per_gpu_96``, with ``_dice`` appended
for ``--loss dice``; ``value``; ``unit``) plus the card's name and power
limit. Runs on CUDA unless ``--device cpu`` is given; a CPU run names its
metric ``..._per_cpu_...``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

CLASSES = [  # the 16 classes of bench.py
    "background", "aorta", "gall_bladder", "kidney_left", "kidney_right",
    "kidney_lesion", "liver", "liver_lesion", "pancreas", "pancreas_head",
    "pancreas_body", "pancreas_tail", "pancreatic_lesion", "postcava",
    "spleen", "stomach",
]


def synthetic_batch(size: int = 96, batch: int = 1, seed: int = 0,
                    device="cpu"):
    """``bench.py``'s batch: a noise image, one 48³-in-96³ organ sub-segment
    marked unknown with two reported tumours, and (from the second item on) a
    voxel-labelled pancreas. Image and masks in bf16 (the masks are exact),
    volumes and diameters in float32."""
    C = len(CLASSES)
    rng = np.random.default_rng(seed)
    lo, hi = size // 4, size - size // 4
    seg = np.zeros((batch, size, size, size, C), np.float32)
    seg[0, lo:hi, lo:hi, lo:hi, CLASSES.index("pancreatic_lesion")] = 1.0
    lab = np.zeros_like(seg)
    if batch > 1:
        a, b = size * 20 // 96, size * 60 // 96
        lab[1, a:b, a:b, a:b, CLASSES.index("pancreas")] = 1.0
    vols = np.zeros((batch, 10), np.float32)
    vols[0, :2] = [4000.0, 900.0]
    dias = np.zeros((batch, 10, 3), np.float32)
    dias[0, 0] = [20.0, 18.0, 16.0]
    dias[0, 1] = [12.0, 12.0, 10.0]
    arrays = {
        "image": rng.normal(size=(batch, size, size, size, 1)).astype(np.float32),
        "label": lab,
        "unk": seg.copy(),
        "segment_mask": seg,
        "volumes": vols,
        "diameters": dias,
    }
    bf16 = ("image", "label", "unk", "segment_mask")
    return {k: torch.from_numpy(v).to(device).to(
        torch.bfloat16 if k in bf16 else torch.float32)
        for k, v in arrays.items()}


def build_state(device, remat: bool = False, model_args=None, seed: int = 0,
                dtype=torch.bfloat16):
    """Train state of ``bench.py``: default MedFormer with seeded weights,
    AdamW at 6e-4 without warm-up (100 epochs of 1000 steps), EMA."""
    from .models import get_model, init_params
    from .train import create_train_state, make_optimizer

    args = {"remat": remat, **(model_args or {})}
    model = get_model("medformer", len(CLASSES), args, dtype=dtype)
    model = init_params(model, seed=seed).to(device).train()
    opt = make_optimizer(model.parameters(), base_lr=6e-4, warmup_epochs=0,
                         max_epochs=100, steps_per_epoch=1000)
    return create_train_state(model, opt)


def main(argv=None, model_args=None):
    """`model_args` overrides MedFormer arguments from Python (a small model
    for a run on the CPU); the command line always runs the default model."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--loss", default="ball_dice_last",
                   help="LossConfig.loss: ball_dice_last (default) or dice")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from .losses import LesionChannelMap, LossConfig
    from .train import build_train_step
    from .utils.device import card_line, resolve_device

    device = resolve_device(args.device)
    state = build_state(device, args.remat, model_args)
    batch = synthetic_batch(args.size, args.batch, device=device)
    step = build_train_step(LesionChannelMap.from_classes(CLASSES),
                            LossConfig(loss=args.loss))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    state, losses = step(state, batch)  # warm-up: builds the kernels
    first = float(losses["overall"])
    sync()
    t0 = time.time()
    for _ in range(args.steps):
        state, losses = step(state, batch)
    last = float(losses["overall"])  # a host read: the whole chain is done
    sync()
    elapsed = time.time() - t0
    unit = "gpu" if device.type == "cuda" else "cpu"
    full = args.loss == "ball_dice_last"
    result = {
        "metric": f"train_patches_per_sec_per_{unit}_{args.size}"
                  + ("" if full else f"_{args.loss}"),
        "value": args.batch * args.steps / elapsed,
        "unit": f"{args.size}^3 CT patches/s/{unit.upper()} (MedFormer "
                "fwd+bwd, " + ("full R-Super losses" if full
                               else f"loss={args.loss}") + ", AdamW, EMA)",
        "ms_per_step": elapsed / args.steps * 1e3,
        "steps": args.steps, "batch": args.batch, "remat": args.remat,
        "loss": args.loss,
        "loss_first": first, "loss_last": last,
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
        "card": card_line() if device.type == "cuda" else None,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
