#!/usr/bin/env python
"""Serving benchmark of the port: whole-volume sliding-window prediction —
counterpart of the JAX package's ``bench_infer.py``.

    python -m rsuper_tpu_torch.bench_infer [--batch 8] [--prob_wire u8]
        [--edge 256] [--window 96] [--reps 3] [--model_args_json JSON]
        [--device cpu]

Default MedFormer (``bench_train.CLASSES``' 16 classes, bf16 compute, seeded
random weights) on a seeded normal volume of edge³ voxels, window³ windows
with half overlap in batches of `batch`. After one first call each (the
kernels' build included), `reps` timed calls of three paths: the blended
probabilities brought to the host (``sliding_window_inference``), the masks
path of the predict CLI (``predict_masks_volume``: threshold, organ gating
and bit-packing on the device), and the masks with the lesion channels'
probabilities (``--save_probabilities``, sent as `prob_wire`). Prints the
card's name and power limit, then one JSON line with the JAX script's keys.
Runs on CUDA unless ``--device cpu`` is given; a CPU run names its metric
``..._per_cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prob_wire", default="u8", choices=["u8", "f16"])
    p.add_argument("--edge", type=int, default=256)
    p.add_argument("--window", type=int, default=96)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--model_args_json", default=None,
                   help="JSON file or JSON text of MedFormer arguments")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from .bench_train import CLASSES
    from .inference.predict import predict_masks_volume
    from .inference.sliding_window import sliding_window_inference
    from .models import get_model, init_params
    from .predict import read_model_args
    from .utils.device import card_line, resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    model = get_model("medformer", len(CLASSES),
                      read_model_args(args.model_args_json),
                      dtype=torch.bfloat16)
    model = init_params(model, seed=0).to(device).eval()

    def fn(x):
        out = model(x)["segmentation"]
        return out[0] if isinstance(out, (list, tuple)) else out

    vol = np.random.default_rng(0).normal(
        size=(args.edge,) * 3).astype(np.float32)
    win = (args.window,) * 3
    lesion_idx = [i for i, c in enumerate(CLASSES) if "lesion" in c]
    # each call ends with its result on the host: the device is done
    paths = {
        "probs": lambda: sliding_window_inference(
            fn, vol, len(CLASSES), window=win, batch=args.batch,
            device=device),
        "lesion": lambda: predict_masks_volume(
            [fn], vol, CLASSES, window=win, batch=args.batch,
            prob_channels=lesion_idx, prob_wire=args.prob_wire,
            device=device),
        "masks": lambda: predict_masks_volume(
            [fn], vol, CLASSES, window=win, batch=args.batch,
            device=device),
    }
    first, seconds, outs = {}, {}, {}
    for name, call in paths.items():
        t0 = time.time()
        call()
        first[name] = time.time() - t0
        t0 = time.time()
        for _ in range(args.reps):
            outs[name] = call()
        seconds[name] = (time.time() - t0) / args.reps
    if not (np.isfinite(outs["probs"]).all()
            and outs["lesion"][1].shape == vol.shape + (len(lesion_idx),)
            and outs["masks"]["pancreas"].shape == vol.shape):
        raise RuntimeError("bench_infer: a path returned a wrong result")

    unit = "gpu" if device.type == "cuda" else "cpu"
    result = {
        "metric": f"sliding_window_volumes_per_min_per_{unit}"
                  + (f"_b{args.batch}" if args.batch != 8 else ""),
        "value": 60.0 / seconds["masks"],
        "unit": f"{args.edge}^3 volumes/min ({args.window}^3 windows, 0.5 "
                "overlap, MedFormer, device postprocess + packed-mask "
                "transfer)",
        "seconds_per_volume": seconds["masks"],
        "seconds_per_volume_prob_transfer": seconds["probs"],
        "seconds_per_volume_masks_plus_lesion_probs": seconds["lesion"],
        "prob_wire": args.prob_wire,
        "first_call_with_compile_s": sum(first.values()),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
