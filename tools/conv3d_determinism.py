#!/usr/bin/env python3
"""Does the port's float32 3D training step give the same bits twice?

Runs on one CUDA card (the PyTorch port; no JAX). Two modes of the dense
conv's backward (``rsuper_tpu_torch/models/layers.py`` ``Conv``):

* ``library``: ``F.conv3d``/``F.conv2d``'s own backward (cuDNN's default
  algorithms), as ``layers.Conv`` ran its 3D convs before
  ``layers._ConvFixedOrder`` served them;
* ``port``: the port as it is.

In each mode, twice from the same parameters and batch: one step of the
phantom study's model (``resunet`` base 8, float32) on a batch the report
arm's training loop took (``ball_dice_last`` with a live report slot), and
one float32 step of the ``abdomenatlas/resunet_3d`` preset's model at its
128³ × 2. It prints the gradients that differ and their largest difference.
Then the 3D conv's backward alone at two of the preset's shapes, float32 and
bf16: whether each backward gives the same bits twice, and its ms.

    python tools/conv3d_determinism.py [--out conv3d_determinism.json]

cuDNN's TF32 setting is the process default (the training CLI's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _library_conv(x, w, b, stride, padding, groups):
    import torch.nn.functional as F

    conv = F.conv2d if w.dim() == 4 else F.conv3d
    return conv(x, w, b, stride, padding, groups=groups)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="conv3d_determinism.json")
    ap.add_argument("--capture_steps", type=int, default=4,
                    help="report-arm steps run to capture a batch")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from rsuper_tpu_torch import phantom_benchmark as pb
    from rsuper_tpu_torch.models import layers
    from rsuper_tpu_torch.ops import _build
    from rsuper_tpu_torch.utils.device import card_line, resolve_device

    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    _build.build_all()
    t0 = time.time()
    res = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    with tempfile.TemporaryDirectory(prefix="phantom_") as root:
        pb.generate(root, cs.PHANTOM_DATA["n_mask"],
                    cs.PHANTOM_DATA["n_report"], 0, seed=0)
        with cs._last_step_batch() as seen:
            pb.train_variant(root, True, args.capture_steps,
                             crop=cs.PHANTOM_CROP, device=dev)
    if "batch" not in seen:
        print("no captured batch with a live report slot", file=sys.stderr)
        return 1
    for mode in ("library", "port"):
        if mode == "library":  # shadows the inherited Function.apply
            layers._ConvFixedOrder.apply = staticmethod(_library_conv)
        try:
            res[mode] = dict(
                phantom_step_twice=cs._phantom_grads_twice(dev, seen),
                preset_float32_step_twice=cs._preset_float32_grads_twice(dev))
        finally:
            if "apply" in vars(layers._ConvFixedOrder):
                del layers._ConvFixedOrder.apply
        print(json.dumps({mode: res[mode]}), flush=True)
    res["conv3d_backward_twice"] = (
        cs._conv_backward_twice(dev, cs.RESUNET_CONVS)
        + cs._conv_backward_twice(dev, cs.RESUNET_CONVS, torch.bfloat16))
    for r in res["conv3d_backward_twice"]:
        print(json.dumps({"conv3d_backward": r}), flush=True)
    res["seconds"] = time.time() - t0
    res["device"] = card_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    ok = all(not res["port"][k]["differing"] for k in res["port"])
    print(json.dumps({"port_bit_equal_twice": ok,
                      "seconds": res["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
