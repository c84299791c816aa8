#!/usr/bin/env python
"""Batch-prediction CLI of the PyTorch/CUDA port — counterpart of the JAX
package's ``predict.py``.

    python -m rsuper_tpu_torch.predict --input_dir cts/ --output_dir preds/ \\
        (--checkpoint exp/run1 [--tag best|latest] [--ema] | \\
         --params_npz params.npz) --classes_json classes.json \\
        [--ensemble exp/run2 more.npz ...] [--parts 4 --part 0] [--device cpu]

``--checkpoint`` is a directory of ``train/checkpoint.py``: what
``python -m rsuper_tpu_torch.train`` writes, or what
``python -m rsuper_tpu_torch.convert_checkpoint`` makes of a reference
R-Super ``.pth`` (serve that with ``--model_args_json`` holding
``{"torch_port": true}``). ``--tag`` falls back to ``latest`` when absent;
``--ema`` serves the EMA copy. ``--params_npz`` is an ``.npz`` of flax
parameter paths joined with ``/`` (``tools/export_params_npz.py`` writes one
from a JAX checkpoint). Each ``--ensemble`` entry is a checkpoint directory
or an ``.npz`` file. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os


def _read_ids(path: str):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    col = "BDMAP_ID" if rows and "BDMAP_ID" in rows[0] else "BDMAP ID"
    return [r[col] for r in rows]


def read_model_args(spec):
    """MedFormer arguments from a JSON file, or from JSON text itself
    (``'{"torch_port": true}'``); ``{}`` for None."""
    if not spec:
        return {}
    if os.path.isfile(spec):
        with open(spec) as f:
            return json.load(f)
    return json.loads(spec)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint",
                     help="checkpoint directory (train/checkpoint.py)")
    src.add_argument("--params_npz",
                     help=".npz of flax parameter paths joined with '/'")
    p.add_argument("--ensemble", nargs="*", default=[],
                   help="more checkpoint directories or .npz files to "
                        "ensemble")
    p.add_argument("--tag", default="best", choices=["best", "latest"])
    p.add_argument("--ema", action="store_true",
                   help="serve the EMA weights of each checkpoint directory")
    p.add_argument("--classes_json", required=True,
                   help="JSON list of class names (sorted)")
    p.add_argument("--arch", default="medformer")
    p.add_argument("--model_args_json", default=None,
                   help="JSON file or JSON text of MedFormer arguments")
    p.add_argument("--window", type=int, nargs=3, default=(128, 128, 128))
    p.add_argument("--batch_windows", type=int, default=8)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--no_organ_gating", action="store_true")
    p.add_argument("--connected_components", action="store_true")
    p.add_argument("--save_probabilities", action="store_true")
    p.add_argument("--prob_wire", default="u8", choices=["u8", "f16"],
                   help="transfer format of the --save_probabilities lesion "
                        "channels: u8 (error <= 1/510) or f16")
    p.add_argument("--ids_csv", default=None, help="CSV with BDMAP_ID column")
    p.add_argument("--parts", type=int, default=1)
    p.add_argument("--part", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from rsuper_tpu_torch.inference.predict import predict_folder
    from rsuper_tpu_torch.models import get_model, load_flax_params
    from rsuper_tpu_torch.train.checkpoint import load_params
    from rsuper_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with open(args.classes_json) as f:
        classes = sorted(json.load(f))
    model_args = read_model_args(args.model_args_json)

    model_fns = []
    for path in [args.checkpoint or args.params_npz] + list(args.ensemble):
        model = get_model(args.arch, len(classes), model_args,
                          dtype=torch.bfloat16)
        if path == args.checkpoint or os.path.isdir(path):
            model.load_state_dict(load_params(path, args.tag, args.ema))
        else:
            if args.ema:
                raise ValueError(f"--ema: {path} is an .npz of one set of "
                                 "parameters, not a checkpoint directory")
            with np.load(path) as z:
                load_flax_params(model, {k: z[k] for k in z.files})
        model = model.to(device).eval()

        def fn(x, model=model):
            out = model(x)["segmentation"]
            return out[0] if isinstance(out, (list, tuple)) else out

        model_fns.append(fn)

    ids = _read_ids(args.ids_csv) if args.ids_csv else None
    done = predict_folder(
        model_fns, args.input_dir, args.output_dir, classes,
        window=tuple(args.window), batch=args.batch_windows,
        threshold=args.threshold,
        organ_mask_on_lesion=not args.no_organ_gating,
        connected_components=args.connected_components,
        save_probabilities=args.save_probabilities,
        prob_wire=args.prob_wire,
        ids=ids, parts=args.parts, part=args.part, device=device,
    )
    print(f"predicted {len(done)} cases")
    return done


if __name__ == "__main__":
    main()
