#!/usr/bin/env python
"""Convert a reference R-Super torch MedFormer checkpoint into a checkpoint
directory of the port — counterpart of the JAX package's
``tools/convert_torch_checkpoint.py``.

    python -m rsuper_tpu_torch.convert_checkpoint model.pth out/ [--ema] \\
        [--classes 16] [--chan_num ...] [model flags]

Writes ``out/best`` in ``train/checkpoint.py``'s format holding the
parameters alone, and ``out/convert_info.json``. Then

    python -m rsuper_tpu_torch.predict --checkpoint out \\
        --model_args_json '{"torch_port": true}' ...
    python -m rsuper_tpu_torch.train ... --pretrained out

read it; ``torch_port`` gives the reference's numerics (align-corners
upsampling, torch norm eps; ``models/torch_port.py``).

The source may be a ``.pth`` from the reference trainer
(``{'model_state_dict': ..., 'ema_model_state_dict': ...}``, read with
``torch.load(weights_only=True)``; DDP's ``module.`` and ``torch.compile``'s
``_orig_mod.`` prefixes are dropped), a bare state_dict ``.pth``, or an
``.npz`` of the state_dict's keys. Unless ``--skip_verify``, the converted
parameters are loaded with ``strict=True`` into a freshly built port
MedFormer of the flags' configuration (the segmentation classes default to
the checkpoint's own, read from ``outc``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_source(path: str, ema: bool):
    """The source's state_dict as numpy arrays (the EMA weights with
    `ema`)."""
    if path.endswith(".npz"):
        if ema:
            raise ValueError(f"--ema: {path} is an .npz of one state_dict")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model_state_dict" in raw:
        key = "ema_model_state_dict" if ema else "model_state_dict"
        if raw.get(key) is None:
            raise ValueError(f"--ema: {path} holds no {key}")
        raw = raw[key]
    elif ema:
        raise ValueError(f"--ema: {path} is a bare state_dict, with no EMA "
                         "weights")
    return {k: v.detach().float().numpy() if hasattr(v, "detach")
            else np.asarray(v) for k, v in raw.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help=".pth or .npz torch state_dict")
    ap.add_argument("out", help="output checkpoint directory")
    ap.add_argument("--ema", action="store_true",
                    help="convert the EMA weights instead of the raw model")
    ap.add_argument("--classes", type=int, default=None,
                    help="segmentation classes of the source checkpoint "
                         "(checked by the verification; default: outc's)")
    ap.add_argument("--base_chan", type=int, default=32)
    ap.add_argument("--chan_num", default="64,128,256,320,256,128,64,32")
    ap.add_argument("--conv_num", default="2,0,0,0,0,0,2,2")
    ap.add_argument("--trans_num", default="0,2,4,6,4,2,0,0")
    ap.add_argument("--num_heads", default="1,4,8,10,8,4,1,1")
    ap.add_argument("--fusion_depth", type=int, default=2)
    ap.add_argument("--fusion_dim", type=int, default=320)
    ap.add_argument("--fusion_heads", type=int, default=10)
    ap.add_argument("--no_aux", action="store_true")
    ap.add_argument("--classification", action="store_true")
    ap.add_argument("--clip", action="store_true")
    ap.add_argument("--skip_verify", action="store_true",
                    help="skip loading the result into a fresh port model")
    args = ap.parse_args(argv)

    import torch

    from .models import get_model
    from .models.params import params_from_flax
    from .models.torch_port import convert_state_dict
    from .train.checkpoint import save_params

    def ints(s):
        return tuple(int(x) for x in s.split(","))

    arch = dict(base_chan=args.base_chan, chan_num=ints(args.chan_num),
                conv_num=ints(args.conv_num), trans_num=ints(args.trans_num),
                num_heads=ints(args.num_heads),
                fusion_depth=args.fusion_depth)
    params, missing, unused = convert_state_dict(
        load_source(args.source, args.ema), aux_loss=not args.no_aux,
        classification=args.classification, clip=args.clip, **arch)
    if unused:
        print(f"note: {len(unused)} torch keys unused (first 5): "
              f"{unused[:5]}")
    state = params_from_flax(params)

    if not args.skip_verify:
        heads = {}
        if args.classification:
            heads["classification_classes"] = int(
                state["cls_branch.Dense_0.bias"].shape[0])
        if args.clip:
            heads.update(clip_branch=True, clip_feats=int(
                state["clip_branch.Dense_0.bias"].shape[0]))
        classes = args.classes or int(state["outc.bias"].shape[0])
        model = get_model("medformer", classes, dict(
            arch, fusion_dim=args.fusion_dim, fusion_heads=args.fusion_heads,
            aux_loss=not args.no_aux, torch_port=True, **heads),
            dtype=torch.float32)
        model.load_state_dict(state, strict=True)

    out = os.path.abspath(args.out)
    save_params(out, state)
    with open(os.path.join(out, "convert_info.json"), "w") as f:
        json.dump({"source": os.path.abspath(args.source), "ema": args.ema,
                   "missing": missing, "unused": unused,
                   "note": "run the model with torch_port=True"}, f,
                  indent=1)
    print(f"wrote {out}/best ({len(missing)} missing, {len(unused)} unused)")
    return out


if __name__ == "__main__":
    main()
