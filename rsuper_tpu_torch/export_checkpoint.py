#!/usr/bin/env python
"""Export a checkpoint of the port as a reference R-Super torch state_dict —
counterpart of the JAX package's ``tools/export_torch_checkpoint.py``.

    python -m rsuper_tpu_torch.export_checkpoint CKPT_DIR TAG OUT.pth [--ema]
    python -m rsuper_tpu_torch.export_checkpoint CKPT_DIR TAG OUT.npz [--ema]

Reads ``CKPT_DIR/TAG`` (``train/checkpoint.py``'s ``load_params``: ``TAG``
falls back to ``latest``; ``--ema`` takes the EMA copy), carries the
parameters back to the flax layout (``models/params.py``'s
``flax_from_state_dict``) and from there to the reference's keys and
layouts (``models/torch_port.py``'s ``export_state_dict``). Writes
``{"model_state_dict": ...}`` with ``torch.save`` for a ``.pth``, the bare
keys with ``np.savez`` for an ``.npz``: weights trained by the port load
into the reference's torch MedFormer with
``model.load_state_dict(torch.load("OUT.pth")["model_state_dict"])``.
``convert_checkpoint`` is the inverse: the round trip is exact. Pass the
architecture flags of a model that is not the default. Host only: the
conversion is numpy and needs no card.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Writes the export and returns its state_dict (numpy arrays)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt_dir", help="checkpoint directory of the port")
    ap.add_argument("tag", help="checkpoint tag (e.g. best, latest)")
    ap.add_argument("out", help="output .pth or .npz")
    ap.add_argument("--ema", action="store_true",
                    help="export the EMA copy instead of the parameters")
    ap.add_argument("--base_chan", type=int, default=32)
    ap.add_argument("--chan_num", default="64,128,256,320,256,128,64,32")
    ap.add_argument("--conv_num", default="2,0,0,0,0,0,2,2")
    ap.add_argument("--trans_num", default="0,2,4,6,4,2,0,0")
    ap.add_argument("--num_heads", default="1,4,8,10,8,4,1,1")
    ap.add_argument("--fusion_depth", type=int, default=2)
    ap.add_argument("--no_aux", action="store_true")
    ap.add_argument("--classification", action="store_true")
    ap.add_argument("--clip", action="store_true")
    args = ap.parse_args(argv)

    from .models.params import flax_from_state_dict
    from .models.torch_port import export_state_dict
    from .train.checkpoint import load_params

    def ints(s):
        return tuple(int(x) for x in s.split(","))

    params = flax_from_state_dict(
        load_params(args.ckpt_dir, args.tag, ema=args.ema))
    state = export_state_dict(
        params, base_chan=args.base_chan, chan_num=ints(args.chan_num),
        conv_num=ints(args.conv_num), trans_num=ints(args.trans_num),
        num_heads=ints(args.num_heads), fusion_depth=args.fusion_depth,
        aux_loss=not args.no_aux, classification=args.classification,
        clip=args.clip)
    if args.out.endswith(".npz"):
        np.savez(args.out, **state)
    else:
        import torch

        torch.save({"model_state_dict":
                    {k: torch.from_numpy(v) for k, v in state.items()}},
                   args.out)
    print(f"wrote {args.out} ({len(state)} tensors)")
    return state


if __name__ == "__main__":
    main()
