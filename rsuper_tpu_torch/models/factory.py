"""Model factory (counterpart of ``rsuper_tpu/models/factory.py``); the
port builds MedFormer only."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .medformer import MedFormer


def _medformer(args: Dict[str, Any], num_classes: int, dtype):
    for key in ("cf_fullres", "cf_halfres"):
        if not args.get(key, True):
            raise NotImplementedError(f"MedFormer {key}=False is not ported")
    return MedFormer(
        num_classes=num_classes,
        base_chan=args.get("base_chan", 32),
        map_size=tuple(args.get("map_size", (3, 3, 3))),
        conv_block=args.get("conv_block", "BasicBlock"),
        conv_num=tuple(args.get("conv_num", (2, 0, 0, 0, 0, 0, 2, 2))),
        trans_num=tuple(args.get("trans_num", (0, 2, 4, 6, 4, 2, 0, 0))),
        chan_num=tuple(args.get("chan_num",
                                (64, 128, 256, 320, 256, 128, 64, 32))),
        num_heads=tuple(args.get("num_heads", (1, 4, 8, 10, 8, 4, 1, 1))),
        fusion_depth=args.get("fusion_depth", 2),
        fusion_dim=args.get("fusion_dim", 320),
        fusion_heads=args.get("fusion_heads", 10),
        expansion=args.get("expansion", 4),
        proj_type=args.get("proj_type", "depthwise"),
        norm=args.get("norm", "in"),
        act=args.get("act", "relu"),
        aux_loss=args.get("aux_loss", True),
        classification_classes=args.get("classification_classes", 0),
        clip_branch=args.get("clip_branch", False),
        clip_feats=args.get("clip_feats", 768),
        remat=args.get("remat", True),
        torch_port=args.get("torch_port", False),
        dtype=dtype,
    )


MODEL_REGISTRY = {"medformer": _medformer}


def get_model(arch: str, num_classes: int, args: Dict[str, Any] | None = None,
              dtype=torch.bfloat16):
    """Build a model (float32 parameters, computing in `dtype`). Its
    parameters are uninitialised: fill them with ``init_params`` or
    ``load_flax_params``."""
    if arch not in MODEL_REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; the port has "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[arch](args or {}, num_classes, dtype)
