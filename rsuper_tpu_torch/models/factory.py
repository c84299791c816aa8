"""Model factory (counterpart of ``rsuper_tpu/models/factory.py``): every
architecture of the JAX registry, with its defaults. The 3D models take
channels-last ``(B, D, H, W, 1)`` volumes, the ``*_2d`` ones ``(B, H, W, 1)``
slices; all return ``{"segmentation": logits | [logits, aux], ...}``.
``swin_unet_2d`` and ``transunet_2d`` have parameters whose shapes depend
on the input size, which the JAX models take from the input they are
initialised with: here the model argument ``img_size`` (H, W) gives it
(default (256, 256), the ``slices/resunet_2d`` preset's size)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .attention_unet import AttentionUNet
from .dim2 import AttentionUNet2D, DualAttentionUNet2D, TransUNet2D, UNet2D
from .dim2_zoo import MedFormer2D, SwinUNet2D, UNetPlusPlus2D
from .medformer import MedFormer
from .nnformer import NnFormer, VTUNet
from .swin_unetr import SwinUNETR
from .unet3d import UNet3D
from .unetpp import UNetPlusPlus
from .unetr import UNETR
from .vnet import VNet


def _unet(args: Dict[str, Any], num_classes: int, dtype):
    return UNet3D(
        num_classes=num_classes,
        base_chan=args.get("base_chan", 32),
        block=args.get("block", "ConvNormAct"),
        pool=args.get("pool", False),
        norm=args.get("norm", "in"),
        aux_head=args.get("aux_head", False),
        dtype=dtype,
    )


def _resunet(args, num_classes, dtype):
    args = dict(args)
    args.setdefault("block", "BasicBlock")
    return _unet(args, num_classes, dtype)


def _medformer(args: Dict[str, Any], num_classes: int, dtype):
    # as in the JAX registry, `kernel_size` and `scale` keep the model's
    # defaults here (construct MedFormer directly for others)
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
        cf_fullres=args.get("cf_fullres", True),
        cf_halfres=args.get("cf_halfres", True),
        torch_port=args.get("torch_port", False),
        dtype=dtype,
    )


def _vnet(args, num_classes, dtype):
    return VNet(num_classes=num_classes, base_chan=args.get("base_chan", 16),
                dtype=dtype)


def _unetr(args, num_classes, dtype):
    return UNETR(
        num_classes=num_classes,
        img_size=tuple(args.get("img_size", (96, 96, 96))),
        feature_size=args.get("feature_size", 16),
        hidden_size=args.get("hidden_size", 768),
        mlp_dim=args.get("mlp_dim", 3072),
        num_heads=args.get("num_heads", 12),
        num_layers=args.get("num_layers", 12),
        dtype=dtype,
    )


def _attention_unet(args, num_classes, dtype):
    return AttentionUNet(num_classes=num_classes,
                         base_chan=args.get("base_chan", 32), dtype=dtype)


def _unetpp(args, num_classes, dtype):
    return UNetPlusPlus(num_classes=num_classes,
                        base_chan=args.get("base_chan", 32),
                        depth=args.get("depth", 4), dtype=dtype)


def _swin_unetr(args, num_classes, dtype):
    return SwinUNETR(
        num_classes=num_classes,
        feature_size=args.get("feature_size", 48),
        depths=tuple(args.get("depths", (2, 2, 2, 2))),
        num_heads=tuple(args.get("num_heads", (3, 6, 12, 24))),
        window_size=args.get("window_size", 4),
        dtype=dtype,
    )


def _nnformer(args, num_classes, dtype):
    return NnFormer(
        num_classes=num_classes, embed_dim=args.get("embed_dim", 48),
        depths=tuple(args.get("depths", (2, 2, 2))),
        num_heads=tuple(args.get("num_heads", (3, 6, 12))),
        window_size=args.get("window_size", 4),
        aux_loss=args.get("aux_loss", True), dtype=dtype)


def _vtunet(args, num_classes, dtype):
    return VTUNet(
        num_classes=num_classes, embed_dim=args.get("embed_dim", 48),
        depths=tuple(args.get("depths", (2, 2, 2))),
        num_heads=tuple(args.get("num_heads", (3, 6, 12))),
        window_size=args.get("window_size", 4), dtype=dtype)


MODEL_REGISTRY = {
    "unet": _unet,
    "resunet": _resunet,
    "medformer": _medformer,
    "vnet": _vnet,
    "unetr": _unetr,
    "attention_unet": _attention_unet,
    "unetpp": _unetpp,
    "swin_unetr": _swin_unetr,
    "nnformer": _nnformer,
    "vtunet": _vtunet,
    # 2D pathway (--dimension 2d in the reference); resunet_2d is the same
    # UNet2D as unet_2d, as in the JAX registry
    "unet_2d": lambda a, n, d: UNet2D(
        num_classes=n, base_chan=a.get("base_chan", 32), dtype=d),
    "resunet_2d": lambda a, n, d: UNet2D(
        num_classes=n, base_chan=a.get("base_chan", 32), dtype=d),
    "attention_unet_2d": lambda a, n, d: AttentionUNet2D(
        num_classes=n, base_chan=a.get("base_chan", 32), dtype=d),
    "dual_attention_unet_2d": lambda a, n, d: DualAttentionUNet2D(
        num_classes=n, base_chan=a.get("base_chan", 32), dtype=d),
    "transunet_2d": lambda a, n, d: TransUNet2D(
        num_classes=n, base_chan=a.get("base_chan", 32),
        hidden=a.get("hidden", 256), depth=a.get("depth", 4),
        heads=a.get("heads", 8),
        img_size=tuple(a.get("img_size", (256, 256))), dtype=d),
    "swin_unet_2d": lambda a, n, d: SwinUNet2D(
        num_classes=n, embed_dim=a.get("embed_dim", 96),
        depths=tuple(a.get("depths", (2, 2, 2, 2))),
        num_heads=tuple(a.get("num_heads", (3, 6, 12, 24))),
        window_size=a.get("window_size", 4),
        patch_size=a.get("patch_size", 4),
        img_size=tuple(a.get("img_size", (256, 256))), dtype=d),
    "unetpp_2d": lambda a, n, d: UNetPlusPlus2D(
        num_classes=n, base_chan=a.get("base_chan", 32),
        depth=a.get("depth", 4), dtype=d),
    "medformer_2d": lambda a, n, d: MedFormer2D(
        num_classes=n, base_chan=a.get("base_chan", 32),
        map_size=a.get("map_size", 8),
        conv_num=tuple(a.get("conv_num", (2, 1, 0, 0, 0, 1, 2, 2))),
        trans_num=tuple(a.get("trans_num", (0, 1, 2, 2, 2, 1, 0, 0))),
        num_heads=tuple(a.get("num_heads", (1, 4, 8, 16, 8, 4, 1, 1))),
        fusion_depth=a.get("fusion_depth", 2),
        fusion_dim=a.get("fusion_dim", 512),
        fusion_heads=a.get("fusion_heads", 16),
        aux_loss=a.get("aux_loss", False), dtype=d),
}


def get_model(arch: str, num_classes: int, args: Dict[str, Any] | None = None,
              dtype=torch.bfloat16):
    """Build a model (float32 parameters, computing in `dtype`). Its
    parameters are uninitialised: fill them with ``init_params`` or
    ``load_flax_params``."""
    if arch not in MODEL_REGISTRY:
        raise ValueError(f"unknown arch {arch!r}; the port has "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[arch](args or {}, num_classes, dtype)
