"""Training configuration: presets merged with command-line overrides (the
port's own copy of ``rsuper_tpu/config/config.py``).

One typed dataclass, ``TrainConfig``, built from a preset (a Python dict of
``DEFAULT_CONFIGS``), an optional YAML file and the overrides, the last
winning. PyYAML is imported only when a YAML file is given: the presets and
the command line need no package beyond the standard library.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    # data
    data_root: str = ""
    report_root: str = ""
    reports: str = ""
    classes: Tuple[str, ...] = ()
    report_classes: Tuple[str, ...] = ()
    tumor_classes: Tuple[str, ...] = ("kidney", "pancreas")
    training_size: Tuple[int, int, int] = (128, 128, 128)
    batch_size: int = 2  # per-step global batch
    num_workers: int = 8
    balance_supervision: bool = True
    # model
    arch: str = "medformer"
    model_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    compute_dtype: str = "bfloat16"
    # optimisation
    epochs: int = 150
    iter_per_epoch: int = 1000
    optimizer: str = "adamw"
    base_lr: float = 6e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.05
    warmup_epochs: int = 5
    clip_norm: float = 1.0
    ema: bool = True
    ema_alpha: float = 0.99
    # multi-device and host-augmentation options of the JAX package:
    # ZeRO-1 over the data ranks, the depth (the rows of a 2D slice) split
    # over spatial_shard ranks, augmentation in the loader's workers and
    # the device prefetcher
    zero_opt: bool = False
    zero_ema: bool = False
    spatial_shard: int = 1
    host_augment: bool = False
    device_prefetch: int = 0
    # losses (see losses.dispatcher.LossConfig)
    loss: str = "ball_dice_last"
    aux_weight: Tuple[float, ...] = (0.5, 0.5)
    seg_loss: float = 1.0
    report_volume_loss_basic: float = 1.0
    volume_loss_tolerance: float = 0.2
    ball_bce_weight: float = 1.0
    ball_dice_weight: float = 1.0
    ball_volume_margin: float = 0.2
    standard_ce_ball: bool = False
    classification_branch: bool = False
    class_weights: bool = False
    # augmentation
    scale: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotate: Tuple[float, float, float] = (30.0, 30.0, 30.0)
    translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # validation / checkpointing
    val_freq: int = 20000
    cp_path: str = "./exp"
    unique_name: str = "test"
    save_every: int = 25
    resume: bool = False
    pretrained: str = ""
    old_classes: str = ""
    # baselines
    model_genesis_pretrain: bool = False
    clip_pretrain: bool = False
    clip_source: str = ""
    # 2d = slice training; inferred from training_size when "auto"
    dimension: str = "auto"
    # runtime
    seed: int = 0
    data_shards: int = 1
    shard_index: int = 0
    # read the loss on the host (NaN guard + meters) every N steps only: a
    # read each step waits for the device
    nan_check_every: int = 20

    def loss_config(self):
        from ..losses import LossConfig

        return LossConfig(
            loss=self.loss,
            aux_weight=tuple(self.aux_weight),
            seg_loss=self.seg_loss,
            report_volume_loss_basic=self.report_volume_loss_basic,
            volume_loss_tolerance=self.volume_loss_tolerance,
            ball_bce_weight=self.ball_bce_weight,
            ball_dice_weight=self.ball_dice_weight,
            standard_ce_ball=self.standard_ce_ball,
            ball_volume_margin=self.ball_volume_margin,
            classification_branch=self.classification_branch,
        )

    @property
    def is_2d(self) -> bool:
        return self.dimension == "2d" or (
            self.dimension == "auto" and len(self.training_size) == 2)


DEFAULT_CONFIGS: Dict[str, Dict[str, Any]] = {
    # R-Super's config/abdomenatlas_ufo/medformer_3d.yaml
    "abdomenatlas_ufo/medformer_3d": dict(
        arch="medformer",
        model_args=dict(
            base_chan=32,
            map_size=(3, 3, 3),
            conv_num=(2, 0, 0, 0, 0, 0, 2, 2),
            trans_num=(0, 2, 4, 6, 4, 2, 0, 0),
            chan_num=(64, 128, 256, 320, 256, 128, 64, 32),
            num_heads=(1, 4, 8, 10, 8, 4, 1, 1),
            fusion_depth=2,
            fusion_dim=320,
            fusion_heads=10,
            expansion=4,
            proj_type="depthwise",
            norm="in",
            act="relu",
            aux_loss=True,
        ),
        training_size=(128, 128, 128),
        epochs=150,
        iter_per_epoch=1000,
        optimizer="adamw",
        base_lr=6e-4,
        weight_decay=0.05,
        aux_weight=(0.5, 0.5),
        scale=(0.0, 0.0, 0.0),
        rotate=(30.0, 30.0, 30.0),
        translate=(0.0, 0.0, 0.0),
        ema=True,
        ema_alpha=0.99,
        val_freq=20000,
    ),
    # R-Super's config/abdomenatlas/resunet_3d.yaml
    "abdomenatlas/resunet_3d": dict(
        arch="resunet",
        model_args=dict(base_chan=32, block="BasicBlock", norm="in"),
        training_size=(128, 128, 128),
        epochs=1000,
        iter_per_epoch=1000,
        optimizer="adamw",
        base_lr=6e-4,
        weight_decay=0.05,
        scale=(0.3, 0.3, 0.3),
        rotate=(30.0, 30.0, 30.0),
        ema=True,
        val_freq=50,
    ),
    # the 2D slice-training pathway
    "slices/resunet_2d": dict(
        arch="resunet_2d",
        model_args=dict(base_chan=32),
        training_size=(256, 256),
        dimension="2d",
        epochs=300,
        iter_per_epoch=500,
        optimizer="adamw",
        base_lr=6e-4,
        weight_decay=0.05,
        loss="dice",
        report_volume_loss_basic=0.0,
        ema=True,
        val_freq=50,
    ),
}

_TUPLE_KEYS = ("classes", "report_classes", "tumor_classes", "training_size",
               "aux_weight", "scale", "rotate", "translate", "betas")


def _read_yaml(path: str) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"--config {path}: reading a YAML config needs PyYAML, which is "
            "not installed; use a --preset and command-line overrides") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(
    preset: Optional[str] = None,
    yaml_path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> TrainConfig:
    """Build a TrainConfig from (preset | YAML file) + overrides (CLI wins)."""
    values: Dict[str, Any] = {}
    if preset is not None:
        if preset not in DEFAULT_CONFIGS:
            raise ValueError(f"unknown preset {preset!r}; options: "
                             f"{sorted(DEFAULT_CONFIGS)}")
        values.update(DEFAULT_CONFIGS[preset])
    if yaml_path is not None:
        values.update(_read_yaml(yaml_path))
    for k, v in (overrides or {}).items():
        if v is not None:
            values[k] = v
    field_names = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(values) - field_names
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    for key in _TUPLE_KEYS:
        if key in values and isinstance(values[key], list):
            values[key] = tuple(values[key])
    return TrainConfig(**values)
