"""The Model-Genesis restoration loss (counterpart of
``rsuper_tpu/losses/genesis.py``): the voxel-wise float32 MSE between the
restored volume and its target."""

from __future__ import annotations

from typing import Dict

import torch


def model_genesis_loss(restored: torch.Tensor,
                       target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{"genesis_loss", "overall"}``, both the mean squared difference in
    float32."""
    loss = torch.mean((restored.float() - target.float()) ** 2)
    return {"genesis_loss": loss, "overall": loss}
