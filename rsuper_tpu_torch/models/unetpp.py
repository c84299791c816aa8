"""UNet++ (counterpart of ``rsuper_tpu/models/unetpp.py``), channels-last:
nested dense skip pathways X^{i,j}, each decoder node the concatenation of
its same-resolution predecessors and the upsampled deeper node.

With a ``spatial`` argument (``parallel/spatial.py``) every node runs
depth-sharded, as the JAX model does under ``spatial_constraint``: halo
exchanges in the convs and the resizes, group sums in the norms, pools on
a local depth they divide; the logits come back sharded."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv1, ConvNormAct, resize_trilinear
from .unet3d import max_pool


class _Block(nn.Module):
    """Two post-activated 3³ ConvNormActs (instance norm, ReLU)."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(c_in, features, 3, dtype=dtype)
        self.ConvNormAct_1 = ConvNormAct(features, features, 3, dtype=dtype)

    def forward(self, x, spatial=None):
        return self.ConvNormAct_1(self.ConvNormAct_0(x, spatial), spatial)


class UNetPlusPlus(nn.Module):
    """(B, D, H, W, 1) → ``{"segmentation": logits}``; node X^{i,j} is the
    module ``x{i}_{j}``; ``outc`` in float32."""

    def __init__(self, num_classes: int, base_chan: int = 32, depth: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        chans = [base_chan * 2 ** i for i in range(depth + 1)]
        for i in range(depth + 1):
            self.add_module(f"x{i}_0", _Block(
                1 if i == 0 else chans[i - 1], chans[i], dtype))
        for j in range(1, depth + 1):
            for i in range(depth + 1 - j):
                self.add_module(f"x{i}_{j}", _Block(
                    j * chans[i] + chans[i + 1], chans[i], dtype))
        self.outc = Conv1(chans[0], num_classes, True, torch.float32)

    def forward(self, x, spatial=None):
        """With `spatial`, `x` and the logits are the rank's depth
        planes."""
        grid = {}
        h = x.to(self.dtype)
        for i in range(self.depth + 1):
            if i > 0:
                h = max_pool(grid[(i - 1, 0)], (2, 2, 2), spatial)
            h = grid[(i, 0)] = getattr(self, f"x{i}_0")(h, spatial)
        for j in range(1, self.depth + 1):
            for i in range(self.depth + 1 - j):
                up = resize_trilinear(grid[(i + 1, j - 1)],
                                      grid[(i, 0)].shape[1:4],
                                      spatial=spatial).to(self.dtype)
                cat = torch.cat([grid[(i, k)] for k in range(j)] + [up],
                                dim=-1)
                grid[(i, j)] = getattr(self, f"x{i}_{j}")(cat, spatial)
        return {"segmentation": self.outc(grid[(0, self.depth)])}
