"""V-Net (counterpart of ``rsuper_tpu/models/vnet.py``), channels-last.

5³ convs with residual additions, strided 2³ conv down and transposed 2³
conv up transitions, skip concatenation in the decoder, PReLU, and instance
norm where the reference has its always-training BatchNorm (as in the JAX
package).

With a ``spatial`` argument (``parallel/spatial.py``) every stage runs
depth-sharded, as the JAX model does under ``spatial_constraint``: the 5³
convs exchange two halo planes a side, the strided 2³ convs and the 2³
transposed convs need none (a local depth their stride divides), the norms
sum over the model group, and the logits come back sharded.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv, Conv1, ConvTranspose, instance_norm


class PReLU(nn.Module):
    """x where x ≥ 0, else α·x; one ``alpha`` a channel."""

    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class LUConv(nn.Module):
    def __init__(self, c_in: int, features: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, features, 5, dtype=dtype)
        self.PReLU_0 = PReLU(features)

    def forward(self, x, spatial=None):
        return self.PReLU_0(instance_norm(self.Conv_0(x, spatial),
                                          spatial=spatial))


class DownTransition(nn.Module):
    def __init__(self, c_in: int, features: int, n_convs: int,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, features, 2, 2, dtype=dtype)
        self.PReLU_0 = PReLU(features)
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"LUConv_{i}", LUConv(features, features, dtype))
        self.PReLU_1 = PReLU(features)

    def forward(self, x, spatial=None):
        down = self.PReLU_0(instance_norm(self.Conv_0(x, spatial),
                                          spatial=spatial))
        h = down
        for i in range(self.n_convs):
            h = getattr(self, f"LUConv_{i}")(h, spatial)
        return self.PReLU_1(h + down)


class UpTransition(nn.Module):
    def __init__(self, c_in: int, c_skip: int, features: int, n_convs: int,
                 dtype=torch.float32):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(c_in, features // 2, 2, 2,
                                             dtype=dtype)
        self.PReLU_0 = PReLU(features // 2)
        self.n_convs = n_convs
        c_cat = features // 2 + c_skip
        for i in range(n_convs):
            self.add_module(f"LUConv_{i}", LUConv(
                c_cat if i == 0 else features, features, dtype))
        self.PReLU_1 = PReLU(features)

    def forward(self, x, skip, spatial=None):
        up = self.PReLU_0(instance_norm(self.ConvTranspose_0(x, spatial),
                                        spatial=spatial))
        cat = torch.cat([up, skip.to(up.dtype)], dim=-1)
        h = cat
        for i in range(self.n_convs):
            h = getattr(self, f"LUConv_{i}")(h, spatial)
        return self.PReLU_1(h + cat)


class VNet(nn.Module):
    """(B, D, H, W, 1) → ``{"segmentation": logits}``, channels-last; the
    head ``outc`` computes in float32."""

    def __init__(self, num_classes: int, base_chan: int = 16,
                 dtype=torch.float32):
        super().__init__()
        b = base_chan
        self.dtype = dtype
        self.Conv_0 = Conv(1, b, 5, dtype=dtype)
        self.PReLU_0 = PReLU(b)
        for i, (c_in, c, n) in enumerate(((b, 2 * b, 1), (2 * b, 4 * b, 2),
                                          (4 * b, 8 * b, 3),
                                          (8 * b, 16 * b, 2))):
            self.add_module(f"DownTransition_{i}",
                            DownTransition(c_in, c, n, dtype))
        for i, (c_in, c_skip, c, n) in enumerate((
                (16 * b, 8 * b, 16 * b, 2), (16 * b, 4 * b, 8 * b, 2),
                (8 * b, 2 * b, 4 * b, 1), (4 * b, b, 2 * b, 1))):
            self.add_module(f"UpTransition_{i}",
                            UpTransition(c_in, c_skip, c, n, dtype))
        self.outc = Conv1(2 * b, num_classes, True, torch.float32)

    def forward(self, x, spatial=None):
        """With `spatial`, `x` and the logits are the rank's depth
        planes."""
        x = x.to(self.dtype)
        h = instance_norm(self.Conv_0(x, spatial), spatial=spatial)
        # the input residual: the input's channels repeated (jnp.repeat
        # interleaves) across the features
        rep = h.shape[-1] // x.shape[-1]
        h = self.PReLU_0(h + x.repeat_interleave(rep, dim=-1))
        skips = [h]
        for i in range(4):
            skips.append(getattr(self, f"DownTransition_{i}")(skips[-1],
                                                              spatial))
        h = skips[4]
        for i in range(4):
            h = getattr(self, f"UpTransition_{i}")(h, skips[3 - i], spatial)
        return {"segmentation": self.outc(h)}
