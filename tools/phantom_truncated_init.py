#!/usr/bin/env python
"""The port's phantom study with flax's LeCun-normal initialisation, to set
beside the port's own (``python -m rsuper_tpu_torch.phantom_benchmark``).

    python tools/phantom_truncated_init.py [phantom_benchmark flags ...]

``rsuper_tpu_torch.models.init_params`` draws every LeCun kernel from an
untruncated normal of variance 1/fan_in; flax's ``lecun_normal`` (the JAX
package's default kernel initialiser) draws from a normal truncated at two
of its standard deviations, the standard deviation raised by 1/0.87962566
so that the variance stays 1/fan_in. This runs the study unchanged but for
that draw: the same seeds give the same phantoms, augmentation draws and
arms; the kernels come from a generator of the same seed. The other
parameters are set as ``init_params`` sets them.
"""

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import rsuper_tpu_torch.models as models  # noqa: E402
from rsuper_tpu_torch import phantom_benchmark  # noqa: E402
from rsuper_tpu_torch.models import params  # noqa: E402

TRUNCATED_STD = 0.87962566103423978  # std of a unit normal cut at ±2


def lecun_truncated(shape, fan_in: int, gen) -> torch.Tensor:
    std = 1.0 / math.sqrt(fan_in) / TRUNCATED_STD
    out = torch.empty(shape)
    torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                                generator=gen)
    return out


@torch.no_grad()
def init_params(model, seed: int = 0):
    """``init_params``, then its LeCun kernels drawn again, truncated."""
    params.init_params(model, seed)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = (model.get_submodule(name.rsplit(".", 1)[0]) if "." in name
                 else model)
        if (leaf in ("bias", "gamma", "alpha", "rel_bias", "pos_embed", "pos")
                or type(owner).__name__ == "LayerNorm"):
            continue  # init_params' values
        if leaf == "kernel":
            fan_in = math.prod(p.shape[:-1])
        elif isinstance(owner, params.ConvTranspose):
            fan_in = p.shape[0] * math.prod(p.shape[2:])
        else:
            fan_in = math.prod(p.shape[1:])
        p.copy_(lecun_truncated(p.shape, fan_in, gen).to(p.device))
    return model


def main(argv=None):
    models.init_params = init_params
    return phantom_benchmark.main(argv)


if __name__ == "__main__":
    main()
