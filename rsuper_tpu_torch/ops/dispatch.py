"""Kernel-or-plain dispatch, the counterpart of ``rsuper_tpu/ops/dispatch.py``.

The choice follows the operands' device alone: a tensor on the CPU takes the
plain PyTorch version; a CUDA tensor launches the hand-written kernel, and a
kernel that fails to build or launch raises — there is no fallback.
``plain_on_device()`` runs the plain versions on CUDA tensors; it exists so
that ``chip_smoke.py`` can hold each kernel against its plain version on the
card, and nothing on the serving path uses it.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_PLAIN_ON_DEVICE = False


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the operands must go through the CUDA kernel."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return not _PLAIN_ON_DEVICE


@contextmanager
def plain_on_device():
    """Run the plain PyTorch versions on CUDA tensors inside the block."""
    global _PLAIN_ON_DEVICE
    prev = _PLAIN_ON_DEVICE
    _PLAIN_ON_DEVICE = True
    try:
        yield
    finally:
        _PLAIN_ON_DEVICE = prev
