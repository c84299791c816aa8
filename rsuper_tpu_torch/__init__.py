"""PyTorch/CUDA port of ``rsuper_tpu`` for one NVIDIA H100.

Mirrors the JAX package's module names. Plain tensor code is PyTorch; the
kernels that the JAX package wrote in Pallas for the TPU are hand-written
CUDA sources under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``). A tensor on the CPU takes each kernel's plain PyTorch
version instead (``ops/dispatch.py``), which is how the tests run.

This package imports neither JAX nor anything of ``rsuper_tpu``.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
