"""Ops with a hand-written CUDA kernel and a plain PyTorch version each, and
the plain tensor ops of the losses."""

from .balls import (ball_kernel, ball_kernel_wrapped, fft_ball_conv,
                    good_fft_size, odd_ceil)
from .gwrp import gwrp_pool, gwrp_weights
from .morphology import binary_union, dilate
from .selection import topn_mask, topn_threshold

__all__ = [
    "odd_ceil",
    "ball_kernel",
    "ball_kernel_wrapped",
    "fft_ball_conv",
    "good_fft_size",
    "dilate",
    "binary_union",
    "topn_mask",
    "topn_threshold",
    "gwrp_pool",
    "gwrp_weights",
]
