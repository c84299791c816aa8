"""The reference's kernel signatures: a copy of what
``rsuper_tpu/ops/trace_shapes.py`` ``production_signatures()`` traces from the
JAX model (``collect_signatures`` of the default MedFormer, bf16, batch 1, at
96³ and at 128³, deduplicated in the order first seen): every Pallas call the
JAX package's training step makes, forward and backward. The JAX package
keys a signature on its TPU tiling as well; here each is the call's
operation, direction, fused prologue, shape and dtype, which is what the
port's kernels take. ``tests/test_torch_reference_shapes.py`` holds this
copy equal to the JAX package's trace; ``chip_smoke.py`` holds rows 1–6
against their plain versions at every one (``rows``).

A signature is ``(op, kind, fused, shape, dtype)``: ``op`` ``"conv_cf"``
with shape (B, D, C_in, H, W, C_out) or ``"dwconv"`` with (B, D, H, W, C);
``kind`` ``"fwd"``, ``"wgrad"`` (conv) or ``"bwd"`` (depthwise). A conv's
dgrad is a forward call on the flipped weights, with C_in and C_out of the
gradient, as the port's dgrad is.
"""

from __future__ import annotations

from typing import List, Tuple

SIGNATURES = (
    ('conv_cf', 'fwd', False, (1, 96, 1, 96, 96, 32), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 96, 32, 96, 96, 32), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 48, 48, 48, 256), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 48, 64, 48, 48, 64), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 24, 24, 24, 512), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 24, 24, 24, 128), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 12, 12, 12, 1024), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 12, 12, 12, 256), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 6, 6, 6, 2048), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 6, 6, 6, 1280), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 24, 24, 24, 384), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 48, 64, 48, 48, 128), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 96, 48, 96, 96, 64), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 96, 32, 96, 96, 32), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 96, 32, 96, 96, 32), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 96, 32, 96, 96, 96), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 96, 48, 96, 96, 64), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 48, 64, 48, 48, 64), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 48, 64, 48, 48, 64), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 48, 64, 48, 48, 192), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 48, 64, 48, 48, 128), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 24, 24, 24, 512), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 24, 24, 24, 128), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 24, 24, 24, 384), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 12, 12, 12, 1024), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 12, 12, 12, 256), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 6, 6, 6, 1280), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 6, 6, 6, 2048), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 48, 48, 48, 256), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 96, 32, 96, 96, 1), 'bfloat16'),
    ('conv_cf', 'wgrad', False, (1, 96, 1, 96, 96, 32), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 128, 1, 128, 128, 32), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 128, 32, 128, 128, 32), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 64, 64, 64, 256), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 64, 64, 64, 64, 64), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 32, 32, 32, 512), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 32, 32, 32, 128), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 16, 16, 16, 1024), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 16, 16, 16, 256), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 8, 8, 8, 2048), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 8, 8, 8, 1280), 'bfloat16'),
    ('dwconv', 'fwd', False, (1, 32, 32, 32, 384), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 64, 64, 64, 64, 128), 'bfloat16'),
    ('conv_cf', 'fwd', True, (1, 128, 48, 128, 128, 64), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 128, 32, 128, 128, 32), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 128, 32, 128, 128, 32), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 128, 64, 128, 128, 96), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 128, 48, 128, 128, 64), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 64, 64, 64, 64, 64), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 64, 64, 64, 64, 64), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 64, 64, 64, 64, 192), 'bfloat16'),
    ('conv_cf', 'wgrad', True, (1, 64, 64, 64, 64, 128), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 32, 32, 32, 512), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 32, 32, 32, 128), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 32, 32, 32, 384), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 16, 16, 16, 1024), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 16, 16, 16, 256), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 8, 8, 8, 1280), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 8, 8, 8, 2048), 'bfloat16'),
    ('dwconv', 'bwd', False, (1, 64, 64, 64, 256), 'bfloat16'),
    ('conv_cf', 'fwd', False, (1, 128, 32, 128, 128, 1), 'bfloat16'),
    ('conv_cf', 'wgrad', False, (1, 128, 1, 128, 128, 32), 'bfloat16'),
)

# (op, kind, fused) → the kernel row of PERF.md §6 that the port runs there
_ROWS = {
    ("conv_cf", "fwd", False): "conv3x3x3_cf",
    ("conv_cf", "fwd", True): "in_relu_conv3x3x3_cf",
    ("conv_cf", "wgrad", False): "conv3x3x3_cf_wgrad",
    ("conv_cf", "wgrad", True): "in_relu_conv3x3x3_cf_wgrad",
    ("dwconv", "fwd", False): "depthwise_conv3x3x3",
    ("dwconv", "bwd", False): "depthwise_conv3x3x3_bwd",
}


def rows() -> List[Tuple[str, tuple, str]]:
    """(kernel row, shape, dtype) of every signature, in order."""
    return [(_ROWS[op, kind, fused], shape, dtype)
            for op, kind, fused, shape, dtype in SIGNATURES]
