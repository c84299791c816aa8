"""What surrounds the conv kernels' routes, on the CPU.

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``, ``-m cuda``). What the wrapper of
``rsuper_tpu_torch/ops/conv_cf.py`` decides before a launch is plain Python
and is held here: the route each production shape takes, the bf16 weight
layout the tensor-core kernel reads (against a numpy re-layout of the
weights rounded to bf16), and the wgrad kernel's number of spatial splits.
The stem's own route (bf16, C_in = 1) is held in ``tests/test_torch_stem.py``.
"""

import numpy as np
import pytest
import torch

from rsuper_tpu_torch.ops import conv_cf

BF16, F32 = torch.bfloat16, torch.float32
# the production shapes, (B, D, C_in, H, W, C_out): the serving forward at
# window batches of 8, the training step's dgrad (C_in = channels of dy) and
# wgrad at one 96³ patch, and the stem
FORWARD = [(8, 96, 32, 96, 96, 32), (8, 96, 96, 96, 96, 64),
           (8, 48, 64, 48, 48, 64), (8, 48, 192, 48, 48, 128)]
DGRAD = [(1, 96, 32, 96, 96, 32), (1, 96, 64, 96, 96, 96),
         (1, 48, 64, 48, 48, 64), (1, 48, 128, 48, 48, 192),
         (2, 48, 64, 48, 48, 64)]
WGRAD = [(1, 96, 32, 96, 96, 32), (1, 96, 96, 96, 96, 64),
         (1, 48, 64, 48, 48, 64), (1, 48, 192, 48, 48, 128),
         (2, 48, 64, 48, 48, 64)]
STEM = [(8, 96, 1, 96, 96, 32), (1, 96, 1, 96, 96, 32)]


@pytest.mark.parametrize("shape", FORWARD + DGRAD + WGRAD, ids=str)
def test_production_shapes_take_the_tensor_cores_in_bf16(shape):
    c_in = shape[2]
    assert conv_cf.conv_route(BF16, c_in) == "tensor_core"
    assert conv_cf.conv_route(F32, c_in) == "cuda_core"


@pytest.mark.parametrize("shape", STEM, ids=str)
def test_the_stem_stays_on_the_cuda_cores(shape):
    """In float32 the stem stays on the CUDA cores; in bf16 it takes its
    own tensor-core route, the 27 taps as one K = 32 contraction."""
    assert conv_cf.conv_route(F32, shape[2]) == "cuda_core"
    assert conv_cf.conv_route(BF16, shape[2]) == "stem"


def test_the_route_turns_at_one_k16_step():
    assert conv_cf.conv_route(BF16, 2) == "cuda_core"
    assert conv_cf.conv_route(BF16, 15) == "cuda_core"
    assert conv_cf.conv_route(BF16, 16) == "tensor_core"
    assert conv_cf.conv_route(torch.float16, 64) == "cuda_core"


def _weights(ci, co, seed):
    a = np.random.default_rng(seed).normal(size=(3, 3, 3, ci, co))
    return torch.from_numpy(a.astype(np.float32))


@pytest.mark.parametrize("flip", [False, True], ids=["w", "flipped"])
@pytest.mark.parametrize("ci,co", [(32, 32), (96, 64), (192, 128), (16, 24),
                                   (40, 70), (5, 3)])
def test_weight_repack_is_a_relayout_of_the_bf16_weights(ci, co, flip):
    """(27, C_in↑16, C_out↑8) bf16, taps in (kd, kh, kw) order, zeros in
    the padding; the dgrad's flipped view (taps reversed, C_in and C_out
    swapped) packs to the numpy re-layout of the same rounded weights."""
    w = _weights(ci, co, ci * 1000 + co)
    wb = w.to(BF16).float().numpy()
    if flip:
        src = conv_cf._flip_w(w)
        want = wb[::-1, ::-1, ::-1].transpose(0, 1, 2, 4, 3)
    else:
        src, want = w, wb
    a, b = want.shape[3:]
    pad = np.zeros((27, -(-a // 16) * 16, -(-b // 8) * 8), np.float32)
    pad[:, :a, :b] = want.reshape(27, a, b)
    got = conv_cf._pack_w(src, BF16, "tensor_core")
    assert got.dtype == BF16 and got.is_contiguous()
    assert tuple(got.shape) == pad.shape
    np.testing.assert_array_equal(got.float().numpy(), pad)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
def test_cuda_core_weights_are_as_before(dtype):
    """The CUDA-core route reads (27, C_in, C_out) float32 weights rounded
    to the input's type, as it always did."""
    w = _weights(7, 70, 3)
    got = conv_cf._pack_w(conv_cf._flip_w(w), dtype, "cuda_core")
    want = w.to(dtype).float().flip(0, 1, 2).transpose(3, 4).reshape(27, 70, 7)
    assert got.dtype == F32 and got.is_contiguous()
    assert torch.equal(got, want)


PARTIAL_BYTES = 16 * 2 ** 20  # the tensor-core wgrad's partial sums, at most


@pytest.mark.parametrize("shape", WGRAD + [(1, 3, 16, 17, 33, 24),
                                           (2, 2, 24, 10, 18, 120)],
                         ids=str)
def test_wgrad_splits_of_the_tensor_core_tile(shape):
    """Positive, at most one split per 8×16 output tile, one wave of two
    blocks on each of the 132 SMs, and partial sums under 16 MiB."""
    B, D, Ci, H, W, Co = shape
    S = conv_cf._wgrad_splits(B, D, Ci, Co, H, W, "tensor_core")
    tiles = B * D * -(-H // 8) * -(-W // 16)
    pairs = -(-Ci // 16) * -(-Co // 32)
    assert 1 <= S <= tiles
    assert S == 1 or S * pairs <= 2 * conv_cf.SMS
    assert S * 27 * Ci * Co * 4 <= PARTIAL_BYTES


def test_wgrad_splits_at_the_training_step():
    split = conv_cf._wgrad_splits
    assert split(1, 96, 32, 32, 96, 96, "tensor_core") == 132
    assert split(1, 96, 96, 64, 96, 96, "tensor_core") == 22
    assert split(1, 48, 192, 128, 48, 48, "tensor_core") == 5
    assert split(1, 1, 16, 24, 8, 16, "tensor_core") == 1  # one tile
