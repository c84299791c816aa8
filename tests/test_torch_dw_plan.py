"""What the depthwise kernels' wrapper decides before a launch, on the CPU.

The kernels of ``csrc/dwconv.cu`` and ``csrc/dwconv_bwd.cu`` run only on the
card (``tests/test_torch_kernels_cuda.py``, ``-m cuda``). Their grid, tile,
depth run and shared memory come from ``ops/dwconv.py:_dw_plan`` and their
staging from ``dw_route``; both are plain Python and are held here, at the
production shapes of ``chip_smoke.py`` and at ragged ones: every output
voxel and channel owned by exactly one block, shared memory within the
H100's 227 KB a block at the plan's blocks per SM, at least one block per SM
at the production shapes, and the narrow staging where C or a pointer does
not allow 16-byte copies.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from rsuper_tpu_torch.ops import dwconv  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
PRODUCTION = sorted(set(chip_smoke.DW_FWD_SHAPES + chip_smoke.DW_BWD_SHAPES))
# (B, D, H, W, C): one-deep volumes, H and W that are not multiples of any
# tile, channel counts that leave a partial chunk (3, 20, 320 in float32)
RAGGED = [(1, 1, 1, 1, 3), (1, 1, 7, 5, 20), (2, 3, 5, 7, 3),
          (1, 5, 20, 37, 320), (2, 2, 9, 13, 20), (1, 7, 17, 11, 96),
          (3, 1, 49, 50, 8)]
SM_COUNT = 132


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _owners(shape, plan):
    """How many blocks own each (b, d, h, w, channel chunk) output, and in
    how many blocks each channel lies, walking the grid as the kernels do."""
    B, D, H, W, C = shape
    count = np.zeros((B, D, H, W, plan.n_chunks), np.int32)
    chans = np.zeros(plan.n_chunks * plan.chunk, np.int32)
    for i in range(plan.blocks):
        b, ds, hs, ws, cs = dwconv._dw_block(plan, i)
        assert b < B
        count[b, ds.start:min(ds.stop, D), hs.start:min(hs.stop, H),
              ws.start:min(ws.stop, W), cs.start // plan.chunk] += 1
        chans[cs.start:cs.stop] += 1
    return count, chans


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("shape", PRODUCTION + RAGGED,
                         ids=_ids(PRODUCTION + RAGGED))
def test_plan_covers_every_output_once_and_fits_the_card(shape, dtype,
                                                         backward):
    B, D, H, W, C = shape
    plan = dwconv._dw_plan(B, D, H, W, C, dtype, backward)
    assert plan.chunk * dtype.itemsize == 128
    assert plan.n_chunks == -(-C // plan.chunk)
    assert plan.blocks == (plan.n_chunks * plan.tiles_h * plan.tiles_w
                           * plan.runs * B)
    assert plan.tiles_h * plan.rows >= H > (plan.tiles_h - 1) * plan.rows
    assert plan.tiles_w * plan.tile_w >= W > (plan.tiles_w - 1) * plan.tile_w
    assert plan.runs * plan.depth_run >= D > (plan.runs - 1) * plan.depth_run
    count, chans = _owners(shape, plan)
    assert (count == 1).all()
    # each channel (C and past it) lies in one chunk: every block of that
    # chunk owns it, one block for each tile, depth run and item
    assert (chans == plan.blocks // plan.n_chunks).all()
    # one warp a (row, strip); the kernels take at most 256 threads
    assert plan.threads == 32 * plan.rows * plan.strips <= 256
    # shared memory: within a block's limit, and at the plan's blocks per SM
    # within the SM's (1 KB kept back for each resident block)
    assert plan.smem <= dwconv.SMEM_BLOCK == 227 * 1024
    assert plan.blocks_per_sm >= 1
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 228 * 1024
    assert plan.blocks_per_sm * plan.threads <= 2048
    assert plan.blocks_per_sm * plan.threads * dwconv.REGS <= 65536
    # the backward's partial sums: one (27, C) row per block of a chunk
    assert plan.blocks % plan.n_chunks == 0


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("shape", PRODUCTION, ids=_ids(PRODUCTION))
def test_production_shapes_fill_the_card(shape, dtype, backward):
    plan = dwconv._dw_plan(*shape, dtype, backward)
    assert plan.blocks >= SM_COUNT


def test_the_big_planes_take_eight_rows_and_the_small_the_whole_plane():
    """48² and 24² planes: 8 × 6 tiles (the fewest staged positions per
    output with 8 warps); 12²: 4 × 12; 6²: the whole plane, 6 × 6."""
    for edge, (rows, strips) in ((48, (8, 1)), (24, (8, 1)), (12, (4, 2)),
                                 (6, (6, 1))):
        plan = dwconv._dw_plan(8, edge, edge, edge, 256, BF16)
        assert (plan.rows, plan.strips) == (rows, strips)
    # the serving forward's largest shape walks the whole depth in one run
    assert dwconv._dw_plan(8, 48, 48, 48, 256, BF16).depth_run == 48


def _aligned(shape, dtype, offset=0):
    """A tensor of `shape` starting `offset` elements into a fresh buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset + 64, dtype=dtype)
    base = (-buf.data_ptr() // dtype.itemsize) % (16 // dtype.itemsize)
    t = buf[base + offset:base + offset + n].view(shape)
    assert (t.data_ptr() % 16 == 0) == (offset * dtype.itemsize % 16 == 0)
    return t


@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("C", [256, 320, 384, 512, 576, 1024, 1280, 2048])
def test_production_channels_take_the_wide_staging(C, dtype):
    x = _aligned((1, 2, 3, 4, C), dtype)
    y = _aligned((1, 2, 3, 4, C), dtype)
    assert dwconv.dw_route(C, x, y) == "wide"


@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("C", [1, 3, 5, 21, 321])
def test_odd_channels_take_the_narrow_staging(C, dtype):
    x = _aligned((1, 2, 3, 4, C), dtype)
    assert dwconv.dw_route(C, x, x) == "narrow"


def test_the_route_follows_the_bytes_of_a_channel_row():
    # 20 channels are 40 bytes in bf16 (narrow) and 80 in float32 (wide)
    assert dwconv.dw_route(20, _aligned((2, 20), BF16)) == "narrow"
    assert dwconv.dw_route(20, _aligned((2, 20), F32)) == "wide"
    assert dwconv.dw_route(8, _aligned((2, 8), BF16)) == "wide"
    assert dwconv.dw_route(4, _aligned((2, 4), BF16)) == "narrow"


@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("which", [0, 1, 2])
def test_a_misaligned_pointer_takes_the_narrow_staging(dtype, which):
    """Any one operand that starts off a 16-byte boundary (the backward
    checks x, dy and dx)."""
    ts = [_aligned((1, 2, 3, 4, 64), dtype) for _ in range(3)]
    ts[which] = _aligned((1, 2, 3, 4, 64), dtype, offset=1)
    assert dwconv.dw_route(64, *ts) == "narrow"
    assert dwconv.dw_route(64, *[t for i, t in enumerate(ts)
                                 if i != which]) == "wide"
