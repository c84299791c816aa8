"""Channels-last depthwise 3³ convolution.

Counterpart of ``rsuper_tpu/ops/dwconv.py``. x is ``(B, D, H, W, C)`` and w
the flax depthwise kernel ``(3, 3, 3, 1, C)``. On CUDA tensors the function
launches the kernel of ``csrc/dwconv.cu`` for every C (the TPU gate
``dw_supported`` — C % 128 and a VMEM budget — does not apply); on CPU
tensors it runs the plain version: weights rounded to x's type, 27 shifted
multiply-adds in float32, output in x's type (the semantics of ``_dw_xla``).

The function is differentiable. On CUDA tensors a ``torch.autograd.Function``
runs the one kernel of ``csrc/dwconv_bwd.cu``, which writes dx and dw. The
backward follows ``_dw_xla`` as the forward does: the weights the stencil
sees are rounded to x's type, and the weight gradient is rounded to x's type
(by the kernel, as it writes dw) before it is cast to the parameter's (the
JAX package's Pallas path keeps both in float32). On CPU tensors autograd
differentiates the plain version; ``_dw_bwd_plain`` is what the backward
kernel is held against.

Both kernels take their tiling from ``_dw_plan`` and their staging from
``dw_route``: a forward call is one launch, a backward call one launch, and
nothing else runs on the device (the float32 weights are rounded inside the
kernels; scratch comes from ``torch.empty``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build, dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dw_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, D, H, W, C = x.shape
    w27 = w.to(x.dtype).float().reshape(27, C)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((B, D, H, W, C), dtype=torch.float32, device=x.device)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                acc += (xp[:, kd:kd + D, kh:kh + H, kw:kw + W]
                        * w27[(kd * 3 + kh) * 3 + kw])
    return acc.to(x.dtype)


def _dw_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx in x's type, dw (27, C) float32): dx[q] = Σ_k w[k]·dy[q−(k−1)]
    with w rounded to x's type, dw[k] = Σ_q x[q]·dy[q−(k−1)]; 27 shifted
    products in float32."""
    B, D, H, W, C = x.shape
    w27 = w.to(x.dtype).float().reshape(27, C)
    gp = F.pad(dy.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    x32 = x.float()
    dx = torch.zeros_like(x32)
    dw = []
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                # dy[q − (k − 1)] is the padded dy at offset 2 − k
                g = gp[:, 2 - kd:2 - kd + D, 2 - kh:2 - kh + H,
                       2 - kw:2 - kw + W]
                dx += g * w27[(kd * 3 + kh) * 3 + kw]
                dw.append((g * x32).sum(dim=(0, 1, 2, 3)))
    return dx.to(x.dtype), torch.stack(dw)


# The kernels' tiling (csrc/dwconv.cu, csrc/dwconv_bwd.cu read the same
# numbers): a thread owns SW consecutive W positions of one row; a block owns
# `rows` × `strips` such threads' outputs (one warp each) of one plane, a
# 128-byte chunk of channels and a run of depths.
SW = 6
LANES = 32  # one warp across a channel chunk
CHUNK_BYTES = 128
MAX_WARPS = 8  # 256 threads a block
MIN_BLOCKS = 132  # at least one block for every SM of an H100
DW_GROUP = 16  # the backward sums its dw partials in groups of this many
# depth runs are cut until the grid has this many blocks: forward, backward
# (two waves of two blocks an SM; the backward's runs each re-stage two halo
# planes of dy and add a row of dw partials, so one wave)
FILL_BLOCKS = (4 * 132, 2 * 132)
SMEM_BLOCK, SMEM_SM = 232448, 233472  # bytes a block may use, and an SM has
SMEM_RESERVED = 1024  # bytes the card keeps back for every resident block
# shared-memory rings (staged planes) and the kernels' register cap
# (__launch_bounds__: 256 threads at 2 blocks an SM)
FWD_RING, BWD_RING, BWD_X_RING = 3, 5, 3
REGS = 128


@dataclass(frozen=True)
class DwPlan:
    """Tiling of one depthwise call (forward, or backward when `backward`).
    Block i of the 1-D grid owns chunk i % n_chunks, then tile column, tile
    row, depth run and batch item in that order (``_dw_block``)."""
    backward: bool
    chunk: int  # channels of a block (128 bytes)
    rows: int  # tile rows (warps down H)
    strips: int  # tile columns of SW positions (warps across W)
    depth_run: int
    n_chunks: int
    tiles_h: int
    tiles_w: int
    runs: int
    blocks: int
    threads: int
    smem: int  # dynamic shared memory of a block, bytes
    blocks_per_sm: int

    @property
    def tile_w(self) -> int:
        return SW * self.strips

    @property
    def groups(self) -> int:
        """The backward's dw: blocks per chunk, and the groups of DW_GROUP
        of them whose partials the last block of each group sums."""
        per_chunk = self.blocks // self.n_chunks
        return per_chunk, _cdiv(per_chunk, DW_GROUP)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_cost(H: int, W: int, rows: int, strips: int) -> float:
    """Staged positions per output position: the halo's share over the
    share of the tile's threads that own a voxel of the plane."""
    tw = SW * strips
    halo = (rows + 2) * (tw + 2) / (rows * tw)
    used = H * W / (_cdiv(H, rows) * rows * _cdiv(W, tw) * tw)
    return halo / used


@functools.lru_cache(maxsize=None)
def _dw_plan(B: int, D: int, H: int, W: int, C: int, dtype: torch.dtype,
             backward: bool = False) -> DwPlan:
    """The tile, depth run and grid of one call. The tile (at most 8 warps)
    stages the fewest input positions per output; the depth is cut into runs
    until the grid has FILL_BLOCKS blocks (each run re-stages its two halo
    planes), and where runs of one depth still leave fewer than
    MIN_BLOCKS, the tile loses rows."""
    chunk = CHUNK_BYTES // dtype.itemsize
    n_chunks = _cdiv(C, chunk)
    cands = [(r, s) for r in range(1, min(H, MAX_WARPS) + 1)
             for s in range(1, min(_cdiv(W, SW), MAX_WARPS // r) + 1)]
    rows, strips = min(cands, key=lambda rs: (_tile_cost(H, W, *rs),
                                              -rs[0] * rs[1]))

    def grid(rows):
        tiles = (_cdiv(H, rows), _cdiv(W, SW * strips))
        base = B * n_chunks * tiles[0] * tiles[1]
        run = _cdiv(D, min(D, _cdiv(FILL_BLOCKS[int(backward)], base)))
        return tiles, run, base * _cdiv(D, run)

    tiles, run, blocks = grid(rows)
    while blocks < MIN_BLOCKS and rows > 1:
        rows -= 1
        tiles, run, blocks = grid(rows)
    tw = SW * strips
    halo_plane = (rows + 2) * (tw + 2) * CHUNK_BYTES
    if backward:
        smem = (BWD_RING * (halo_plane + 8) + BWD_X_RING * rows * tw * CHUNK_BYTES
                + 27 * CHUNK_BYTES + 27 * chunk * 4 + 128)  # + mbarriers,
        # weights, dw sums, alignment
    else:
        smem = FWD_RING * (halo_plane + 8) + 27 * chunk * 4 + 128  # + mbarriers,
        # weights, alignment
    threads = LANES * rows * strips
    per_sm = min(32, 2048 // threads, 65536 // (threads * REGS),
                 SMEM_SM // (smem + SMEM_RESERVED))
    return DwPlan(backward, chunk, rows, strips, run, n_chunks, tiles[0],
                  tiles[1], _cdiv(D, run), blocks, threads, smem, per_sm)


def _dw_block(plan: DwPlan, i: int):
    """(b, depths, rows, columns, channels) that block i of the grid owns,
    as ranges before clipping to the volume (as the kernels decompose
    blockIdx.x)."""
    chunk, i = i % plan.n_chunks, i // plan.n_chunks
    tw_i, i = i % plan.tiles_w, i // plan.tiles_w
    th_i, i = i % plan.tiles_h, i // plan.tiles_h
    run, b = i % plan.runs, i // plan.runs
    span = lambda i0, n: range(i0 * n, (i0 + 1) * n)  # noqa: E731
    return (b, span(run, plan.depth_run), span(th_i, plan.rows),
            span(tw_i, plan.tile_w), span(chunk, plan.chunk))


def dw_route(C: int, *tensors: torch.Tensor) -> str:
    """"wide" when C channels are a whole number of 16-byte copies and every
    pointer is 16-byte aligned: the kernels stage each plane by TMA copies;
    else "narrow": the same kernels stage and store element by element."""
    esize = tensors[0].element_size()
    ok = (C * esize) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return "wide" if ok else "narrow"


_FNS: dict = {}
_ARGTYPES = {
    "rsuper_dw3": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    "rsuper_dw3_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
    + [ctypes.c_void_p],
}


def _fn(source: str, name: str):
    """The C entry `name` of csrc/<source>.cu, its ctypes signature set once
    when the library loads."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(source), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


_COUNTERS: dict = {}


def _counter(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The backward kernel's arrival counters for a device and stream: zeros
    when allocated, and the kernel leaves them at zero."""
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _w27(w: torch.Tensor) -> torch.Tensor:
    """(27, C) float32 weights, a view of a float32 parameter."""
    return w.reshape(27, w.shape[-1]).float().contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, D, H, W, C = x.shape
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    wk = _w27(w)
    p = _dw_plan(B, D, H, W, C, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn("dwconv", "rsuper_dw3")(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, D, H, W, C,
        _DTYPE_CODES[x.dtype], int(dw_route(C, x, y) == "wide"), p.rows,
        p.strips, p.depth_run, x.device.index, stream)
    _build.check(err, "dwconv")
    return y


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                round_dw: bool = False):
    """dx and dw (27, C) float32 by the one kernel of csrc/dwconv_bwd.cu;
    with `round_dw`, dw's values are rounded to x's type."""
    B, D, H, W, C = x.shape
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty((27, C), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dw.zero_()
    wk = _w27(w)
    p = _dw_plan(B, D, H, W, C, x.dtype, backward=True)
    per_chunk, groups = p.groups
    partial = torch.empty((per_chunk + groups, 27, C), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counter = _counter(x.device, stream, p.n_chunks * (groups + 1))
    err = _fn("dwconv_bwd", "rsuper_dw3_bwd")(
        x.data_ptr(), wk.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), counter.data_ptr(), B, D, H, W, C,
        _DTYPE_CODES[x.dtype], int(dw_route(C, x, dy, dx) == "wide"),
        p.rows, p.strips, p.depth_run, int(round_dw), x.device.index, stream)
    _build.check(err, "dwconv_bwd")
    return dx, dw


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or tuple(w.shape) != (3, 3, 3, 1, x.shape[-1]):
        raise ValueError(f"x (B, D, H, W, C) and w (3, 3, 3, 1, C) expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")


def depthwise_conv3x3x3_bwd(x: torch.Tensor, w: torch.Tensor,
                            dy: torch.Tensor):
    """Backward of ``depthwise_conv3x3x3``: (dx in x's type, dw (27, C)
    float32) from dy (B, D, H, W, C) in x's type."""
    return _bwd(x, w, dy, False)


def _bwd(x, w, dy, round_dw: bool):
    """``depthwise_conv3x3x3_bwd``; with `round_dw` dw's values are rounded
    to x's type (the kernel does it as it writes dw)."""
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x, got {tuple(dy.shape)} {dy.dtype} "
                         f"for {tuple(x.shape)} {x.dtype}")
    if not dispatch.use_kernel(x, w, dy):
        dx, dw = _dw_bwd_plain(x, w, dy)
        return dx, (dw.to(x.dtype).float() if round_dw else dw)
    out = _launch_bwd(x, w, dy, round_dw)
    depthwise_conv3x3x3_bwd.launches += 1
    return out


class _DepthwiseConv3(torch.autograd.Function):
    """``depthwise_conv3x3x3`` on CUDA tensors: one forward kernel, one
    backward kernel that writes dx and the rounded dw."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = _launch(x, w)
        depthwise_conv3x3x3.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _bwd(x, w, dy.contiguous(), True)
        dw = dw.reshape(w.shape)
        if dw.dtype != w.dtype:
            dw = dw.to(w.dtype)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None)


def depthwise_conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3³ depthwise conv on (B, D, H, W, C); w (3, 3, 3, 1, C).
    Differentiable: autograd of the plain version on the CPU, the kernels on
    the card."""
    _check(x, w)
    if not dispatch.use_kernel(x, w):
        return _dw_plain(x, w)
    return _DepthwiseConv3.apply(x, w)


depthwise_conv3x3x3.launches = 0
depthwise_conv3x3x3_bwd.launches = 0
