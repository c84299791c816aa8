"""Channel-first 3³ convolution, plain and with a fused IN+ReLU prologue.

Counterpart of ``rsuper_tpu/ops/conv_cf.py``. Operands are depth-major
channel-first ``(B, D, C, H, W)``; weights are the flax layout
``(3, 3, 3, C_in, C_out)``. On CUDA tensors both functions launch the kernel
of ``csrc/conv_cf.cu``; on CPU tensors they run the plain versions, which
follow the JAX package's XLA fallbacks (``_conv3_cf_xla``,
``_in_relu_conv_xla``): weights rounded to the input's type, float32
compute, output in the input's type.

Both are differentiable. On CUDA tensors a ``torch.autograd.Function`` runs
the backward through kernels as the JAX package's custom VJPs do: the input
gradient is the forward kernel on flipped weights (``conv3x3x3_cf_dgrad``),
the weight gradient the kernel of ``csrc/conv_cf_wgrad.cu``
(``conv3x3x3_cf_wgrad``, ``in_relu_conv3x3x3_cf_wgrad``). On CPU tensors
autograd differentiates the plain versions; ``_wgrad_plain``,
``_dgrad_plain`` and ``_in_relu_bwd`` are the plain versions the backward
kernels are held against. Every wrapper counts its launches.

Each kernel has three routes, chosen by ``conv_route`` from the operands'
type and C_in alone: bf16 with C_in ≥ 16 runs on the tensor cores (an
implicit GEMM on ``mma.sync``, bf16 operands, float32 sums); the bf16 stem,
C_in = 1, on the tensor cores too, with its 27 taps as one K = 32
contraction (the JAX package's form "f": a (C_out, 32) × (32, positions)
product a tile row, forward and weight gradient each one launch a call,
blocks marching in depth through a ring of staged input planes); float32
and bf16 with 2 ≤ C_in ≤ 15 on the CUDA cores in float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, dispatch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"cuda_core": 0, "tensor_core": 1, "stem": 2}
SMS = 132  # streaming multiprocessors of an H100 SXM
# the stem route's grids: a block owns STEM_TILE outputs (rows, columns) of
# one depth row at a time and STEM_CO output channels. The forward's blocks
# march through runs of depths, cut until the grid has STEM_FWD_FILL blocks;
# the weight gradient's STEM_WGRAD_FILL blocks (one wave of two an SM) each
# take an equal share of the tiles
STEM_TILE = (8, 32)
STEM_CO = 32
STEM_FWD_FILL = 8 * SMS
STEM_WGRAD_FILL = 2 * SMS
STEM_GROUP = 16  # wgrad partials summed a group at a time: GROUP in csrc/conv_cf_wgrad.cu


def conv_route(dtype: torch.dtype, c_in: int) -> str:
    """The kernel route of a conv, dgrad or wgrad whose input has `c_in`
    channels: ``"tensor_core"`` for bf16 with C_in ≥ 16 (one k16 step of the
    MMA a tap), ``"stem"`` for bf16 with C_in = 1 (all 27 taps in one K = 32
    contraction, two k16 steps), else ``"cuda_core"``. float32 stays off the tensor cores,
    where it would be TF32 (about three digits). C_out does not enter: its
    tail is padded."""
    if dtype == torch.bfloat16 and c_in == 1:
        return "stem"
    return ("tensor_core" if dtype == torch.bfloat16 and c_in >= 16
            else "cuda_core")


def _stem_tiles(B: int, H: int, W: int) -> int:
    """Columns of stem tiles: (batch, tile row, tile column)."""
    th, tw = STEM_TILE
    return B * -(-H // th) * -(-W // tw)


def _stem_fwd_run(B: int, D: int, Co: int, H: int, W: int) -> int:
    """Depths a block of the stem forward marches through: the runs are cut
    until the grid (columns × C_out tiles × runs) has STEM_FWD_FILL blocks,
    never below one depth; the kernel recomputes the grid from the run."""
    columns = _stem_tiles(B, H, W) * -(-Co // STEM_CO)
    runs = min(D, max(1, -(-STEM_FWD_FILL // columns)))
    return -(-D // runs)


def _stem_wgrad_splits(B: int, D: int, H: int, W: int) -> int:
    """Blocks of the stem weight gradient a C_out tile: STEM_WGRAD_FILL, or
    one a tile (one depth row of one column) where there are fewer. Each
    writes a (27, C_out) float32 partial; the kernel sums them in
    ceil(S / STEM_GROUP) groups."""
    return max(1, min(_stem_tiles(B, H, W) * D, STEM_WGRAD_FILL))


def _pack_w(w: torch.Tensor, dtype: torch.dtype, route: str) -> torch.Tensor:
    """Weights (3, 3, 3, C_in, C_out), or a flipped view of them, as the
    kernel of `route` reads them. CUDA cores: (27, C_in, C_out) float32
    rounded to `dtype`. Tensor cores: (27, C_in↑16, C_out↑8) bf16, C_in
    padded to a multiple of 16 and C_out of 8 with zeros, so that every
    staged weight row is whole 16-byte pieces. One copy kernel (and a fill
    where there is padding). The stem: (27, C_out) bf16, the transpose of
    the JAX package's ``_prep_w_f`` (taps in (kd, kh, kw) order), one copy
    kernel; the kernel pads K to 32 and C_out to its tile with zeros as it
    loads the weights into its registers."""
    Ci, Co = w.shape[3], w.shape[4]
    if route == "cuda_core":
        return w.to(dtype).float().reshape(27, Ci, Co).contiguous()
    if route == "stem":
        wk = torch.empty((27, Co), dtype=torch.bfloat16, device=w.device)
        wk.view(3, 3, 3, 1, Co).copy_(w)  # strided views too
        return wk
    Cip, Cop = -(-Ci // 16) * 16, -(-Co // 8) * 8
    new = torch.empty if (Cip, Cop) == (Ci, Co) else torch.zeros
    wk = new((27, Cip, Cop), dtype=torch.bfloat16, device=w.device)
    wk.view(3, 3, 3, Cip, Cop)[..., :Ci, :Co].copy_(w)  # strided views too
    return wk


def _in_stats_cf(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Instance-norm stats of (B, D, C, H, W) x as (B, 2, C, 1) float32:
    [:, 0] = 1/σ and [:, 1] = −μ/σ. One-pass E[x²] − E[x]², clamped at 0,
    as ``rsuper_tpu/ops/conv_cf.py:_in_stats_cf``."""
    n = x.shape[1] * x.shape[3] * x.shape[4]
    s1 = torch.sum(x, dim=(1, 3, 4), dtype=torch.float32)
    s2 = torch.sum(x * x, dim=(1, 3, 4), dtype=torch.float32)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return torch.stack([inv, -mean * inv], dim=1)[..., None]


def _conv3_cf_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3³ conv in float32 on the rounded operands, output in x's type."""
    wt = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # (Co, Ci, 3, 3, 3)
    y = F.conv3d(x.float().permute(0, 2, 1, 3, 4), wt, padding=1)
    return y.permute(0, 2, 1, 3, 4).to(x.dtype).contiguous()


def _in_relu_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """IN → ReLU → SAME conv; the activation is rounded to x's type first."""
    stats = _in_stats_cf(x, eps)
    scale = stats[:, 0, :, 0][:, None, :, None, None]
    shift = stats[:, 1, :, 0][:, None, :, None, None]
    a = torch.clamp(x.float() * scale + shift, min=0.0).to(x.dtype)
    return _conv3_cf_plain(a, w)


def _wgrad_plain(x: torch.Tensor, dy: torch.Tensor, stats=None) -> torch.Tensor:
    """dw (3, 3, 3, C_in, C_out) float32 of the SAME 3³ conv: the sum over
    b, d, h, w of dy[b, d, co, h, w] · a[b, d+kd−1, ci, h+kh−1, w+kw−1], with
    a = x or, with `stats`, a = relu(x·scale+shift) rounded to x's type; a is
    0 outside the volume. 27 shifted products, float32."""
    B, D, Ci, H, W = x.shape
    a = x.float()
    if stats is not None:
        st = stats.reshape(B, 2, Ci)
        a = torch.clamp(a * st[:, 0, None, :, None, None]
                        + st[:, 1, None, :, None, None], min=0.0)
        a = a.to(x.dtype).float()
    ap = F.pad(a, (1, 1, 1, 1, 0, 0, 1, 1))
    g = dy.float()
    taps = [torch.einsum("bdihw,bdohw->io",
                         ap[:, kd:kd + D, :, kh:kh + H, kw:kw + W], g)
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, Ci, dy.shape[2])


def _flip_w(w: torch.Tensor) -> torch.Tensor:
    """Weights of the transposed conv: taps flipped, C_in and C_out swapped."""
    return w.flip(0, 1, 2).transpose(3, 4)


def _dgrad_plain(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx (or the gradient at the normalised activation): the SAME conv of
    dy with the flipped weights, in dy's type."""
    return _conv3_cf_plain(dy, _flip_w(w))


def _in_relu_bwd(x: torch.Tensor, stats: torch.Tensor,
                 da: torch.Tensor) -> torch.Tensor:
    """ReLU + instance-norm backward in closed form (the JAX package's
    ``_in_relu_conv_bwd_xla``): dx = scale·(g − E[g] − x̂·E[g·x̂]) with
    g = da·1[x̂ > 0], float32, output in x's type. Plain PyTorch on every
    device: it stands outside the kernels in the JAX package too."""
    scale = stats[:, 0, :, 0][:, None, :, None, None]
    shift = stats[:, 1, :, 0][:, None, :, None, None]
    xh = x.float() * scale + shift
    g = da.float() * (xh > 0)
    m1 = g.mean(dim=(1, 3, 4), keepdim=True)
    m2 = (g * xh).mean(dim=(1, 3, 4), keepdim=True)
    return (scale * (g - m1 - xh * m2)).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if w.shape[:3] != (3, 3, 3) or w.dim() != 5 or w.shape[3] != x.shape[2]:
        raise ValueError(f"w must be (3, 3, 3, {x.shape[2]}, Co), got "
                         f"{tuple(w.shape)}")


def _launch(x: torch.Tensor, w: torch.Tensor, stats) -> torch.Tensor:
    """Run csrc/conv_cf.cu on CUDA tensors; allocates the output."""
    B, D, Ci, H, W = x.shape
    Co = w.shape[-1]
    x = x.contiguous()
    route = conv_route(x.dtype, Ci)
    wk = _pack_w(w, x.dtype, route)
    st = None if stats is None else stats.reshape(B, 2, Ci).contiguous()
    y = torch.empty((B, D, Co, H, W), dtype=x.dtype, device=x.device)
    run = _stem_fwd_run(B, D, Co, H, W) if route == "stem" else 0
    lib = _build.load("conv_cf")
    fn = lib.rsuper_conv3_cf
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), wk.data_ptr(), None if st is None else st.data_ptr(),
             y.data_ptr(), B, D, Ci, Co, H, W, run, _DTYPE_CODES[x.dtype],
             _ROUTE_CODES[route], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv_cf")
    return y


def _wgrad_splits(B: int, D: int, Ci: int, Co: int, H: int, W: int,
                  route: str) -> int:
    """Number of spatial splits of the wgrad kernel's grid, at most one per
    output tile. Each split costs one (27, C_in, C_out) float32 partial.
    Tensor cores: 8×16 tiles and (16 C_in × 32 C_out) channel tiles; the
    grid is one wave of two blocks on each SM (S × channel tiles ≤ 264), so
    the partials hold at most 264 × 27 × 16 × 32 floats (14.6 MB). CUDA
    cores: 4×16 tiles, about four blocks an SM."""
    if route == "tensor_core":
        tiles = B * D * -(-H // 8) * -(-W // 16)
        pairs = -(-Ci // 16) * -(-Co // 32)
        return max(1, min(tiles, 2 * SMS // pairs))
    tiles = B * D * -(-H // 4) * -(-W // 16)
    pairs = -(-Ci // (4 if Ci <= 4 else 16)) * -(-Co // 32)
    return max(1, min(tiles, -(-4 * SMS // pairs)))


_STEM_WORK: dict = {}


def _stem_work(dev: torch.device, stream: int, n_partial: int,
               n_counter: int):
    """The stem wgrad's partial sums and arrival counters for a device and
    stream, kept and grown, not allocated at every call: the counters are
    zeros when allocated, and the kernel leaves them at zero."""
    key = (dev.index, stream)
    partial, counter = _STEM_WORK.get(key, (None, None))
    if partial is None or partial.numel() < n_partial:
        partial = torch.empty(n_partial, dtype=torch.float32, device=dev)
    if counter is None or counter.numel() < n_counter:
        counter = torch.zeros(max(n_counter, 1024), dtype=torch.int32,
                              device=dev)
    _STEM_WORK[key] = partial, counter
    return partial, counter


def _launch_wgrad(x: torch.Tensor, dy: torch.Tensor, stats) -> torch.Tensor:
    """Run csrc/conv_cf_wgrad.cu on CUDA tensors; allocates dw, and the
    partial sums on the routes that sum them in a second kernel (the stem's
    are kept by `_stem_work`)."""
    B, D, Ci, H, W = x.shape
    Co = dy.shape[2]
    x, dy = x.contiguous(), dy.contiguous()
    st = None if stats is None else stats.reshape(B, 2, Ci).contiguous()
    route = conv_route(x.dtype, Ci)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counter = None
    if route == "stem":
        S = _stem_wgrad_splits(B, D, H, W)
        groups = -(-S // STEM_GROUP)
        partial, counter = _stem_work(x.device, stream, (S + groups) * 27 * Co,
                                      -(-Co // STEM_CO) * (groups + 1))
    else:
        S = _wgrad_splits(B, D, Ci, Co, H, W, route)
        partial = torch.empty((S, 27, Ci, Co), dtype=torch.float32,
                              device=x.device)
    dw = torch.empty((3, 3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    lib = _build.load("conv_cf_wgrad")
    fn = lib.rsuper_conv3_cf_wgrad
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), dy.data_ptr(), None if st is None else st.data_ptr(),
             partial.data_ptr(), None if counter is None else counter.data_ptr(),
             dw.data_ptr(), B, D, Ci, Co, H, W, S,
             _DTYPE_CODES[x.dtype], _ROUTE_CODES[route], stream)
    _build.check(err, "conv_cf_wgrad")
    return dw


def _check_dy(x: torch.Tensor, dy: torch.Tensor) -> None:
    if (dy.dim() != 5 or dy.dtype != x.dtype or dy.shape[:2] != x.shape[:2]
            or dy.shape[3:] != x.shape[3:]):
        raise ValueError(f"dy must be (B, D, Co, H, W) in x's type, got "
                         f"{tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")


def conv3x3x3_cf_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the SAME 3³ conv: dy (B, D, C_out, H, W),
    w (3, 3, 3, C_in, C_out) → (B, D, C_in, H, W) in dy's type. As in the JAX
    package this is the forward kernel on flipped weights (rounded to dy's
    type), prologue off."""
    wf = _flip_w(w)
    _check(dy, wf)
    if not dispatch.use_kernel(dy, w):
        return _dgrad_plain(dy, w)
    dx = _launch(dy, wf, None)
    conv3x3x3_cf_dgrad.launches += 1
    return dx


def conv3x3x3_cf_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``conv3x3x3_cf``: (3, 3, 3, C_in, C_out) float32."""
    _check_dy(x, dy)
    if not dispatch.use_kernel(x, dy):
        return _wgrad_plain(x, dy)
    dw = _launch_wgrad(x, dy, None)
    conv3x3x3_cf_wgrad.launches += 1
    return dw


def in_relu_conv3x3x3_cf_wgrad(x: torch.Tensor, dy: torch.Tensor,
                               stats: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``in_relu_conv3x3x3_cf``: the activation
    relu(x·scale+shift), rounded to x's type, is rebuilt from `stats`
    (B, 2, C_in, 1) as the kernel stages x, and never stored."""
    _check_dy(x, dy)
    if not dispatch.use_kernel(x, dy, stats):
        return _wgrad_plain(x, dy, stats)
    dw = _launch_wgrad(x, dy, stats)
    in_relu_conv3x3x3_cf_wgrad.launches += 1
    return dw


def _round_dw(dw: torch.Tensor, x: torch.Tensor, w: torch.Tensor):
    """The weight gradient as the JAX package hands it on: rounded to the
    compute type (the conv saw w in x's type), then cast to w's type."""
    return dw.to(x.dtype).to(w.dtype)


class _Conv3CF(torch.autograd.Function):
    """``conv3x3x3_cf`` on CUDA tensors: forward, dgrad and wgrad kernels."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = _launch(x, w, None)
        conv3x3x3_cf.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv3x3x3_cf_dgrad(dy, w) if ctx.needs_input_grad[0] else None
        dw = (_round_dw(conv3x3x3_cf_wgrad(x, dy), x, w)
              if ctx.needs_input_grad[1] else None)
        return dx, dw


class _InReluConv3CF(torch.autograd.Function):
    """``in_relu_conv3x3x3_cf`` on CUDA tensors. Backward: da by the dgrad
    kernel, dw by the fused wgrad kernel, dx by the closed-form ReLU +
    instance-norm backward."""

    @staticmethod
    def forward(ctx, x, w, eps):
        stats = _in_stats_cf(x, eps)
        ctx.save_for_backward(x, w, stats)
        y = _launch(x, w, stats)
        in_relu_conv3x3x3_cf.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, stats = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _in_relu_bwd(x, stats, conv3x3x3_cf_dgrad(dy, w))
        if ctx.needs_input_grad[1]:
            dw = _round_dw(in_relu_conv3x3x3_cf_wgrad(x, dy, stats), x, w)
        return dx, dw, None


def conv3x3x3_cf(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3³ conv, no bias: x (B, D, C_in, H, W), w (3, 3, 3, C_in, C_out)
    → (B, D, C_out, H, W) in x's type, float32 accumulation. Differentiable:
    autograd of the plain version on the CPU, the kernels on the card."""
    _check(x, w)
    if not dispatch.use_kernel(x, w):
        return _conv3_cf_plain(x, w)
    return _Conv3CF.apply(x, w)


def in_relu_conv3x3x3_cf(x: torch.Tensor, w: torch.Tensor,
                         eps: float = 1e-4) -> torch.Tensor:
    """``conv3x3x3_cf(relu(instance_norm(x)), w)`` with the normalisation
    and ReLU applied as the kernel stages its input (instance norm eps 1e-4,
    no affine; stats from `_in_stats_cf`). Differentiable as `conv3x3x3_cf`."""
    _check(x, w)
    if not dispatch.use_kernel(x, w):
        return _in_relu_conv_plain(x, w, eps)
    return _InReluConv3CF.apply(x, w, eps)


for _fn in (conv3x3x3_cf, in_relu_conv3x3x3_cf, conv3x3x3_cf_dgrad,
            conv3x3x3_cf_wgrad, in_relu_conv3x3x3_cf_wgrad):
    _fn.launches = 0
