"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device;
the ``dev`` fixture decides that, never the module's import. The file
imports neither JAX nor the JAX package, so it also runs where only PyTorch
and nvcc are installed. The repository's ``tests/conftest.py`` imports JAX,
hence ``--noconftest`` there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances, as max|Δ| ≤ tol·(1 + max|ref|):
* float32: 1e-4 — the same products summed in another order;
* bfloat16: 2e-2 — the output is rounded once to bf16 (2^-8 relative), and
  the fused prologue's bf16 activation may round the other way near a tie;
* a small MedFormer in float32: 1e-3 — sums in another order through about
  40 layers (as ``tests/test_torch_medformer.py``);
* weight gradients in float32: 1e-4 as above (a sum over every voxel, in
  another order); in bf16 the Functions round dw to bf16, 2e-2;
* the tensor-core route (bf16, C_in ≥ 16) at the bf16 tolerances above: its
  products of bf16 operands are exact in float32, only the order of the
  float32 sums differs, and dw stays float32 at 1e-4; the same for the
  stem's route (bf16, C_in = 1);
* gradients of the small MedFormer in float32: per parameter
  ‖Δ‖ ≤ 1e-3·(‖ref‖ + 1e-3·max over parameters of ‖ref‖) (sums in another
  order, forward and backward; the second term gives a scale to gradients
  that are zero but for rounding, such as a bias in front of a norm);
* the top-N bisection kernels: thresholds and masks equal to the plain
  version's (integer counts, the same float32 arithmetic), also on tied
  values, beyond the volume a cluster holds and replayed from a CUDA graph,
  and the same from run to run; one launch for 300 items; the closed-form
  ball counts equal to the inserted balls' sums.
"""

import threading

import numpy as np
import pytest
import torch

from rsuper_tpu_torch.models import get_model, init_params
from rsuper_tpu_torch.losses import BallLossConfig
from rsuper_tpu_torch.losses.ball import isolate_tumor_batched
from rsuper_tpu_torch.ops import balls, conv_cf, dispatch, dwconv, selection, topn
from rsuper_tpu_torch.utils.device import graph_ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (B, D, C_in, H, W, C_out): the stem's C_in = 1, a paired C_out, a one-deep
# volume, and planes and channel counts that leave partial tiles (the kernel
# tiles 16 × 16 outputs, 4 input channels and 32 or 64 output channels)
CONV_CASES = [(1, 4, 1, 6, 8, 4), (2, 3, 5, 5, 7, 6), (1, 1, 3, 4, 9, 5),
              (1, 4, 3, 6, 6, 8), (2, 5, 7, 20, 37, 70),
              (1, 3, 32, 17, 33, 64)]
# (B, D, C_in, H, W, C_out) in bf16 on the tensor-core route: C_in that
# leaves a partial 16-channel chunk, C_out that leaves a partial tile of each
# width the kernel picks (32, 64, 96, 128), H and W that leave partial
# 8- or 16-row and 16-column tiles, one-deep and two-deep volumes
TC_CASES = [(1, 3, 16, 17, 33, 24), (2, 5, 40, 20, 37, 70),
            (1, 1, 32, 9, 16, 96), (1, 4, 48, 12, 20, 96),
            (2, 2, 24, 10, 18, 120), (1, 3, 64, 8, 16, 40),
            (1, 2, 16, 5, 7, 200)]
# (B, D, 1, H, W, C_out) in bf16 on the stem's route: the production shapes
# (the serving window batch of 8, the training step's 1, the wgrad's 2), and
# tails: one-deep volumes, H and W that leave partial 8-row and 32-column
# tiles and W that is not a multiple of 8, C_out below, between and above
# the 32-channel tile
STEM_CASES = [(8, 96, 1, 96, 96, 32), (1, 96, 1, 96, 96, 32),
              (2, 96, 1, 96, 96, 32), (1, 1, 1, 9, 17, 32), (2, 5, 1, 20, 37, 7),
              (2, 3, 1, 17, 33, 48), (1, 4, 1, 13, 70, 32), (2, 1, 1, 6, 40, 3)]
# (B, D, H, W, C): C that allows 16-byte copies and C that does not; planes
# that cut a tile (``dwconv._dw_plan``: rows of 8 and strips of 6 at most)
# and depths cut into runs of 2–4, with C that leaves a partial chunk of 64
# bf16 or 32 float channels
DW_CASES = [(1, 3, 4, 5, 3), (2, 4, 6, 4, 8), (1, 1, 2, 7, 20),
            (1, 5, 9, 11, 128), (2, 3, 6, 6, 320), (1, 20, 17, 13, 80),
            (2, 11, 26, 19, 136), (1, 16, 33, 31, 200)]
TINY = dict(base_chan=4, chan_num=(8, 16, 32, 40, 32, 16, 8, 4),
            conv_num=(2, 0, 0, 0, 0, 0, 2, 2),
            trans_num=(0, 1, 2, 1, 1, 1, 0, 0),
            num_heads=(1, 2, 2, 2, 2, 2, 1, 1), fusion_depth=1, fusion_dim=40,
            fusion_heads=2, expansion=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, ref, tol):
    torch.cuda.synchronize()
    g, r = got.float().cpu(), ref.float().cpu()
    assert g.shape == r.shape
    assert torch.isfinite(g).all()
    err = (g - r).abs().max().item()
    bound = tol * (1.0 + r.abs().max().item())
    assert err <= bound, f"max|Δ| {err} > {bound}"


def _randn(shape, seed, dev, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _launch_and_plain(fn, *args):
    n = fn.launches
    got = fn(*args)
    assert fn.launches == n + 1
    with dispatch.plain_on_device():
        ref = fn(*args)
    assert fn.launches == n + 1  # the plain run launches nothing
    return got, ref


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv_kernels_match_plain(dev, case, dtype):
    B, D, Ci, H, W, Co = case
    x = (_randn((B, D, Ci, H, W), 0, dev, 2.0) + 0.5).to(dtype)
    w = _randn((3, 3, 3, Ci, Co), 1, dev, 1.0 / np.sqrt(27 * Ci))
    for fn in (conv_cf.conv3x3x3_cf, conv_cf.in_relu_conv3x3x3_cf):
        got, ref = _launch_and_plain(fn, x, w)
        assert got.dtype == dtype and got.shape == (B, D, Co, H, W)
        _assert_close(got, ref, TOL[dtype])


def test_conv_kernel_takes_a_strided_view(dev):
    base = _randn((1, 6, 4, 5, 3), 2, dev)  # (B, D, H, W, C)
    x = base.permute(0, 1, 4, 2, 3)  # (B, D, C, H, W), not contiguous
    w = _randn((3, 3, 3, 3, 5), 3, dev, 0.2)
    got, ref = _launch_and_plain(conv_cf.in_relu_conv3x3x3_cf, x, w)
    _assert_close(got, ref, TOL[torch.float32])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", DW_CASES, ids=str)
def test_depthwise_kernel_matches_plain(dev, case, dtype):
    x = _randn(case, 4, dev).to(dtype)
    w = _randn((3, 3, 3, 1, case[-1]), 5, dev, 0.2)
    got, ref = _launch_and_plain(dwconv.depthwise_conv3x3x3, x, w)
    assert got.dtype == dtype
    _assert_close(got, ref, TOL[dtype])


def test_depthwise_kernel_on_a_misaligned_tensor(dev):
    """A tensor that starts 4 bytes past a 16-byte boundary takes the
    element-wise path of the kernel."""
    shape = (1, 3, 4, 5, 16)
    buf = torch.empty(int(np.prod(shape)) + 1, device=dev)
    x = buf[1:].view(shape)
    x.copy_(_randn(shape, 6, dev))
    assert x.data_ptr() % 16 != 0
    got, ref = _launch_and_plain(dwconv.depthwise_conv3x3x3, x,
                                 _randn((3, 3, 3, 1, 16), 7, dev, 0.2))
    _assert_close(got, ref, TOL[torch.float32])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 2, 3, 4, 5, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv_cf.conv3x3x3_cf(x, torch.zeros(3, 3, 3, 3, 2, device=dev))
    with pytest.raises(TypeError):
        dwconv.depthwise_conv3x3x3(x, torch.zeros(3, 3, 3, 1, 5, device=dev))
    with pytest.raises(ValueError):  # operands on two devices
        conv_cf.conv3x3x3_cf(x.float(), torch.zeros(3, 3, 3, 3, 2))


def test_small_medformer_through_the_kernels_matches_plain(dev):
    model = get_model("medformer", 3, dict(TINY), dtype=torch.float32)
    model = init_params(model, seed=0).to(dev).eval()
    x = _randn((1, 32, 32, 32, 1), 8, dev)
    n = dwconv.depthwise_conv3x3x3.launches
    with torch.inference_mode():
        got = model(x)["segmentation"]
        with dispatch.plain_on_device():
            ref = model(x)["segmentation"]
    assert dwconv.depthwise_conv3x3x3.launches > n
    for g, r in zip(got, ref):
        _assert_close(g, r, 1e-3)


# ------------------------------------------------------- backward kernels
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv_backward_kernels_match_plain(dev, case, dtype):
    """dgrad, wgrad and fused wgrad wrappers against their plain versions."""
    B, D, Ci, H, W, Co = case
    x = (_randn((B, D, Ci, H, W), 10, dev, 2.0) + 0.5).to(dtype)
    w = _randn((3, 3, 3, Ci, Co), 11, dev, 1.0 / np.sqrt(27 * Ci))
    dy = _randn((B, D, Co, H, W), 12, dev).to(dtype)
    stats = conv_cf._in_stats_cf(x, 1e-4)
    got, ref = _launch_and_plain(conv_cf.conv3x3x3_cf_dgrad, dy, w)
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(got, ref, TOL[dtype])
    got, ref = _launch_and_plain(conv_cf.conv3x3x3_cf_wgrad, x, dy)
    assert got.dtype == torch.float32 and got.shape == w.shape
    _assert_close(got, ref, TOL[torch.float32])
    again = conv_cf.conv3x3x3_cf_wgrad(x, dy)
    assert torch.equal(got, again)  # partial sums, no atomics
    got, ref = _launch_and_plain(conv_cf.in_relu_conv3x3x3_cf_wgrad, x, dy,
                                 stats)
    _assert_close(got, ref, TOL[torch.float32])


@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_tensor_core_conv_kernels_match_plain(dev, case):
    """Forward, fused forward, dgrad, wgrad and fused wgrad on the
    tensor-core route against their plain versions; dw twice, bit-equal."""
    B, D, Ci, H, W, Co = case
    bf = torch.bfloat16
    assert conv_cf.conv_route(bf, Ci) == conv_cf.conv_route(bf, Co) \
        == "tensor_core"
    x = (_randn((B, D, Ci, H, W), 40, dev, 2.0) + 0.5).to(bf)
    w = _randn((3, 3, 3, Ci, Co), 41, dev, 1.0 / np.sqrt(27 * Ci))
    dy = _randn((B, D, Co, H, W), 42, dev).to(bf)
    stats = conv_cf._in_stats_cf(x, 1e-4)
    for fn in (conv_cf.conv3x3x3_cf, conv_cf.in_relu_conv3x3x3_cf):
        got, ref = _launch_and_plain(fn, x, w)
        assert got.dtype == bf and got.shape == (B, D, Co, H, W)
        _assert_close(got, ref, TOL[bf])
    got, ref = _launch_and_plain(conv_cf.conv3x3x3_cf_dgrad, dy, w)
    assert got.dtype == bf and got.shape == x.shape
    _assert_close(got, ref, TOL[bf])
    for fn, args in ((conv_cf.conv3x3x3_cf_wgrad, (x, dy)),
                     (conv_cf.in_relu_conv3x3x3_cf_wgrad, (x, dy, stats))):
        got, ref = _launch_and_plain(fn, *args)
        assert got.dtype == torch.float32 and got.shape == w.shape
        _assert_close(got, ref, TOL[torch.float32])
        assert torch.equal(got, fn(*args))  # partial sums, no atomics


def _stem_counters_are_zero():
    return all(int(c.abs().sum()) == 0
               for _, c in conv_cf._STEM_WORK.values())


@pytest.mark.parametrize("case", STEM_CASES, ids=str)
def test_stem_kernels_match_plain(dev, case):
    """The stem's forward and weight gradient, plain and with the fused
    prologue, against their plain versions; dw twice, bit-equal, and the
    arrival counters back at zero."""
    B, D, Ci, H, W, Co = case
    bf = torch.bfloat16
    assert conv_cf.conv_route(bf, Ci) == "stem"
    x = (_randn((B, D, Ci, H, W), 50, dev, 2.0) + 0.5).to(bf)
    w = _randn((3, 3, 3, Ci, Co), 51, dev, 1.0 / np.sqrt(27))
    dy = _randn((B, D, Co, H, W), 52, dev).to(bf)
    stats = conv_cf._in_stats_cf(x, 1e-4)
    for fn in (conv_cf.conv3x3x3_cf, conv_cf.in_relu_conv3x3x3_cf):
        got, ref = _launch_and_plain(fn, x, w)
        assert got.dtype == bf and got.shape == (B, D, Co, H, W)
        _assert_close(got, ref, TOL[bf])
    for fn, args in ((conv_cf.conv3x3x3_cf_wgrad, (x, dy)),
                     (conv_cf.in_relu_conv3x3x3_cf_wgrad, (x, dy, stats))):
        got, ref = _launch_and_plain(fn, *args)
        assert got.dtype == torch.float32 and got.shape == w.shape
        _assert_close(got, ref, TOL[torch.float32])
        assert torch.equal(got, fn(*args))  # fixed-order sums, no atomics
        torch.cuda.synchronize()
        assert _stem_counters_are_zero()


@pytest.mark.parametrize("case", [(8, 96, 1, 96, 96, 32), (2, 5, 1, 20, 37, 7)],
                         ids=str)
def test_stem_calls_launch_one_kernel(dev, case):
    """A stem forward call is its kernel and the weight pack's one copy; a
    weight gradient call is one kernel."""
    B, D, Ci, H, W, Co = case
    x = _randn((B, D, Ci, H, W), 53, dev).to(torch.bfloat16)
    w = _randn((3, 3, 3, Ci, Co), 54, dev, 0.2)
    dy = _randn((B, D, Co, H, W), 55, dev).to(torch.bfloat16)
    ops = graph_ops(lambda: conv_cf.conv3x3x3_cf(x, w))
    assert len(ops) <= 2 and sum("stem_fwd_kernel" in o for o in ops) == 1, ops
    ops = graph_ops(lambda: conv_cf.conv3x3x3_cf_wgrad(x, dy))
    assert len(ops) == 1 and "stem_wgrad_kernel" in ops[0], ops


def test_stem_kernels_launch_from_a_fresh_thread(dev):
    """Autograd runs the weight gradient from its own thread: both stem
    kernels launch from a thread that has not touched the card and give
    what they give in the main thread."""
    shape = (2, 5, 1, 20, 37, 7)
    B, D, Ci, H, W, Co = shape
    x = _randn((B, D, Ci, H, W), 56, dev).to(torch.bfloat16)
    w = _randn((3, 3, 3, Ci, Co), 57, dev, 0.2)
    dy = _randn((B, D, Co, H, W), 58, dev).to(torch.bfloat16)
    got, errors = [], []

    def run():
        try:
            got.append(conv_cf.conv3x3x3_cf(x, w))
            got.append(conv_cf.conv3x3x3_cf_wgrad(x, dy))
        except Exception as e:  # re-raised in the test's thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    ref = [conv_cf.conv3x3x3_cf(x, w), conv_cf.conv3x3x3_cf_wgrad(x, dy)]
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_stem_function_backward_matches_autograd_of_plain(dev):
    """The stem conv's Function: dw (rounded as the JAX package hands it on)
    from the stem wgrad kernel, no input gradient, against autograd of the
    plain version."""
    B, D, Ci, H, W, Co = (1, 6, 1, 12, 40, 32)
    x = _randn((B, D, Ci, H, W), 59, dev).to(torch.bfloat16)
    w = _randn((3, 3, 3, Ci, Co), 60, dev, 0.2).requires_grad_()
    dy = _randn((B, D, Co, H, W), 61, dev).to(torch.bfloat16)
    n = conv_cf.conv3x3x3_cf_wgrad.launches
    (dw,) = torch.autograd.grad(conv_cf.conv3x3x3_cf(x, w), (w,), dy)
    assert conv_cf.conv3x3x3_cf_wgrad.launches == n + 1
    with dispatch.plain_on_device():
        (rw,) = torch.autograd.grad(conv_cf.conv3x3x3_cf(x, w), (w,), dy)
    _assert_close(dw, rw, TOL[torch.bfloat16])


@pytest.mark.parametrize("name", ["conv3x3x3_cf", "in_relu_conv3x3x3_cf"])
def test_tensor_core_functions_backward_matches_autograd_of_plain(dev, name):
    B, D, Ci, H, W, Co = (1, 3, 32, 12, 20, 48)
    fn = getattr(conv_cf, name)
    x = (_randn((B, D, Ci, H, W), 43, dev, 2.0) + 0.5).bfloat16()
    w = _randn((3, 3, 3, Ci, Co), 44, dev, 1.0 / np.sqrt(27 * Ci))
    dy = _randn((B, D, Co, H, W), 45, dev).bfloat16()
    dx, dw = _grads(fn, x, w, dy)
    with dispatch.plain_on_device():
        rx, rw = _grads(fn, x, w, dy)
    _assert_close(dx, rx, TOL[torch.bfloat16])
    _assert_close(dw, rw, TOL[torch.bfloat16])


def _grads(fn, x, w, dy):
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    y = fn(x, w)
    return torch.autograd.grad(y, (x, w), dy)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", ["conv3x3x3_cf", "in_relu_conv3x3x3_cf"])
def test_conv_functions_backward_matches_autograd_of_plain(dev, name, dtype):
    """The Functions' dx and dw, with a permuted (non-contiguous) dy, against
    autograd of the plain version on the card."""
    B, D, Ci, H, W, Co = (2, 5, 7, 20, 37, 70)
    fn = getattr(conv_cf, name)
    x = (_randn((B, D, Ci, H, W), 13, dev, 2.0) + 0.5).to(dtype)
    w = _randn((3, 3, 3, Ci, Co), 14, dev, 1.0 / np.sqrt(27 * Ci))
    dy = _randn((B, D, H, W, Co), 15, dev).to(dtype).permute(0, 1, 4, 2, 3)
    assert not dy.is_contiguous()
    n = (conv_cf.conv3x3x3_cf_dgrad.launches,
         conv_cf.conv3x3x3_cf_wgrad.launches
         + conv_cf.in_relu_conv3x3x3_cf_wgrad.launches)
    dx, dw = _grads(fn, x, w, dy)
    assert conv_cf.conv3x3x3_cf_dgrad.launches == n[0] + 1
    assert (conv_cf.conv3x3x3_cf_wgrad.launches
            + conv_cf.in_relu_conv3x3x3_cf_wgrad.launches) == n[1] + 1
    with dispatch.plain_on_device():
        rx, rw = _grads(fn, x, w, dy)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _assert_close(dx, rx, TOL[dtype])
    _assert_close(dw, rw, TOL[dtype])


def test_stem_conv_skips_the_input_gradient(dev):
    x = _randn((1, 4, 1, 6, 8), 16, dev)
    w = _randn((3, 3, 3, 1, 4), 17, dev, 0.2).requires_grad_()
    n = conv_cf.conv3x3x3_cf_dgrad.launches
    conv_cf.conv3x3x3_cf(x, w).sum().backward()
    assert conv_cf.conv3x3x3_cf_dgrad.launches == n and w.grad is not None


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", DW_CASES, ids=str)
def test_depthwise_backward_kernels_match_plain(dev, case, dtype):
    x = _randn(case, 18, dev).to(dtype)
    w = _randn((3, 3, 3, 1, case[-1]), 19, dev, 0.2)
    dy = _randn(case, 20, dev).to(dtype)
    (dx, dw), (rx, rw) = _launch_and_plain(dwconv.depthwise_conv3x3x3_bwd,
                                           x, w, dy)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _assert_close(dx, rx, TOL[dtype])
    _assert_close(dw, rw, TOL[torch.float32])
    assert torch.equal(dw, dwconv.depthwise_conv3x3x3_bwd(x, w, dy)[1])
    # through autograd, dy permuted
    dyp = dy.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    gx, gw = _grads(dwconv.depthwise_conv3x3x3, x, w, dyp)
    with dispatch.plain_on_device():
        px, pw = _grads(dwconv.depthwise_conv3x3x3, x, w, dyp)
    _assert_close(gx, px, TOL[dtype])
    _assert_close(gw, pw, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [(1, 12, 12, 12, 256), (2, 11, 26, 19, 136),
                                  (1, 3, 4, 5, 3)], ids=str)
def test_depthwise_calls_launch_one_kernel(dev, case, dtype):
    """A forward call is one device kernel; a backward call, public or
    through the autograd Function with its rounded dw, is one too (two at
    most). The Function's dw is the public dw rounded to x's type."""
    x = _randn(case, 29, dev).to(dtype)
    w = _randn((3, 3, 3, 1, case[-1]), 30, dev, 0.2)
    dy = _randn(case, 31, dev).to(dtype)
    ops = graph_ops(lambda: dwconv.depthwise_conv3x3x3(x, w))
    assert len(ops) == 1 and "dw3_fwd_kernel" in ops[0], ops
    ops = graph_ops(lambda: dwconv.depthwise_conv3x3x3_bwd(x, w, dy))
    assert len(ops) == 1 and "dw3_bwd_kernel" in ops[0], ops
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    fwd = graph_ops(lambda: dwconv.depthwise_conv3x3x3(xg, wg))
    both = graph_ops(lambda: torch.autograd.grad(
        dwconv.depthwise_conv3x3x3(xg, wg), (xg, wg), dy))
    assert 1 <= len(both) - len(fwd) <= 2, both  # the Function's backward
    y = dwconv.depthwise_conv3x3x3(xg, wg)
    gx, gw = torch.autograd.grad(y, (xg, wg), dy)
    dx, dw = dwconv.depthwise_conv3x3x3_bwd(x, w, dy)
    assert torch.equal(gx, dx)
    assert torch.equal(gw.reshape(27, -1), dw.to(dtype).float())


def test_depthwise_kernels_launch_from_a_fresh_thread(dev):
    """Autograd runs the backward from its own threads: both kernels launch
    from a thread that has not touched the card yet (they encode their TMA
    tensor maps with cuTensorMapEncodeTiled, which needs the card's context
    current in the calling thread) and give what they give in the main
    thread."""
    shape = (1, 5, 9, 11, 128)
    x = _randn(shape, 32, dev).to(torch.bfloat16)
    w = _randn((3, 3, 3, 1, shape[-1]), 33, dev, 0.2)
    dy = _randn(shape, 34, dev).to(torch.bfloat16)
    got, errors = [], []

    def run():
        try:
            got.append(dwconv.depthwise_conv3x3x3(x, w))
            got.extend(dwconv.depthwise_conv3x3x3_bwd(x, w, dy))
        except Exception as e:  # re-raised in the test's thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    ref = [dwconv.depthwise_conv3x3x3(x, w),
           *dwconv.depthwise_conv3x3x3_bwd(x, w, dy)]
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_depthwise_backward_on_a_misaligned_tensor(dev):
    shape = (1, 3, 4, 5, 16)
    buf = torch.empty(int(np.prod(shape)) + 1, device=dev)
    x = buf[1:].view(shape)
    x.copy_(_randn(shape, 21, dev))
    assert x.data_ptr() % 16 != 0
    (dx, dw), (rx, rw) = _launch_and_plain(
        dwconv.depthwise_conv3x3x3_bwd, x,
        _randn((3, 3, 3, 1, 16), 22, dev, 0.2), _randn(shape, 23, dev))
    _assert_close(dx, rx, TOL[torch.float32])
    _assert_close(dw, rw, TOL[torch.float32])


def test_functions_run_under_inference_mode(dev):
    x = _randn((1, 3, 4, 5, 6), 24, dev)
    with torch.inference_mode():
        y = conv_cf.in_relu_conv3x3x3_cf(x, _randn((3, 3, 3, 4, 5), 25, dev))
        z = dwconv.depthwise_conv3x3x3(x, _randn((3, 3, 3, 1, 6), 26, dev))
    assert y.shape == (1, 3, 5, 5, 6) and z.shape == x.shape


def test_small_medformer_gradients_through_the_kernels_match_plain(dev):
    model = get_model("medformer", 3, dict(TINY), dtype=torch.float32)
    model = init_params(model, seed=0).to(dev).train()
    x = _randn((1, 32, 32, 32, 1), 27, dev)
    t = _randn((1, 32, 32, 32, 3), 28, dev)

    def grads():
        model.zero_grad(set_to_none=True)
        seg = model(x)["segmentation"]
        sum(((s - t) ** 2).mean() for s in seg).backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    n = dwconv.depthwise_conv3x3x3_bwd.launches
    got = grads()
    assert dwconv.depthwise_conv3x3x3_bwd.launches > n
    with dispatch.plain_on_device():
        ref = grads()
    torch.cuda.synchronize()
    top = max(r.norm().item() for r in ref.values())
    for k in ref:  # a gradient that is zero but for rounding has no scale
        err = (got[k] - ref[k]).norm().item()
        bound = 1e-3 * (ref[k].norm().item() + 1e-3 * top)
        assert err <= bound, f"{k}: |Δ| {err} > {bound}"


# ------------------------------------------------------------ top-N bisection
TOPN_V = [1, 127, 4099, 32 ** 3, 96 ** 3]


def _topn_volume(B, V, seed, dev, kind):
    """`ball`: uniform values, most voxels exactly 0 (as inside one inserted
    ball); `dense`: normal values, negatives included."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        x = rng.normal(size=(B, V))
    else:
        x = rng.random((B, V)) * (rng.random((B, V)) < 0.02 + 1.0 / V)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("V", TOPN_V)
def test_topn_batched_kernel_equals_plain(dev, V, B, K, dtype):
    for kind in ("ball", "dense"):
        x = _topn_volume(B, V, V + B, dev, kind).to(dtype)
        pos = (x > 0).sum(dim=1).float()
        ns = torch.stack([torch.clamp(torch.round(pos * f), min=1.0)
                          for f in (0.5, 0.4, 0.6)[:K]], dim=1)
        ns[0, 0] = float(V + 7)  # above the positive count: lo stays 0
        got, ref = _launch_and_plain(topn.topn_threshold_multi_batched, x, ns)
        torch.cuda.synchronize()
        assert got.shape == (B, K) and got.dtype == torch.float32
        assert torch.equal(got, ref), (kind, got, ref)
        assert torch.equal(topn.topn_threshold_multi_batched(x, ns), got)
        masks = selection.topn_masks_multi_batched(x, ns)
        with dispatch.plain_on_device():
            assert torch.equal(masks,
                               selection.topn_masks_multi_batched(x, ns))


@pytest.mark.parametrize("dtype", DTYPES + [torch.float16], ids=str)
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("V", TOPN_V)
def test_topn_single_volume_kernel_equals_plain(dev, V, K, dtype):
    for kind in ("ball", "dense"):
        x = _topn_volume(1, V, 3 * V, dev, kind)[0].to(dtype)
        ns = [max(1.0, float(int(V * f))) for f in (0.01, 0.5, 0.002)[:K]]
        got, ref = _launch_and_plain(topn.topn_threshold_multi, x, ns)
        torch.cuda.synchronize()
        assert got.shape == (K,) and torch.equal(got, ref), (kind, got, ref)
        n = topn.topn_threshold_multi_batched.launches
        both = topn.topn_threshold_multi_batched(x[None], [ns])
        assert topn.topn_threshold_multi_batched.launches == n + 1
        assert torch.equal(both[0], got)  # the B = 1 case of one kernel


def test_topn_edge_cases_equal_plain(dev):
    zero = torch.zeros((2, 5000), device=dev)
    zero[1, 17] = 0.25
    neg = -torch.rand((2, 5000), device=dev,
                      generator=torch.Generator(dev).manual_seed(0)) - 0.5
    for x, ns in ((zero, [[1.0, 10.0], [1.0, 2.0]]),
                  (neg, [[1.0, 4000.0], [0.0, -2.0]])):
        got, ref = _launch_and_plain(topn.topn_threshold_multi_batched, x, ns)
        assert torch.equal(got, ref)
    assert not selection.topn_masks_multi_batched(zero, [[1.0], [3.0]])[0].any()
    x = _topn_volume(1, 4099, 5, dev, "dense")[0]
    strided = x[::3]  # made contiguous by the wrapper
    got, ref = _launch_and_plain(topn.topn_threshold_multi, strided, [40.0])
    assert torch.equal(got, ref)
    for iters in (0, 5):
        got = topn.topn_threshold_multi(x, [9.0], iters=iters)
        with dispatch.plain_on_device():
            assert torch.equal(got, topn.topn_threshold_multi(x, [9.0],
                                                              iters=iters))
    assert not topn.topn_threshold_multi(x, [9.0], iters=0).any()


def test_topn_more_targets_and_items_than_one_launch_takes(dev):
    x = _topn_volume(300, 127, 6, dev, "dense")  # more items than blocks
    ns = torch.arange(1, 10, device=dev).float().repeat(300, 1) * 9  # K = 9
    got, ref = _launch_and_plain(topn.topn_threshold_multi_batched, x, ns)
    assert got.shape == (300, 9) and torch.equal(got, ref)
    big = _topn_volume(1, 128 ** 3, 7, dev, "ball")[0]  # re-read from L2
    got, ref = _launch_and_plain(topn.topn_threshold_multi, big,
                                 [4000.0, 3200.0, 4800.0])
    assert torch.equal(got, ref)


def _ties(B, V, seed, dev):
    """The ball volume quantized to 4 positive levels: many values tie, so
    do the counts of neighbouring mids."""
    return torch.ceil(_topn_volume(B, V, seed, dev, "ball") * 4.0) / 4.0


@pytest.mark.parametrize("V", [4099, 96 ** 3])
def test_topn_kernel_on_tied_values_equals_plain(dev, V):
    x = _ties(2, V, 11, dev)
    pos = (x > 0).sum(dim=1, keepdim=True).float()
    ns = torch.cat([torch.round(pos * 0.3), torch.round(pos * 0.6),
                    pos, pos + 1.0], dim=1).clamp(min=1.0)  # K = 4
    got, ref = _launch_and_plain(topn.topn_threshold_multi_batched, x, ns)
    assert torch.equal(got, ref), (got, ref)
    # a tie sits exactly on a threshold: the masks take all of its voxels
    masks = selection.topn_masks_multi_batched(x, ns)
    with dispatch.plain_on_device():
        assert torch.equal(masks, selection.topn_masks_multi_batched(x, ns))


def test_topn_many_items_take_one_launch(dev):
    x = _topn_volume(300, 127, 12, dev, "dense")
    ns = torch.tensor([5.0, 40.0, 90.0], device=dev).repeat(300, 1)
    got, ref = _launch_and_plain(topn.topn_threshold_multi_batched, x, ns)
    assert torch.equal(got, ref)
    ops = graph_ops(lambda: topn.topn_threshold_multi_batched(x, ns))
    assert len(ops) == 1 and "multisect_kernel" in ops[0], ops


@pytest.mark.parametrize("kind", ["ball", "dense"])
def test_topn_volume_beyond_the_cluster_is_read_again_from_l2(dev, kind):
    V = 128 ** 3
    plan = topn.plan_for(V, 3, torch.float32, dev)
    held = plan.cache_slots * plan.cluster * topn._THREADS * 4
    assert held < V  # 8.4 MB: part of it stays in L2
    x = _topn_volume(2, V, 13, dev, kind)
    pos = (x > 0).sum(dim=1, keepdim=True).float()
    ns = torch.cat([torch.round(pos * f) for f in (0.01, 0.3, 0.9)], dim=1)
    got, ref = _launch_and_plain(topn.topn_threshold_multi_batched, x, ns)
    assert torch.equal(got, ref), (got, ref)


@pytest.mark.parametrize("single", [False, True])
def test_topn_call_captures_in_a_cuda_graph(dev, single):
    x = _topn_volume(2, 96 ** 3, 14, dev, "ball")
    ns = torch.tensor([[4000.0, 3200.0, 4800.0], [100.0, 50.0, 9.0]],
                      device=dev)
    a = (x[0], ns[0]) if single else (x, ns)
    fn = (topn.topn_threshold_multi if single
          else topn.topn_threshold_multi_batched)
    eager = fn(*a)
    ops = graph_ops(lambda: fn(*a))
    assert len(ops) == 1 and "multisect_kernel" in ops[0], ops
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*a)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn(*a)
    for _ in range(3):
        out.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    with dispatch.plain_on_device():
        assert torch.equal(eager, fn(*a))


def test_ball_counts_equal_inserted_balls_on_the_card(dev):
    shape = (24, 26, 28)
    cz, cy, cx = (torch.tensor(v, device=dev) for v in
                  ([0, 3, 23, 12], [0, 20, 25, 0], [0, 11, 27, 17]))
    d = torch.tensor([1.0, 3.0, 8.0, 12.4, 23.0, 40.0, 77.0], device=dev)
    counts = balls.ball_count_clipped(
        shape, (cz[:, None], cy[:, None], cx[:, None]), d[None])
    for i in range(4):
        stack = balls.insert_ball(
            shape, (cz[i].expand(7), cy[i].expand(7), cx[i].expand(7)), d)
        assert torch.equal(counts[i], stack.sum(dim=(1, 2, 3)))
    wrapped = balls.ball_count_wrapped(shape, d)
    want = torch.stack([balls.ball_kernel_wrapped(shape, float(v), device=dev
                                                  ).sum() for v in d])
    assert torch.equal(wrapped, want)
    t = torch.arange(0, 70000, device=dev).float()
    assert torch.equal(balls._floor_sqrt(t),
                       torch.floor(torch.sqrt(t.double())).float())
    assert torch.equal(counts.cpu(), balls.ball_count_clipped(
        shape, (cz[:, None].cpu(), cy[:, None].cpu(), cx[:, None].cpu()),
        d[None].cpu()))


def test_isolate_tumor_through_the_kernel_equals_plain(dev):
    """Identical input both ways: only the top-N route differs, so the
    three pseudo-masks must be equal."""
    g = torch.meshgrid(*[torch.arange(48.0, device=dev)] * 3, indexing="ij")
    blobs = []
    for c, s in (((20, 25, 18), 5.0), ((3, 40, 30), 3.0)):
        d2 = sum((a - v) ** 2 for a, v in zip(g, c))
        blobs.append(0.9 * torch.exp(-d2 / (2 * s * s)))
    x = torch.stack(blobs) + 0.01 * _randn((2, 48, 48, 48), 30, dev).abs()
    dia = torch.tensor([12.0, 7.0], device=dev)
    vol = torch.tensor([900.0, 200.0], device=dev)
    cfg = BallLossConfig(max_diameter=64)
    n = topn.topn_threshold_multi_batched.launches
    got = isolate_tumor_batched(x, dia, vol, cfg)
    assert topn.topn_threshold_multi_batched.launches == n + 1
    with dispatch.plain_on_device():
        ref = isolate_tumor_batched(x, dia, vol, cfg)
    for a, b in zip(got, ref):
        assert a.sum() > 0 and torch.equal(a, b)
