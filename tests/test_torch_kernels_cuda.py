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
* gradients of the small MedFormer in float32: per parameter
  ‖Δ‖ ≤ 1e-3·(‖ref‖ + 1e-3·max over parameters of ‖ref‖) (sums in another
  order, forward and backward; the second term gives a scale to gradients
  that are zero but for rounding, such as a bias in front of a norm).
"""

import numpy as np
import pytest
import torch

from rsuper_tpu_torch.models import get_model, init_params
from rsuper_tpu_torch.ops import conv_cf, dispatch, dwconv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (B, D, C_in, H, W, C_out): the stem's C_in = 1, a paired C_out, a one-deep
# volume, and planes and channel counts that leave partial tiles (the kernel
# tiles 16 × 16 outputs, 4 input channels and 32 or 64 output channels)
CONV_CASES = [(1, 4, 1, 6, 8, 4), (2, 3, 5, 5, 7, 6), (1, 1, 3, 4, 9, 5),
              (1, 4, 3, 6, 6, 8), (2, 5, 7, 20, 37, 70),
              (1, 3, 32, 17, 33, 64)]
# (B, D, H, W, C): C that allows 16-byte accesses and C that does not
DW_CASES = [(1, 3, 4, 5, 3), (2, 4, 6, 4, 8), (1, 1, 2, 7, 20),
            (1, 5, 9, 11, 128), (2, 3, 6, 6, 320)]
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
