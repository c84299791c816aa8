"""Gradients of the PyTorch port's kernel ops against the JAX package, on the
CPU.

``conv3x3x3_cf``, ``in_relu_conv3x3x3_cf`` and ``depthwise_conv3x3x3`` run
here through autograd of their plain versions (the tensors lie on the CPU).
dx and dw are held against ``jax.vjp`` of the JAX public function on the same
numpy inputs and cotangent: through its XLA path and through the Pallas
custom-VJP path in interpret mode. The standalone plain backward functions
(``_wgrad_plain``, ``_dgrad_plain``, ``_in_relu_bwd``, ``_dw_bwd_plain``) are
what the card holds the backward kernels against, so they are held against
autograd of the plain forward here.

Tolerances, as max|Δ| ≤ tol·(1 + max|ref|):
* float32: 1e-4 — the same products summed in another order (dw sums over
  every voxel);
* bfloat16: 2e-2 — dx and dw are rounded once to bf16 (2^-8 relative) on
  both sides; the Pallas depthwise path keeps dw in float32, which is within
  the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.ops import conv_cf as jconv
from rsuper_tpu.ops import dwconv as jdw
from rsuper_tpu_torch.ops import conv_cf, dwconv
from test_torch_loop import _one_intra_op_thread  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the cases of tests/test_torch_ops.py: (B, D, C_in, H, W, C_out) with the
# stem's C_in = 1, odd planes, a one-voxel-deep volume and a paired C_out
CONV_CASES = [
    (1, 4, 1, 6, 8, 4),
    (2, 3, 5, 5, 7, 6),
    (1, 1, 3, 4, 9, 5),
    (1, 4, 3, 6, 6, 8),
]
DW_CASES = [(1, 3, 4, 5, 3), (2, 4, 6, 4, 8), (1, 1, 2, 7, 20),
            (1, 3, 4, 6, 128)]
PATHS = {"xla": {}, "pallas": dict(force_pallas=True, interpret=True)}


def _assert_close(got, ref, tol, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    bound = tol * (1.0 + float(np.abs(ref).max()))
    assert err <= bound, f"{what}: max|Δ| {err} > {bound}"


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


def _conv_inputs(case, seed):
    B, D, Ci, H, W, Co = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D, Ci, H, W)).astype(np.float32) * 2.0 + 0.5
    w = (rng.normal(size=(3, 3, 3, Ci, Co)) / np.sqrt(27 * Ci)).astype(
        np.float32)
    dy = rng.normal(size=(B, D, Co, H, W)).astype(np.float32)
    return x, w, dy


def _torch_grads(fn, x, w, dy, dtype, permuted=None):
    xt = _t(x, dtype).requires_grad_()
    wt = _t(w).requires_grad_()
    y = fn(xt, wt)
    dyt = _t(dy, dtype)
    if permuted is not None:  # the same values behind a non-contiguous view
        dyt = dyt.permute(*permuted).contiguous().permute(
            *np.argsort(permuted).tolist())
        assert not dyt.is_contiguous()
    dx, dw = torch.autograd.grad(y, (xt, wt), dyt)
    assert dx.dtype == TDT[dtype] and dw.dtype == torch.float32
    return dx.float().numpy(), dw.numpy()


def _jax_grads(fn, x, w, dy, dtype, **kw):
    xj = jnp.asarray(x).astype(JDT[dtype])
    y, vjp = jax.vjp(lambda a, b: fn(a, b, **kw), xj, jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dy).astype(y.dtype))
    return np.asarray(dx, np.float32), np.asarray(dw, np.float32)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("name", ["conv3x3x3_cf", "in_relu_conv3x3x3_cf"])
def test_conv_gradients_match_jax(name, case, dtype, path):
    x, w, dy = _conv_inputs(case, 0)
    dx, dw = _torch_grads(getattr(conv_cf, name), x, w, dy, dtype)
    rx, rw = _jax_grads(getattr(jconv, name), x, w, dy, dtype, **PATHS[path])
    _assert_close(dx, rx, TOL[dtype], "dx")
    _assert_close(dw, rw, TOL[dtype], "dw")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DW_CASES)
def test_depthwise_gradients_match_jax(case, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=case).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 1, case[-1])) * 0.2).astype(np.float32)
    dy = rng.normal(size=case).astype(np.float32)
    dx, dw = _torch_grads(dwconv.depthwise_conv3x3x3, x, w, dy, dtype)
    paths = ["xla"] + (["pallas"] if case[-1] % 128 == 0 else [])
    for path in paths:
        rx, rw = _jax_grads(jdw.depthwise_conv3x3x3, x, w, dy, dtype,
                            **PATHS[path])
        _assert_close(dx, rx, TOL[dtype], f"dx {path}")
        _assert_close(dw, rw, TOL[dtype], f"dw {path}")


@pytest.mark.parametrize("name", ["conv3x3x3_cf", "in_relu_conv3x3x3_cf",
                                  "depthwise_conv3x3x3"])
def test_gradients_with_a_permuted_cotangent(name):
    """dy arrives as a permuted view from the model's layout changes."""
    if name == "depthwise_conv3x3x3":
        fn, case = dwconv.depthwise_conv3x3x3, DW_CASES[1]
        rng = np.random.default_rng(2)
        x = rng.normal(size=case).astype(np.float32)
        w = (rng.normal(size=(3, 3, 3, 1, case[-1])) * 0.2).astype(np.float32)
        dy = rng.normal(size=case).astype(np.float32)
    else:
        fn = getattr(conv_cf, name)
        x, w, dy = _conv_inputs(CONV_CASES[1], 2)
    ref = _torch_grads(fn, x, w, dy, "float32")
    got = _torch_grads(fn, x, w, dy, "float32", permuted=(0, 1, 3, 4, 2))
    for g, r in zip(got, ref):  # strided sums may run in another order
        _assert_close(g, r, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_plain_conv_backward_functions_match_autograd(case, dtype):
    """_dgrad_plain, _wgrad_plain (plain and with stats) and _in_relu_bwd
    against autograd of the plain forward."""
    x, w, dy = _conv_inputs(case, 3)
    xt, wt, dyt = _t(x, dtype), _t(w), _t(dy, dtype)
    dx, dw = _torch_grads(conv_cf.conv3x3x3_cf, x, w, dy, dtype)
    _assert_close(conv_cf.conv3x3x3_cf_dgrad(dyt, wt).float().numpy(), dx,
                  TOL[dtype], "dgrad")
    got = conv_cf.conv3x3x3_cf_wgrad(xt, dyt)
    assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
    _assert_close(got.numpy(), dw, TOL[dtype], "wgrad")

    dx, dw = _torch_grads(conv_cf.in_relu_conv3x3x3_cf, x, w, dy, dtype)
    stats = conv_cf._in_stats_cf(xt, 1e-4)
    _assert_close(conv_cf.in_relu_conv3x3x3_cf_wgrad(xt, dyt, stats).numpy(),
                  dw, TOL[dtype], "fused wgrad")
    da = conv_cf.conv3x3x3_cf_dgrad(dyt, wt)
    got = conv_cf._in_relu_bwd(xt, stats, da)
    assert got.dtype == TDT[dtype]
    _assert_close(got.float().numpy(), dx, TOL[dtype], "IN+ReLU backward")
    assert conv_cf.conv3x3x3_cf_dgrad.launches == 0  # CPU: plain versions
    assert conv_cf.conv3x3x3_cf_wgrad.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DW_CASES)
def test_plain_depthwise_backward_matches_autograd(case, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=case).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 1, case[-1])) * 0.2).astype(np.float32)
    dy = rng.normal(size=case).astype(np.float32)
    rx, rw = _torch_grads(dwconv.depthwise_conv3x3x3, x, w, dy, dtype)
    dx, dw = dwconv.depthwise_conv3x3x3_bwd(_t(x, dtype), _t(w), _t(dy, dtype))
    assert dx.dtype == TDT[dtype] and dw.dtype == torch.float32
    assert tuple(dw.shape) == (27, case[-1])
    _assert_close(dx.float().numpy(), rx, TOL[dtype], "dx")
    _assert_close(dw.reshape(w.shape).numpy(), rw, TOL[dtype], "dw")
    assert dwconv.depthwise_conv3x3x3_bwd.launches == 0


def test_in_relu_bwd_matches_jax_closed_form():
    x, w, dy = _conv_inputs(CONV_CASES[1], 5)
    da = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    stats = conv_cf._in_stats_cf(_t(x), 1e-4)
    got = conv_cf._in_relu_bwd(_t(x), stats, _t(da))
    ref = jconv._in_relu_conv_bwd_xla(
        jnp.asarray(x), jconv._in_stats_cf(jnp.asarray(x), 1e-4),
        jnp.asarray(da))
    _assert_close(got.numpy(), ref, 1e-5, "closed form")


@pytest.mark.parametrize("name", ["conv3x3x3_cf", "depthwise_conv3x3x3"])
def test_gradcheck_float64_of_the_plain_backward_functions(name):
    """The standalone plain backward functions, written for float32/bf16
    operands, agree with numerical differentiation: the forward is rebuilt in
    float64 from the same formula and checked with torch.autograd.gradcheck,
    then its analytic gradients are held against the float32 functions."""
    rng = np.random.default_rng(6)
    if name == "conv3x3x3_cf":
        x = torch.from_numpy(rng.normal(size=(1, 2, 2, 3, 3)))
        w = torch.from_numpy(rng.normal(size=(3, 3, 3, 2, 2)) * 0.3)

        def f(x, w):
            wt = w.permute(4, 3, 0, 1, 2)
            y = torch.nn.functional.conv3d(x.permute(0, 2, 1, 3, 4), wt,
                                           padding=1)
            return y.permute(0, 2, 1, 3, 4)
    else:
        x = torch.from_numpy(rng.normal(size=(1, 2, 3, 3, 2)))
        w = torch.from_numpy(rng.normal(size=(3, 3, 3, 1, 2)) * 0.3)

        def f(x, w):
            wt = w.reshape(27, 2).t().reshape(2, 1, 3, 3, 3)
            y = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), wt,
                                           padding=1, groups=2)
            return y.permute(0, 2, 3, 4, 1)
    x.requires_grad_()
    w.requires_grad_()
    assert torch.autograd.gradcheck(f, (x, w), eps=1e-6, atol=1e-6)
    y = f(x, w)
    dy = torch.from_numpy(rng.normal(size=tuple(y.shape)))
    rx, rw = torch.autograd.grad(y, (x, w), dy)
    x32, w32, dy32 = x.detach().float(), w.detach().float(), dy.float()
    if name == "conv3x3x3_cf":
        _assert_close(conv_cf._dgrad_plain(dy32, w32).numpy(), rx, 1e-5)
        _assert_close(conv_cf._wgrad_plain(x32, dy32).numpy(), rw, 1e-5)
        # the plain forward itself
        _assert_close(conv_cf.conv3x3x3_cf(x32, w32).numpy(), y.detach(),
                      1e-5)
    else:
        dx, dw = dwconv._dw_bwd_plain(x32, w32, dy32)
        _assert_close(dx.numpy(), rx, 1e-5)
        _assert_close(dw.reshape(w.shape).numpy(), rw, 1e-5)
        _assert_close(dwconv.depthwise_conv3x3x3(x32, w32).numpy(),
                      y.detach(), 1e-5)


def test_backward_wrappers_check_their_operands():
    x = torch.zeros(1, 2, 3, 4, 5)
    with pytest.raises(ValueError):
        conv_cf.conv3x3x3_cf_wgrad(x, torch.zeros(1, 2, 6, 4, 4))
    with pytest.raises(ValueError):
        conv_cf.conv3x3x3_cf_wgrad(x, torch.zeros(1, 2, 6, 4, 5).bfloat16())
    with pytest.raises(ValueError):
        conv_cf.conv3x3x3_cf_dgrad(torch.zeros(1, 2, 6, 4, 5),
                                   torch.zeros(3, 3, 3, 3, 5))
    with pytest.raises(ValueError):
        dwconv.depthwise_conv3x3x3_bwd(x, torch.zeros(3, 3, 3, 1, 5),
                                       torch.zeros(1, 2, 3, 4, 6))


def test_wgrad_grid_sizes():
    """The number of partial sums the conv wgrad kernels are given: at
    least one, at most one per tile. The CUDA-core route's counts; the
    tensor-core route's are in test_torch_conv_routes, the depthwise
    kernels' grid in test_torch_dw_plan."""
    assert conv_cf._wgrad_splits(1, 1, 3, 5, 4, 9, "cuda_core") == 1
    assert conv_cf._wgrad_splits(1, 96, 32, 32, 96, 96, "cuda_core") == 264
    assert conv_cf._wgrad_splits(1, 48, 192, 128, 48, 48, "cuda_core") == 11
