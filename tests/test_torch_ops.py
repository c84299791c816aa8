"""The PyTorch port's kernel ops against the JAX package, on the CPU.

Each op of ``rsuper_tpu_torch/ops`` that holds a CUDA kernel runs here
through its plain PyTorch version (the tensors lie on the CPU) and is held
against the JAX public function on the same numpy inputs: once through its
XLA path and once through the Pallas kernel bodies in interpret mode.

Tolerances, as max|Δ| ≤ tol·(1 + max|ref|):
* float32: 1e-4 — the two sides sum the same 27·C_in products in another
  order;
* bfloat16: 2e-2 — both round the output once to bf16 (about 3 significant
  digits), and the Pallas/XLA sides may round partial sums differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.ops import conv_cf as jconv
from rsuper_tpu.ops import dwconv as jdw
from rsuper_tpu.ops import morphology as jmorph
from rsuper_tpu_torch.ops import conv_cf, dispatch, dwconv, morphology

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _assert_close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    bound = tol * (1.0 + float(np.abs(ref).max()))
    assert err <= bound, f"max|Δ| {err} > {bound}"


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(JDT[dtype])


def _out(t):
    return t.float().numpy()


# (B, D, C_in, H, W, C_out): the stem's C_in = 1, odd non-cubic planes, a
# one-voxel-deep volume, and a paired C_out (two kernels stacked along C_out)
CONV_CASES = [
    (1, 4, 1, 6, 8, 4),
    (2, 3, 5, 5, 7, 6),
    (1, 1, 3, 4, 9, 5),
    (1, 4, 3, 6, 6, 8),
]


def _conv_inputs(case, seed):
    B, D, Ci, H, W, Co = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D, Ci, H, W)).astype(np.float32) * 2.0 + 0.5
    if Co == 8:  # paired: ConvNormAct_0 and the shortcut's kernels stacked
        w = np.concatenate([rng.normal(size=(3, 3, 3, Ci, 4)),
                            rng.normal(size=(3, 3, 3, Ci, 4))], axis=-1)
    else:
        w = rng.normal(size=(3, 3, 3, Ci, Co))
    return x, (w / np.sqrt(27 * Ci)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv3x3x3_cf_matches_jax(case, dtype):
    x, w = _conv_inputs(case, 0)
    before = conv_cf.conv3x3x3_cf.launches
    got = conv_cf.conv3x3x3_cf(_t(x, dtype), _t(w))
    assert conv_cf.conv3x3x3_cf.launches == before  # CPU: plain version
    assert got.dtype == TDT[dtype]
    ref = jconv.conv3x3x3_cf(_j(x, dtype), jnp.asarray(w))
    _assert_close(_out(got), ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_in_relu_conv3x3x3_cf_matches_jax(case, dtype):
    x, w = _conv_inputs(case, 1)
    before = conv_cf.in_relu_conv3x3x3_cf.launches
    got = conv_cf.in_relu_conv3x3x3_cf(_t(x, dtype), _t(w))
    assert conv_cf.in_relu_conv3x3x3_cf.launches == before
    ref = jconv.in_relu_conv3x3x3_cf(_j(x, dtype), jnp.asarray(w))
    _assert_close(_out(got), ref, TOL[dtype])


@pytest.mark.parametrize("case", [CONV_CASES[0], CONV_CASES[1], CONV_CASES[3]])
def test_conv_cf_matches_pallas_interpret(case):
    """Both conv functions against the Pallas kernel bodies (interpret mode),
    float32."""
    x, w = _conv_inputs(case, 2)
    got = conv_cf.conv3x3x3_cf(_t(x), _t(w))
    ref = jconv.conv3x3x3_cf(jnp.asarray(x), jnp.asarray(w),
                             force_pallas=True, interpret=True)
    _assert_close(_out(got), ref, TOL["float32"])
    got = conv_cf.in_relu_conv3x3x3_cf(_t(x), _t(w))
    ref = jconv.in_relu_conv3x3x3_cf(jnp.asarray(x), jnp.asarray(w),
                                     force_pallas=True, interpret=True)
    _assert_close(_out(got), ref, TOL["float32"])


def test_in_stats_cf_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 3, 4, 6)) * 3.0 + 1.0).astype(np.float32)
    x[1, :, 2] = 7.0  # a constant channel: var clamps at 0
    got = conv_cf._in_stats_cf(_t(x), 1e-4)
    ref = jconv._in_stats_cf(jnp.asarray(x), 1e-4)
    assert tuple(got.shape) == tuple(ref.shape) == (2, 2, 3, 1)
    _assert_close(got.numpy(), ref, 1e-5)


# (B, D, H, W, C): odd C (the TPU gate refused C % 128 != 0; the port's
# kernel takes any C), volume edges in every axis, C = 128 for interpret mode
DW_CASES = [(1, 3, 4, 5, 3), (2, 4, 6, 4, 8), (1, 1, 2, 7, 20),
            (1, 3, 4, 6, 128)]


def _dw_inputs(case, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=case).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 1, case[-1])) * 0.2).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DW_CASES)
def test_depthwise_conv3x3x3_matches_jax(case, dtype):
    x, w = _dw_inputs(case, 4)
    before = dwconv.depthwise_conv3x3x3.launches
    got = dwconv.depthwise_conv3x3x3(_t(x, dtype), _t(w))
    assert dwconv.depthwise_conv3x3x3.launches == before
    assert got.dtype == TDT[dtype]
    ref = jdw.depthwise_conv3x3x3(_j(x, dtype), jnp.asarray(w))
    _assert_close(_out(got), ref, TOL[dtype])


def test_depthwise_matches_pallas_interpret():
    x, w = _dw_inputs(DW_CASES[-1], 5)
    assert jdw.dw_supported(x.shape, jnp.float32)
    got = dwconv.depthwise_conv3x3x3(_t(x), _t(w))
    ref = jdw.depthwise_conv3x3x3(jnp.asarray(x), jnp.asarray(w),
                                  force_pallas=True, interpret=True)
    _assert_close(_out(got), ref, TOL["float32"])


@pytest.mark.parametrize("k", [1, 3, 4, 7])
def test_dilate_cube_cf_matches_jax(k):
    rng = np.random.default_rng(6)
    x = (rng.random((2, 9, 7, 11)) > 0.93).astype(np.float32)
    got = morphology.dilate_cube_cf(_t(x), k)
    ref = jmorph.dilate_cube_cf(jnp.asarray(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_op_shape_checks_raise():
    x = torch.zeros(1, 2, 3, 4, 5)
    with pytest.raises(ValueError):
        conv_cf.conv3x3x3_cf(x, torch.zeros(3, 3, 3, 4, 2))
    with pytest.raises(TypeError):
        conv_cf.conv3x3x3_cf(x.double(), torch.zeros(3, 3, 3, 3, 2))
    with pytest.raises(ValueError):
        dwconv.depthwise_conv3x3x3(x, torch.zeros(3, 3, 3, 1, 4))


def test_dispatch_follows_the_device():
    cpu = torch.zeros(2)
    assert dispatch.use_kernel(cpu, cpu) is False
    with dispatch.plain_on_device():
        assert dispatch.use_kernel(cpu) is False
    with pytest.raises(ValueError):  # no kernel for another device type
        dispatch.use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):  # operands on two devices
        dispatch.use_kernel(cpu, torch.zeros(2, device="meta"))
