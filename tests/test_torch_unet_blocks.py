"""UNet3D with the MBConv and FusedMBConv stage blocks against the JAX
package, on the CPU.

The JAX ``UNet3D`` takes any block of ``layers.BLOCKS``; these two have
SE gates, expansions and, at each strided first block of a down stage, a
conv shortcut, which the ResUNet and UNet cases of
``tests/test_torch_zoo.py`` do not reach. Same procedure as that file:
the JAX tree filled with seeded numpy values and carried over with
``params_from_flax``; one jitted JAX call a case for the float32 forward
and the gradient of Σ logits·r. The (20, 24, 32) input makes the stride-2
convs pad (0, 1) and (1, 1) and the depthwise convs of the strided blocks
run grouped on cuDNN, those of the others on the depthwise kernel's plain
version.

Tolerances: forward max|Δ| ≤ 1e-3·(1 + max|ref|); gradient ‖Δg‖ ≤
6e-2·(‖g‖ + 1e-3·max‖g‖) per parameter, the bound of the instance-normed
conv nets of ``tests/test_torch_zoo.py`` (and its reason).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.models import factory as jfactory
from rsuper_tpu_torch.models import get_model, load_flax_params, \
    params_from_flax
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_medformer import _unflatten, flax_params

NUM_CLASSES = 3
F32_TOL, GRAD_TOL, GRAD_FLOOR = 1e-3, 6e-2, 1e-3
SHAPE = (1, 20, 24, 32)


@pytest.mark.parametrize("block", ["MBConv", "FusedMBConv"])
def test_unet_block_matches_jax_forward_and_gradient(block):
    args = dict(base_chan=4, block=block)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(*SHAPE, 1)).astype(np.float32)
    r = rng.normal(size=(*SHAPE, NUM_CLASSES)).astype(np.float32)
    jm = jfactory.get_model("unet", NUM_CLASSES, dict(args),
                            dtype=jnp.float32)
    flat = flax_params(jm, x)

    def loss(params, x):
        y = jm.apply({"params": params}, x)["segmentation"]
        return jnp.sum(y * r), y

    (_, want_y), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True)).lower(_unflatten(flat), jnp.asarray(x)).compile(
            compiler_options={"xla_backend_optimization_level": 0})(
        _unflatten(flat), jnp.asarray(x))
    model = load_flax_params(get_model("unet", NUM_CLASSES, dict(args),
                                       dtype=torch.float32), flat)
    assert f"{block}_0" in dict(model.named_children())
    y = model(torch.from_numpy(x))["segmentation"]
    want_y = np.asarray(want_y)
    assert tuple(y.shape) == want_y.shape
    err = float(np.abs(y.detach().numpy() - want_y).max())
    assert err <= F32_TOL * (1 + float(np.abs(want_y).max()))
    (y * torch.from_numpy(r)).sum().backward()
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads),
                            model)
    top = max(float(w.norm()) for w in want.values())
    for k, p in model.named_parameters():
        err = float((p.grad - want[k]).norm())
        bound = GRAD_TOL * (float(want[k].norm()) + GRAD_FLOOR * top)
        assert err <= bound, f"{block} {k}: ‖Δ‖ {err} > {bound}"
