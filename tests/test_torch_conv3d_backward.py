"""The 3D dense conv's backward (``layers.Conv``, ``_ConvFixedOrder``:
``convolution_backward`` with cuDNN held to its deterministic algorithms)
against autograd of ``F.pad`` + ``F.conv3d`` with flax's SAME pads, in
float64 on the CPU. On the card the same Function gives the same bits
twice (``chip_smoke.py`` phantom phase, ``tools/conv3d_determinism.py``)."""

import pytest
import torch
import torch.nn.functional as F

from rsuper_tpu_torch.models import layers

CONVS = {  # (c_in, features, kernel, stride, groups, input (D, H, W))
    "k3": (3, 5, 3, 1, 1, (9, 8, 7)),
    "k3s2_even": (3, 5, 3, 2, 1, (8, 8, 6)),
    "k3s2_odd": (3, 5, 3, 2, 1, (9, 7, 5)),
    "k1": (4, 6, 1, 1, 1, (5, 6, 7)),
    "k2s2": (2, 4, 2, 2, 1, (6, 8, 4)),
    "grouped": (6, 6, 3, 1, 3, (7, 5, 6)),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_conv3d_backward_equals_autograd_of_conv3d(name):
    c_in, c, k, s, groups, (d, h, w) = CONVS[name]
    g = torch.Generator().manual_seed(0)
    conv = layers.Conv(c_in, c, k, s, True, torch.float64, groups).double()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        conv.bias.copy_(torch.randn(c, generator=g))
    x = torch.randn((2, d, h, w, c_in), dtype=torch.float64, generator=g)
    xa = x.clone().requires_grad_()
    y = conv(xa)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    y.backward(gy)
    got = [xa.grad, conv.weight.grad, conv.bias.grad]
    xb = x.clone().requires_grad_()
    wb = conv.weight.detach().clone().requires_grad_()
    bb = conv.bias.detach().clone().requires_grad_()
    pads = [p for n in (w, h, d) for p in layers.same_pads(n, k, s)]
    ref = F.conv3d(F.pad(xb.movedim(-1, 1), pads), wb, bb, s,
                   groups=groups).movedim(1, -1)
    assert float((y.detach() - ref.detach()).abs().max()) <= 1e-12
    ref.backward(gy)
    for a, b in zip(got, [xb.grad, wb.grad, bb.grad]):
        assert float((a - b).abs().max()) <= 1e-12 * (
            1 + float(b.abs().max())), name


def test_cudnn_flag_is_restored_after_the_backward():
    """The backward sets cuDNN's deterministic flag for its call only."""
    conv = layers.Conv(2, 3, 3, 1, False)
    before = torch.backends.cudnn.deterministic
    conv(torch.randn(1, 4, 4, 4, 2, requires_grad=True)).sum().backward()
    assert torch.backends.cudnn.deterministic == before
    assert conv.weight.grad is not None
