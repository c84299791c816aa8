"""The port's copy of the reference's kernel signatures
(``rsuper_tpu_torch/ops/reference_shapes.py``) against the JAX package's
trace (``rsuper_tpu/ops/trace_shapes.py``), on the CPU.

``collect_signatures`` traces the default MedFormer's training step
abstractly (``jax.eval_shape``: nothing is compiled), at 96³ and at 128³;
each size takes about 45 s of one core, so the two run in two processes at
once, and the union is deduplicated as ``production_signatures`` does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from rsuper_tpu.ops import trace_shapes
from rsuper_tpu_torch.ops import reference_shapes

ROOT = Path(__file__).resolve().parent.parent
KERNEL_ROWS = {"conv3x3x3_cf", "in_relu_conv3x3x3_cf", "conv3x3x3_cf_wgrad",
               "in_relu_conv3x3x3_cf_wgrad", "depthwise_conv3x3x3",
               "depthwise_conv3x3x3_bwd"}
TRACE = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from rsuper_tpu.ops import trace_shapes
print(json.dumps(trace_shapes.collect_signatures(int(sys.argv[1]))))
"""


def _key(sig):
    """A traced signature as the port's copy writes it."""
    if sig["op"] == "dwconv":
        return ("dwconv", sig["kind"], False,
                (sig["B"], sig["D"], sig["H"], sig["W"], sig["C"]),
                sig["dtype"])
    return ("conv_cf", sig["kind"], sig["fused"],
            (sig["B"], sig["D"], sig["Ci"], sig["H"], sig["W"], sig["Co"]),
            sig["dtype"])


@pytest.fixture(scope="module")
def traced():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", TRACE, str(size)],
                              env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for size in (96, 128)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    sigs = [s for out, _ in outs for s in json.loads(out.splitlines()[-1])]
    return trace_shapes.dedupe(sigs)


def test_the_copy_is_the_jax_packages_trace(traced):
    """Every signature ``production_signatures`` gives, in its order, and
    no other; two that the JAX package tells apart by their TPU tiling
    alone would be one here, and there are none."""
    assert [_key(s) for s in traced] == list(reference_shapes.SIGNATURES)
    assert len(set(reference_shapes.SIGNATURES)) == len(traced)


def test_every_signature_names_a_kernel_row():
    rows = reference_shapes.rows()
    assert len(rows) == len(reference_shapes.SIGNATURES)
    for name, shape, dtype in rows:
        assert name in KERNEL_ROWS
        assert len(shape) == (5 if name.startswith("depthwise") else 6)
        assert dtype in ("bfloat16", "float32")
    # both directions of both kernel families
    assert {name for name, _, _ in rows} == KERNEL_ROWS
