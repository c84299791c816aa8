"""``python -m rsuper_tpu_torch.export_checkpoint`` against the JAX package's
``export_state_dict`` (``tools/export_torch_checkpoint.py``), on the CPU.

Seeded flax parameters of the JAX MedFormer (shapes from one
``jax.eval_shape`` of its ``init`` a configuration: nothing is compiled)
are carried onto a port model and saved as a port checkpoint; the export
of that checkpoint must be bit-equal to the JAX ``export_state_dict`` of
the same parameters, and ``convert_checkpoint`` of the export must give
the checkpoint's parameters back bit for bit. Two configurations: the
default MedFormer, and small widths with ``--classification --clip
--no_aux``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.models import torch_port as jtp
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu_torch import convert_checkpoint, export_checkpoint
from rsuper_tpu_torch.models import get_model, params_from_flax
from rsuper_tpu_torch.train.checkpoint import _write, load_params, save_params

CLASSES = 4
SMALL = dict(  # tests/test_torch_pth_import.py's TINY widths (copied)
    base_chan=4, chan_num=(8, 16, 32, 40, 32, 16, 8, 4),
    conv_num=(2, 0, 0, 0, 0, 0, 2, 2), trans_num=(0, 1, 2, 1, 1, 1, 0, 0),
    num_heads=(1, 2, 2, 2, 2, 2, 1, 1), fusion_depth=1, fusion_dim=40,
    fusion_heads=2, expansion=4)
HEADS = dict(classification_classes=3, clip_branch=True, aux_loss=False)
ARCH = ("base_chan", "chan_num", "conv_num", "trans_num", "num_heads",
        "fusion_depth")
CONFIGS = {"default": ({}, []),
           "heads": ({**SMALL, **HEADS},
                     ["--classification", "--clip", "--no_aux"])}


def _flags(margs, extra):
    out = []
    for k in ARCH:
        if k in margs:
            v = margs[k]
            out += [f"--{k}", ",".join(map(str, v)) if isinstance(v, tuple)
                    else str(v)]
    return out + extra


def _keymap(margs):
    kw = {k: margs[k] for k in ARCH if k in margs}
    return dict(kw, aux_loss=margs.get("aux_loss", True),
                classification=bool(margs.get("classification_classes")),
                clip=margs.get("clip_branch", False))


def _seeded_flax(margs, seed=0):
    """Seeded flax parameters (nested) of the JAX MedFormer `margs`."""
    from flax.traverse_util import unflatten_dict

    model = JaxMedFormer(CLASSES, dtype=jnp.float32, remat=False, **margs)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 32, 1)))["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = tuple(str(getattr(p, "key", p)) for p in path)
        scale = 0.1 if key[-1] in ("bias", "scale") else \
            1 / np.sqrt(max(1, np.prod(leaf.shape[:-1])))
        flat[key] = (rng.normal(size=leaf.shape) * scale).astype(np.float32)
    return unflatten_dict(flat)


@pytest.fixture(scope="module", params=list(CONFIGS))
def saved(request, tmp_path_factory):
    """(configuration, its flax tree, a port checkpoint directory of it,
    the port's state_dict, the JAX export)."""
    margs, extra = CONFIGS[request.param]
    tree = _seeded_flax(margs)
    model = get_model("medformer", CLASSES, {**margs, "remat": False})
    state = params_from_flax(tree, model)
    model.load_state_dict(state, strict=True)
    ckpt = tmp_path_factory.mktemp(f"ckpt_{request.param}")
    save_params(str(ckpt), state)
    want = jtp.export_state_dict(tree, **_keymap(margs))
    return margs, extra, ckpt, state, want


def test_export_npz_is_the_jax_export_bit_for_bit(saved, tmp_path):
    margs, extra, ckpt, _, want = saved
    out = tmp_path / "sd.npz"
    got = export_checkpoint.main([str(ckpt), "best", str(out)]
                                 + _flags(margs, extra))
    with np.load(out) as z:
        written = {k: z[k] for k in z.files}
    assert sorted(written) == sorted(want) == sorted(got)
    assert len(want) > 100
    for k, v in want.items():
        assert written[k].dtype == np.float32 and written[k].shape == v.shape
        np.testing.assert_array_equal(written[k], v, err_msg=k)


def test_export_then_convert_round_trips(saved, tmp_path):
    """``.pth`` export → ``convert_checkpoint`` → the checkpoint's
    parameters, bit for bit."""
    margs, extra, ckpt, state, want = saved
    pth = tmp_path / "model.pth"
    export_checkpoint.main([str(ckpt), "best", str(pth)]
                           + _flags(margs, extra))
    raw = torch.load(pth, weights_only=True)
    assert list(raw) == ["model_state_dict"]
    assert sorted(raw["model_state_dict"]) == sorted(want)
    back = tmp_path / "back"
    convert_checkpoint.main(
        [str(pth), str(back)] + _flags(margs, extra)
        + (["--fusion_dim", "40", "--fusion_heads", "2"] if margs else []))
    got = load_params(str(back))
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k


def test_export_ema(saved, tmp_path):
    """``--ema`` exports a checkpoint's EMA copy (here the parameters
    halved), and raises on a checkpoint without one."""
    margs, extra, ckpt, state, want = saved
    with pytest.raises(ValueError, match="EMA"):
        export_checkpoint.main([str(ckpt), "best", str(tmp_path / "x.npz"),
                                "--ema"] + _flags(margs, extra))
    _write(str(tmp_path / "latest"), {
        "params": state, "ema_params": {k: v / 2 for k, v in state.items()}})
    got = export_checkpoint.main([str(tmp_path), "latest",
                                  str(tmp_path / "e.npz"), "--ema"]
                                 + _flags(margs, extra))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v / 2, err_msg=k)
