"""Warm starts of the port (``train/checkpoint.py`` ``parse_class_list``
and ``load_pretrained_params``, ``models/surgery.py``) against the JAX
package's, on the CPU, at a small MedFormer (the widths of
``tests/test_torch_predict.py``).

A donor trained on OLD classes warm-starts a model of NEW classes (three
shared, in other positions; one new; two dropped). Donors: a port checkpoint
directory (``CheckpointManager``'s ``best``) and an ``.npz`` of flax
parameters (``tools/export_params_npz.py``'s layout); the JAX package reads
the same parameters from an orbax checkpoint. Every tensor of the port's
result equals the JAX result carried across by ``params_from_flax``, bit
for bit, with and without class surgery; the EMA copy keeps its fresh
initialisation in both. The class lists parse alike, also without PyYAML.
"""

import dataclasses
import json
import logging
import shutil
import sys
from typing import Any

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.models import surgery as jsurgery
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu.train import checkpoint as jckpt
from rsuper_tpu_torch.models import get_model, load_flax_params, surgery
from rsuper_tpu_torch.models.params import params_from_flax
from rsuper_tpu_torch.train import checkpoint as ckpt
from rsuper_tpu_torch.train.optim import make_optimizer
from rsuper_tpu_torch.train.state import create_train_state
from test_torch_loop import (_one_intra_op_thread,  # noqa: F401
                             _port_model, _same_state, _train_port,
                             _write_cases)
from test_torch_predict import TINY, _flax_params

OLD = ["kidney_left", "liver", "pancreas", "pancreatic_lesion", "spleen"]
NEW = ["aorta", "kidney_left", "liver", "pancreatic_lesion"]


@dataclasses.dataclass
class _JaxState:
    """What the JAX ``load_pretrained_params`` reads and replaces."""
    params: Any
    ema_params: Any = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _tree(flat):
    from flax.traverse_util import unflatten_dict

    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


def _flat_of(tree):
    from flax.traverse_util import flatten_dict

    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(tree["params"]).items()}


@pytest.fixture(scope="module")
def flats():
    """(donor's flax parameters at OLD, fresh ones at NEW)."""
    x = np.zeros((1, 32, 32, 32, 1), np.float32)
    return (_flax_params(JaxMedFormer(len(OLD), dtype=jnp.float32, **TINY),
                         x, seed=1),
            _flax_params(JaxMedFormer(len(NEW), dtype=jnp.float32, **TINY),
                         x, seed=2))


def _state(flat, n):
    model = load_flax_params(get_model("medformer", n, dict(TINY),
                                       dtype=torch.float32), flat)
    return create_train_state(model, make_optimizer(model.parameters()))


@pytest.mark.parametrize("spec", ["pancreas, liver,aorta", "list.json",
                                  "list.yaml", "wrapped.json", "map.json"])
@pytest.mark.parametrize("yaml_present", [True, False])
def test_parse_class_list_matches_jax(tmp_path, monkeypatch, spec,
                                      yaml_present):
    names = ["spleen", "aorta", "liver"]
    (tmp_path / "list.json").write_text(json.dumps(names))
    (tmp_path / "list.yaml").write_text("- spleen\n- aorta\n- liver\n")
    (tmp_path / "wrapped.json").write_text(json.dumps({"classes": names}))
    (tmp_path / "map.json").write_text(json.dumps({"liver": 0, "aorta": 1}))
    if not yaml_present:
        monkeypatch.setitem(sys.modules, "yaml", None)
    arg = str(tmp_path / spec) if spec.endswith(("json", "yaml")) else spec
    if spec == "map.json" or (spec == "list.yaml" and not yaml_present):
        for parse in (ckpt.parse_class_list, jckpt.parse_class_list):
            with pytest.raises(ValueError):
                parse(arg)
        return
    got = ckpt.parse_class_list(arg)
    assert got == jckpt.parse_class_list(arg) == sorted(got)


@pytest.mark.parametrize("direction", ["old_to_new", "new_to_old"])
def test_update_output_layers_matches_jax(flats, direction):
    old, new = flats
    old_classes, new_classes = OLD, NEW
    if direction == "new_to_old":
        old, new, old_classes, new_classes = new, old, NEW, OLD
    want = jsurgery.update_output_layers(_tree(new), _tree(old), old_classes,
                                         new_classes)
    got = surgery.update_output_layers(params_from_flax(new),
                                       params_from_flax(old), old_classes,
                                       new_classes)
    want = params_from_flax(_flat_of(want))
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # the head rows: shared classes from the donor's row, the rest fresh
    w_old, w_new = params_from_flax(old), params_from_flax(new)
    heads = [k for k in got if k.split(".")[0] in surgery.HEADS]
    assert {"outc.weight", "outc.bias"} <= set(heads)
    for key in heads:
        for j, cls in enumerate(new_classes):
            src = (w_old[key][old_classes.index(cls)]
                   if cls in old_classes else w_new[key][j])
            assert torch.equal(got[key][j], src), (key, cls)


@pytest.mark.parametrize("donor", ["checkpoint", "npz"])
@pytest.mark.parametrize("classes", ["surgery", "non_strict"])
def test_load_pretrained_params_matches_jax(flats, tmp_path, donor, classes,
                                            caplog):
    import orbax.checkpoint as ocp

    old, new = flats
    ocp.PyTreeCheckpointer().save(str(tmp_path / "jax" / "best"),
                                  {"params": _tree(old)})
    old_classes = OLD if classes == "surgery" else None
    want = jckpt.load_pretrained_params(
        _JaxState(params=_tree(new)), str(tmp_path / "jax"),
        old_classes=old_classes, new_classes=NEW).params
    want = params_from_flax(_flat_of(want))

    if donor == "checkpoint":
        donor_state = _state(old, len(OLD))
        ckpt.CheckpointManager(str(tmp_path / "port")).save_epoch(
            donor_state, 0, metric=1.0)
        path = str(tmp_path / "port")
    else:
        path = str(tmp_path / "params.npz")
        np.savez(path, **old)
    state = _state(new, len(NEW))
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    with caplog.at_level(logging.INFO, logger="rsuper"):
        out = ckpt.load_pretrained_params(state, path,
                                          old_classes=old_classes,
                                          new_classes=NEW)
    assert out is state
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(ema[k], state.ema_params[k]) for k in ema)
    text = caplog.text
    if classes == "surgery":
        assert "4 new classes (3 shared)" in text
    else:  # every tensor but the heads' weights and biases
        assert f"{len(got) - 4}/{len(got)} parameter tensors matched" in text


def test_an_unreadable_or_unmatched_donor_keeps_the_fresh_init(flats,
                                                               tmp_path,
                                                               caplog):
    _, new = flats
    state = _state(new, len(NEW))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    (tmp_path / "junk").mkdir()
    (tmp_path / "junk" / "best").write_text("not a checkpoint")
    np.savez(tmp_path / "other.npz", **{"Dense_0/kernel": np.ones((2, 3))})
    with caplog.at_level(logging.INFO, logger="rsuper"):
        for path in (tmp_path / "missing", tmp_path / "junk"):
            ckpt.load_pretrained_params(state, str(path))
        assert caplog.text.count("pretrained load failed") == 2
        ckpt.load_pretrained_params(state, str(tmp_path / "other.npz"))
    assert "WARNING" in caplog.records[-1].levelname
    assert "0/" in caplog.records[-1].getMessage()
    after = state.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_the_loop_loads_pretrained_before_resume(tmp_path):
    """A resumed run with `pretrained` set equals the resumed run without:
    the warm start comes first and the checkpoint overwrites it. The first
    run took a warm start from a donor's `best`."""
    data = _write_cases(tmp_path / "cases")
    model = _port_model(seed=5)
    ckpt.CheckpointManager(str(tmp_path / "donor")).save_epoch(
        create_train_state(model, make_optimizer(model.parameters())), 0,
        metric=1.0)
    warm = {"pretrained": str(tmp_path / "donor")}
    _train_port(data, tmp_path / "a", max_steps=1, cfg=warm)
    assert "loaded pretrained" in (tmp_path / "a" / "test" /
                                   "train.log").read_text()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    both = _train_port(data, tmp_path / "a", max_steps=1,
                       cfg={"resume": True, **warm})
    plain = _train_port(data, tmp_path / "b", max_steps=1,
                        cfg={"resume": True})
    assert both.step == plain.step == 2
    _same_state(both, plain)
