"""CLIP pretraining and the classification branch of the port against the
JAX package, on the CPU: the organ sampler, the crop organs, the report
embeddings of each record, symmetric InfoNCE, the classification loss, both
modes of ``calculate_loss`` and MedFormer's two encoder heads.

The same numpy inputs go through both packages. Tolerances:
* ``OrganBatchSampler``, ``crop_organs`` and ``ClipRecordAdapter``: equal
  (the same ``default_rng`` draws; the same strings and arrays);
* ``info_nce``/``symmetric_info_nce`` and ``classification_loss``: float32
  on both sides, value and gradient within 1e-6 relative (max|Δ| ≤
  1e-6·max|ref| + 1e-9 for gradients);
* ``calculate_loss``: the value tolerance of ``tests/test_torch_losses.py``
  (1e-5 relative), sums over the volume in another order;
* the small MedFormer with both heads (``TINY`` of
  ``tests/test_torch_medformer.py``, ``classification_classes=2``,
  ``clip_branch=True``, ``clip_feats=16``, float32), at 32³, where the
  heads' patch merge leaves one voxel, and at 64³, where it leaves 8: every
  output within the forward tolerance of ``tests/test_torch_medformer.py``
  (max|Δ| ≤ 1e-3·(1 + max|ref|)); at 64³ the gradients of a CLIP step's
  loss within the gradient tolerance of ``tests/test_torch_train.py`` (per
  parameter ‖Δ‖ ≤ 2e-3·(‖ref‖ + 1e-3·max‖ref‖)); the encoder-only CLIP step
  equal to the full forward's loss and gradients bit for bit. At 32³ the
  one-voxel head's gradients are held finite, port only.
* The CLIP train step (port only): every parameter the loss does not reach
  updates with a zero gradient, so AdamW decays it, as the JAX step's
  gradient of the whole tree does.

The JAX parameters are built once a module; one jitted JAX function a size
gives the outputs (32³) or the outputs and the CLIP gradients (64³).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsuper_tpu.data import clip as jclip
from rsuper_tpu.data import dataset as jds
from rsuper_tpu.data import reports as jrep
from rsuper_tpu.data.sampler import OrganBatchSampler as JOrganBatchSampler
from rsuper_tpu.losses import classification as jcls
from rsuper_tpu.losses import dispatcher as jdisp
from rsuper_tpu.losses import info_nce as jnce
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu_torch.data import clip
from rsuper_tpu_torch.data import dataset as ds
from rsuper_tpu_torch.data import reports as rep
from rsuper_tpu_torch.data.sampler import OrganBatchSampler
from rsuper_tpu_torch.losses import (LossConfig, calculate_loss,
                                     classification_loss, info_nce,
                                     symmetric_info_nce)
from rsuper_tpu_torch.losses.info_nce import _l2norm
from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                     init_params, load_flax_params,
                                     params_from_flax)
from rsuper_tpu_torch.train import build_train_step, loss_fn
from rsuper_tpu_torch.train.optim import make_optimizer
from rsuper_tpu_torch.train.state import create_train_state
from test_torch_losses import DATA, LMAP_J, LMAP_T, _check_value, _j, _t
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_medformer import F32_TOL, TINY, _unflatten, flax_params
from test_torch_train import GRAD_FLOOR, GRAD_TOL

NCE_TOL = 1e-6
HEADS = dict(classification_classes=2, clip_branch=True, clip_feats=16)
NUM_CLASSES = 3


# ----------------------------------------------------------------- sampler
@pytest.mark.parametrize("organs,batch,shards", [
    (["a", "b", "a", "c", "b", "a", "a", "c"], 4, 1),
    (["mask"] * 3 + ["pancreas"] * 9 + ["healthy"] * 2, 6, 2),
    (["liver", "kidney", "liver"], 4, 2),  # pools smaller than the batch
    (["x"], 2, 1),
])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_organ_batch_sampler_matches_jax(organs, batch, shards, seed):
    for shard in range(shards):
        a = OrganBatchSampler(organs, batch, seed=seed, shard=shard,
                              num_shards=shards)
        b = JOrganBatchSampler(organs, batch, seed=seed, shard=shard,
                               num_shards=shards)
        assert a.organs == b.organs
        for step in range(12):
            np.testing.assert_array_equal(a.batch(step), b.batch(step))
            assert len({organs[i] for i in a.batch(step)}) == 1
        for epoch in range(3):
            np.testing.assert_array_equal(a.epoch_indices(epoch, 4),
                                          b.epoch_indices(epoch, 4))


# ------------------------------------------------------------- crop organs
ORGAN_ROWS = [  # (case, Standardized Organ) with blanks, NaN-like cells, ties
    ("R0", "pancreas"), ("R0", "Kidney"), ("R0", "kidney "),
    ("R1", "liver"), ("R1", "pancreas"),  # a tie: the first by name wins
    ("R2", ""), ("R2", "NA"), ("R2", "  "),  # nothing usable: healthy
    ("R3", "nan"), ("R3", "Spleen"), ("R3", "None"),
    ("R4", "null"), ("R4", "kidney"), ("R4", "liver"), ("R4", "Liver"),
    ("R5", "N/A"),
    ("R6", "liver"), ("R6", "kidney"), ("R6", "pancreas"),
]


def _organ_csv(path, rows=ORGAN_ROWS):
    with open(path, "w") as f:
        f.write("BDMAP_ID,Standardized Organ,Standardized Location,"
                "Tumor Size (mm),Unknow Tumor Size,no lesion\n")
        for cid, organ in rows:
            f.write(f"{cid},{organ},u,12,no,0\n")
    return str(path)


@pytest.mark.parametrize("numeric_column", [False, True])
def test_crop_organs_match_jax(tmp_path, numeric_column):
    rows = ORGAN_ROWS if not numeric_column else [  # a column of numbers
        ("R0", "1"), ("R1", "2"), ("R1", ""), ("R2", "3.5")]
    path = _organ_csv(tmp_path / "r.csv", rows)
    ids = sorted({c for c, _ in rows}) + ["R9"]  # R9: a report case, no rows
    mask = [(f"M{k}", f"M{k}.npz") for k in range(2)]
    report = [(c, f"{c}.npz") for c in ids]
    cfg = dict(classes=("background", "liver"), report_classes=("liver",))
    got = ds.RSuperDataset(ds.build_case_list(mask, report, seed=0),
                           ds.RSuperDataConfig(**cfg),
                           report_rows=rep.load_reports(path))
    want = jds.RSuperDataset(jds.build_case_list(mask, report, seed=0),
                             jds.RSuperDataConfig(**cfg),
                             report_rows=jrep.load_reports(path))
    organs = got.crop_organs()
    assert organs == want.crop_organs()
    assert len(organs) == len(got.cases)
    if not numeric_column:
        tags = dict(zip([c.case_id for c in got.cases], organs))
        assert tags["M0"] == "mask" and tags["R9"] == "healthy"
        assert tags["R0"] == "kidney" and tags["R1"] == "liver"
        assert tags["R2"] == tags["R5"] == "healthy"
        assert tags["R3"] == "spleen" and tags["R4"] == "liver"
    # no report table at all: every report case is healthy
    bare = ds.RSuperDataset(got.cases, ds.RSuperDataConfig(**cfg))
    assert bare.crop_organs() == jds.RSuperDataset(
        want.cases, jds.RSuperDataConfig(**cfg)).crop_organs()


# ------------------------------------------------------ report embeddings
class _Records:
    """A stand-in dataset: record `i` is a seeded array; three cases."""

    def __init__(self, module):
        self.cases = [module.Case(f"C{k}", "", True) for k in range(3)]

    def __len__(self):
        return 5  # indices wrap around the cases

    def sample(self, index, rng=None):
        return {"image": np.full((2, 2, 2), index, np.float32)}

    def crop_organs(self):
        return ["a", "b", "a"]


def test_clip_record_adapter_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "C0.npy", rng.normal(size=8).astype(np.float32))
    np.save(tmp_path / "C2.npy", rng.normal(size=8))  # float64 on disk
    got = clip.ClipRecordAdapter(_Records(ds), clip.ReportEmbeddingStore(
        str(tmp_path)), dim=8)
    want = jclip.ClipRecordAdapter(_Records(jds), jclip.ReportEmbeddingStore(
        str(tmp_path)), dim=8)
    assert len(got) == len(want) == 5
    assert got.crop_organs() == want.crop_organs()
    for i in range(5):
        a, b = got.sample(i), want.sample(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert a["report_embedding"].dtype == np.float32
        assert a["report_embedding"].shape == (8,)
    assert not got.sample(1)["report_embedding"].any()  # C1: no file


# ---------------------------------------------------------------- InfoNCE
def _nce_inputs(zero_rows):
    rng = np.random.default_rng(3)
    ct = rng.normal(size=(5, 12)).astype(np.float32)
    rp = rng.normal(size=(5, 12)).astype(np.float32)
    if zero_rows:
        ct[1] = 0.0  # a one-voxel head's exact zero
        rp[3] = 0.0  # a case without an embedding
    return ct, rp


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all(), what
    tol = NCE_TOL * np.abs(ref).max() + 1e-9
    assert np.abs(got - ref).max() <= tol, (what, got, ref)


@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("which", ["info_nce", "symmetric"])
def test_info_nce_matches_jax(which, zero_rows):
    ct, rp = _nce_inputs(zero_rows)
    port = info_nce if which == "info_nce" else symmetric_info_nce
    ref_fn = jnce.info_nce if which == "info_nce" else jnce.symmetric_info_nce
    a = torch.from_numpy(ct).requires_grad_()
    b = torch.from_numpy(rp).requires_grad_()
    loss = port(a, b)
    loss.backward()
    ref, (ga, gb) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(ct), jnp.asarray(rp))
    assert loss.dtype == torch.float32
    _close(loss.item(), float(ref), "value")
    _close(a.grad.numpy(), ga, "grad ct")
    _close(b.grad.numpy(), gb, "grad report")
    if zero_rows:  # the guard: a zero row's gradient is finite and not 0/0
        assert np.abs(a.grad.numpy()[1]).max() > 0


def test_l2norm_matches_jax_at_zero_tiny_and_unit_rows():
    """The guarded normalisation: a zero row, a row shorter than eps and
    ordinary rows, value and gradient."""
    x = np.zeros((4, 6), np.float32)
    x[1, 2] = 1e-13
    x[2:] = np.random.default_rng(4).normal(size=(2, 6))
    up = np.arange(24, dtype=np.float32).reshape(4, 6) / 24
    t = torch.from_numpy(x).requires_grad_()
    got = _l2norm(t)
    (got * torch.from_numpy(up)).sum().backward()
    ref, vjp = jax.vjp(jnce._l2norm, jnp.asarray(x))
    _close(got.detach().numpy(), ref, "value")
    _close(t.grad.numpy(), vjp(jnp.asarray(up))[0], "grad")


# ------------------------------------------------------ classification loss
@pytest.mark.parametrize("unk,segment,weights", [
    (True, True, False), (False, False, False), (True, False, True),
    (False, True, True)])
def test_classification_loss_matches_jax(unk, segment, weights):
    rng = np.random.default_rng(5)
    nc = len(LMAP_T.lesion_class_indices())
    logits = (2 * rng.normal(size=(2, nc))).astype(np.float32)
    w = (0.5 + rng.random((2, nc))).astype(np.float32) if weights else None
    args = [DATA["label"], DATA["unk"] if unk else None,
            DATA["segment_mask"] if segment else None]
    x = torch.from_numpy(logits).requires_grad_()
    got = classification_loss(x, *[None if a is None else _t(a) for a in args],
                              LMAP_T, None if w is None else _t(w))
    got.backward()

    def ref_fn(v):
        return jcls.classification_loss(
            v, *[None if a is None else _j(a) for a in args], LMAP_J,
            None if w is None else _j(w))

    ref, g = jax.value_and_grad(ref_fn)(jnp.asarray(logits))
    _close(got.item(), float(ref), "value")
    _close(x.grad.numpy(), g, "grad")


# ------------------------------------------------------------ calculate_loss
def test_calculate_loss_clip_only_matches_jax():
    ct, rp = _nce_inputs(True)
    got = calculate_loss({"clip": _t(ct)}, None, None, None, None, None,
                         LMAP_T, clip_only=True, report_embeddings=_t(rp))
    ref = jdisp.calculate_loss({"clip": _j(ct)}, None, None, None, None, None,
                               LMAP_J, clip_only=True,
                               report_embeddings=_j(rp))
    assert sorted(got) == sorted(ref) == ["contrastive_loss", "overall"]
    for k in ref:
        _check_value(got[k].item(), float(ref[k]), "float32", k)


def test_calculate_loss_classification_branch_matches_jax():
    rng = np.random.default_rng(6)
    nc = len(LMAP_T.lesion_class_indices())
    cls_logits = rng.normal(size=(2, nc)).astype(np.float32)
    kw = dict(loss="dice", classification_branch=True)
    args = [DATA[k] for k in ("label", "unk", "segment_mask", "volumes",
                              "diameters")]
    got = calculate_loss(
        {"segmentation": [_t(DATA["logits"]), _t(DATA["aux"])],
         "classification": _t(cls_logits)}, *[_t(a) for a in args], LMAP_T,
        LossConfig(**kw))
    ref = jdisp.calculate_loss(
        {"segmentation": [_j(DATA["logits"]), _j(DATA["aux"])],
         "classification": _j(cls_logits)}, *[_j(a) for a in args], LMAP_J,
        jdisp.LossConfig(**kw))
    assert sorted(got) == sorted(ref)
    assert "classification" in got
    for k in ref:
        _check_value(got[k].item(), float(ref[k]), "float32", k)
    # the branch's term needs the head's output, as in JAX
    plain = calculate_loss({"segmentation": _t(DATA["logits"])},
                           *[_t(a) for a in args], LMAP_T, LossConfig(**kw))
    assert "classification" not in plain


def test_model_genesis_still_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="model_genesis.*item 5"):
        calculate_loss({"segmentation": _t(DATA["logits"])}, _t(DATA["label"]),
                       None, None, None, None, LMAP_T, model_genesis=True)


# --------------------------------------------------------------- the heads
@pytest.fixture(scope="module")
def jax_model():
    """The JAX model with both heads and its flat flax tree (the parameters
    do not depend on the input's size)."""
    jm = JaxMedFormer(NUM_CLASSES, dtype=jnp.float32, **TINY, **HEADS)
    return jm, flax_params(jm, np.zeros((1, 32, 32, 32, 1), np.float32))


def _jax_heads(jax_model, size, grads):
    """At one size: the input, two report embeddings, the flat flax tree and
    the JAX model's outputs, with `grads` also its CLIP loss and that loss's
    gradients (one jitted function either way)."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, size, 1)).astype(np.float32)
    emb = rng.normal(size=(2, HEADS["clip_feats"])).astype(np.float32)
    jm, flat = jax_model
    got = dict(size=size, x=x, emb=emb, flat=flat)
    if grads:
        def clip_loss(params, xx, e):
            out = jm.apply({"params": params}, xx)
            return jnce.symmetric_info_nce(out["clip"], e), out

        (loss, out), g = jax.jit(jax.value_and_grad(clip_loss, has_aux=True))(
            _unflatten(flat), jnp.asarray(x), jnp.asarray(emb))
        from flax.traverse_util import flatten_dict

        got.update(loss=float(loss), grads={
            "/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(g)).items()})
    else:
        out = jax.jit(lambda p, xx: jm.apply({"params": p}, xx))(
            _unflatten(flat), jnp.asarray(x))
    got["out"] = jax.tree.map(np.asarray, out)
    return got


@pytest.fixture(scope="module")
def heads64(jax_model):
    """64³: the heads' patch merge leaves 8 voxels, so the CLIP loss reaches
    the encoder; the outputs and the CLIP-loss gradients."""
    return _jax_heads(jax_model, 64, grads=True)


@pytest.fixture(scope="module", params=[32, 64])
def heads(request, jax_model):
    """32³ (one voxel in the heads: the outputs only; the gradients there
    are held by ``test_one_voxel_clip_head_is_zero_with_finite_gradients``)
    and 64³."""
    if request.param == 64:
        return request.getfixturevalue("heads64")
    return _jax_heads(jax_model, 32, grads=False)


def _port(flat, **kw):
    model = get_model("medformer", NUM_CLASSES, {**TINY, **HEADS, **kw},
                      dtype=torch.float32)
    return load_flax_params(model, flat)


def test_heads_params_from_flax_consume_every_leaf(heads):
    flat = heads["flat"]
    model = get_model("medformer", NUM_CLASSES, {**TINY, **HEADS})
    state = params_from_flax(flat, model)  # strict: no leaf left, none short
    assert len(state) == len(flat) == len(model.state_dict())
    for prefix in ("cls_extra/", "cls_branch/Conv_0/", "clip_extra/",
                   "cls_branch/TransformerBlock_0/", "cls_branch/Dense_0/",
                   "clip_branch/Conv_0/", "clip_branch/TransformerBlock_0/",
                   "clip_branch/Dense_0/"):
        assert any(k.startswith(prefix) for k in flat), prefix
    back = flax_from_state_dict(state, remat=True)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_heads_outputs_match_jax(heads):
    model = _port(heads["flat"]).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(heads["x"]))
    ref = heads["out"]
    assert out["classification"].shape == (2, HEADS["classification_classes"])
    assert out["clip"].shape == (2, HEADS["clip_feats"])
    pairs = [("classification", out["classification"],
              ref["classification"]), ("clip", out["clip"], ref["clip"])]
    pairs += [(f"segmentation {i}", g, r) for i, (g, r) in enumerate(
        zip(out["segmentation"], ref["segmentation"]))]
    for name, got, want in pairs:
        assert got.dtype == torch.float32, name
        err = float(np.abs(got.numpy() - want).max())
        assert err <= F32_TOL * (1 + float(np.abs(want).max())), (name, err)


def _clip_step(model, x, emb, encoder_only):
    """The CLIP loss and every parameter's gradient (None where the loss
    does not reach), through ``loss_fn``'s encoder-only path or the full
    forward."""
    model.zero_grad(set_to_none=True)
    batch = {"image": torch.from_numpy(x),
             "report_embedding": torch.from_numpy(emb)}
    if encoder_only:
        loss, _ = loss_fn(model, batch, LMAP_T, LossConfig(), clip_only=True)
    else:
        loss = calculate_loss(model(batch["image"]), None, None, None, None,
                              None, LMAP_T, clip_only=True,
                              report_embeddings=batch["report_embedding"]
                              )["overall"]
    loss.backward()
    return loss.detach(), {k: None if p.grad is None else p.grad.clone()
                           for k, p in model.named_parameters()}


def test_clip_step_gradients_match_jax(heads64):
    model = _port(heads64["flat"])
    loss, grads = _clip_step(model, heads64["x"], heads64["emb"], True)
    assert abs(loss.item() - heads64["loss"]) <= 1e-4 * abs(heads64["loss"])
    ref = params_from_flax(heads64["grads"], model)
    top = max(float(r.norm()) for r in ref.values())
    reached = 0
    for k, r in ref.items():
        g = grads[k]
        if g is None:  # the decoder and the other head: no gradient in JAX
            assert float(r.abs().max()) == 0.0, k
            continue
        reached += 1
        err = float((g - r).norm())
        assert err <= GRAD_TOL * (float(r.norm()) + GRAD_FLOOR * top), \
            (k, err, float(r.norm()))
    assert reached > 100  # the encoder and the CLIP head
    assert all(grads[k] is None for k in grads
               if k.startswith(("cls_", "UpBlock", "outc", "aux_out",
                                "SemanticMapFusion")))


def test_encoder_only_clip_step_equals_the_full_forward(heads, monkeypatch):
    """Bit for bit on the CPU; and the decoder does not run."""
    model = _port(heads["flat"])
    loss, grads = _clip_step(model, heads["x"], heads["emb"], False)
    ran = []
    for name in ("SemanticMapFusion_0", "UpBlockMF_0", "outc"):
        getattr(model, name).register_forward_hook(
            lambda *a, name=name: ran.append(name))
    loss2, grads2 = _clip_step(model, heads["x"], heads["emb"], True)
    assert ran == []
    assert torch.equal(loss, loss2)
    assert sorted(grads) == sorted(grads2)
    for k, g in grads.items():
        if g is None:
            assert grads2[k] is None, k
        else:
            assert torch.equal(g, grads2[k]), k


def test_one_voxel_clip_head_is_zero_with_finite_gradients():
    """At 32³ the heads' patch merge leaves one voxel: with the seeded
    initialisation (zero biases) the CLIP vector is exactly zero, and the
    InfoNCE gradients stay finite."""
    model = init_params(get_model("medformer", NUM_CLASSES, {**TINY, **HEADS},
                                  dtype=torch.float32), seed=0)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 32, 1)).astype(
        np.float32)
    emb = np.random.default_rng(1).normal(size=(2, 16)).astype(np.float32)
    with torch.no_grad():
        assert not model.branches(model.encoder(torch.from_numpy(x))[4])[
            "clip"].any()
    loss, grads = _clip_step(model, x, emb, True)
    assert abs(loss.item() - np.log(2)) < 1e-6  # uniform logits
    assert all(bool(torch.isfinite(g).all()) for g in grads.values()
               if g is not None)


def test_clip_train_step_decays_the_parameters_it_does_not_reach():
    """The decoder and the classification head get zero gradients, not
    none, so AdamW's weight decay moves them as optax's does."""
    model = init_params(get_model("medformer", NUM_CLASSES, {**TINY, **HEADS},
                                  dtype=torch.float32), seed=0)
    lr, wd = 1e-3, 0.05
    state = create_train_state(model, make_optimizer(
        model.parameters(), base_lr=lr, warmup_epochs=0, weight_decay=wd),
        ema=False)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.normal(
        size=(2, 32, 32, 32, 1)).astype(np.float32)),
        "report_embedding": torch.from_numpy(rng.normal(
            size=(2, HEADS["clip_feats"])).astype(np.float32))}
    step = build_train_step(LMAP_T, LossConfig(), clip_only=True)
    _, losses = step(state, batch)
    assert sorted(losses) == ["contrastive_loss", "overall"]
    assert state.step == 1
    unreached = [k for k in start if k.startswith(
        ("cls_", "UpBlockMF", "outc", "aux_out", "SemanticMapFusion"))]
    assert unreached
    params = dict(model.named_parameters())
    moved = 0
    for k in unreached:
        p = params[k].detach()
        assert params[k].grad is not None and not params[k].grad.any(), k
        torch.testing.assert_close(p, start[k] * (1 - lr * wd), rtol=0,
                                   atol=1e-7, msg=k)
        moved += not torch.equal(p, start[k])
    assert moved > len(unreached) // 2  # the weights; zero biases stay
