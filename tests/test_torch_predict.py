"""The PyTorch port's prediction path against the JAX package, on the CPU.

One small MedFormer (every stage kind of the default configuration, 32³
windows) with the same seeded parameters on both sides; a small volume whose
last axis is shorter than the window (so it is padded), and organ routing
with a paired organ (kidney) and a single one (liver).

Tolerances:
* blended probabilities: max|Δ| ≤ 1e-3 — float32 logits agree to about
  1e-4·(1 + max|logit|) (tests/test_torch_medformer.py), and the sigmoid's
  slope is at most 1/4;
* masks: equal, except at voxels whose probability (or, for a gated lesion,
  an organ probability within the gate's dilation reach) lies within 1e-3 of
  the threshold;
* lesion probabilities: f16 wire ≤ 1e-3 + one f16 step; u8 wire ≤ one
  1/255 step (both sides round p·255 on their own probabilities) plus the
  f16 rounding of the two restored values (2^-12 each).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from rsuper_tpu.inference import predict as jpredict
from rsuper_tpu.inference import sliding_window as jsw
from rsuper_tpu.models.medformer import MedFormer as JaxMedFormer
from rsuper_tpu_torch import predict as cli
from rsuper_tpu_torch.data.nifti import read_nifti, write_nifti
from rsuper_tpu_torch.inference import predict as tpredict
from rsuper_tpu_torch.inference import sliding_window as tsw
from rsuper_tpu_torch.models import get_model, load_flax_params
from test_torch_loop import _one_intra_op_thread  # noqa: F401

TINY = dict(  # the small widths of tests/test_torch_port.py (copied)
    base_chan=4,
    chan_num=(8, 16, 32, 40, 32, 16, 8, 4),
    conv_num=(2, 0, 0, 0, 0, 0, 2, 2),
    trans_num=(0, 1, 2, 1, 1, 1, 0, 0),
    num_heads=(1, 2, 2, 2, 2, 2, 1, 1),
    fusion_depth=1,
    fusion_dim=40,
    fusion_heads=2,
    expansion=2,
)
CLASSES = ["kidney_left", "kidney_lesion", "kidney_right", "liver",
           "liver_lesion"]
WINDOW = (32, 32, 32)
PROB_TOL = 1e-3
NEAR = 1e-3


def _flax_params(module, x, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        if key.endswith("bias"):
            a = rng.normal(size=leaf.shape) * 0.1
        elif key.endswith("scale"):
            a = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            a = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        flat[key] = a.astype(np.float32)
    return flat


class Pair:
    """The same model in both packages, plus a test volume."""

    def __init__(self):
        from flax.traverse_util import unflatten_dict

        jm = JaxMedFormer(len(CLASSES), dtype=jnp.float32, **TINY)
        self.flat = _flax_params(jm, np.zeros((1, *WINDOW, 1), np.float32))
        # sparse organs and frequent lesions, so that the organ gate bites
        self.flat["outc/bias"] = np.array([-2.0, 1.0, -2.0, -2.0, 1.0],
                                          np.float32)
        self.jparams = {"params": unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v)
             for k, v in self.flat.items()})}

        def apply_fn(params, x):
            return jm.apply(params, x)["segmentation"][0]

        self.apply_fn = apply_fn
        model = get_model("medformer", len(CLASSES), dict(TINY),
                          dtype=torch.float32)
        self.model = load_flax_params(model, self.flat).eval()
        self.model_fn = lambda x: self.model(x)["segmentation"][0]
        rng = np.random.default_rng(3)
        self.volume = rng.normal(size=(48, 40, 20)).astype(np.float32)
        organ = np.zeros(self.volume.shape, np.uint8)
        organ[:12, :10, :] = 1  # keeps one window of the four
        self.organ = organ


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _probs_pair(pair, volume, organ=None):
    ref = np.asarray(jsw.sliding_window_probs_device(
        pair.apply_fn, pair.jparams, volume, len(CLASSES), window=WINDOW,
        batch=2, organ_mask=organ))
    got = tsw.sliding_window_probs_device(
        pair.model_fn, volume, len(CLASSES), window=WINDOW, batch=2,
        organ_mask=organ, device="cpu")
    return got.numpy(), ref


@pytest.mark.parametrize("gated", [False, True])
def test_sliding_window_probs_match_jax(pair, gated):
    organ = pair.organ if gated else None
    got, ref = _probs_pair(pair, pair.volume, organ)
    assert got.shape == ref.shape == (*pair.volume.shape, len(CLASSES))
    assert float(np.abs(got - ref).max()) <= PROB_TOL
    if gated:  # windows without organ overlap are skipped: probability 0
        assert (ref[-8:, -8:] == 0).all() and (got[-8:, -8:] == 0).all()


def test_window_grid_and_gaussian_match_jax():
    for size, win, stride in [(48, 32, 16), (100, 32, 16), (20, 32, 16),
                              (97, 96, 48)]:
        assert tsw.window_starts(size, win, stride) == \
            jsw.window_starts(size, win, stride)
    np.testing.assert_array_equal(tsw._grid((48, 40, 32), WINDOW, (16,) * 3),
                                  jsw._grid((48, 40, 32), WINDOW, (16,) * 3))
    np.testing.assert_allclose(tsw._gaussian_window((8, 6, 4)),
                               np.asarray(jsw._gaussian_window((8, 6, 4))),
                               rtol=1e-6)


def _allowed(probs, thr=0.5):
    """Per class, the voxels where a mask may differ: the probability is
    within NEAR of the threshold, or, for a gated lesion, an organ of its
    gate is near the threshold within the dilation reach."""
    near = np.abs(probs - thr) <= NEAR
    allowed = near.copy()
    for li, organs in tpredict._lesion_routing(CLASSES).items():
        if organs:
            reach = ndi.maximum_filter(near[..., list(organs)].any(-1),
                                       size=7, mode="constant")
            allowed[..., li] |= reach
    return allowed


def _assert_masks_agree(got, ref, probs):
    allowed = _allowed(probs)
    assert sorted(got) == sorted(ref) == sorted(CLASSES)
    for i, cls in enumerate(CLASSES):
        assert got[cls].dtype == ref[cls].dtype == np.uint8
        diff = got[cls] != ref[cls]
        assert not (diff & ~allowed[..., i]).any(), cls


@pytest.mark.parametrize("wire", ["u8", "f16"])
def test_predict_masks_volume_matches_jax(pair, wire):
    lesions = [i for i, c in enumerate(CLASSES) if "lesion" in c]
    ref_m, ref_p = jpredict.predict_masks_volume(
        [pair.apply_fn], [pair.jparams], pair.volume, CLASSES, window=WINDOW,
        batch=2, prob_channels=lesions, prob_wire=wire)
    got_m, got_p = tpredict.predict_masks_volume(
        [pair.model_fn], pair.volume, CLASSES, window=WINDOW, batch=2,
        prob_channels=lesions, prob_wire=wire, device="cpu")
    probs, _ = _probs_pair(pair, pair.volume)
    _assert_masks_agree(got_m, ref_m, probs)
    # the routing gates something: a lesion mask is not its raw threshold
    raw = probs[..., lesions] > 0.5
    gated = np.stack([got_m[CLASSES[i]] for i in lesions], -1).astype(bool)
    assert raw.sum() > gated.sum()
    assert got_p.dtype == ref_p.dtype == np.float16
    assert got_p.shape == ref_p.shape == (*pair.volume.shape, len(lesions))
    step = 1.0 / 255.0 if wire == "u8" else PROB_TOL
    d = np.abs(got_p.astype(np.float32) - ref_p.astype(np.float32))
    assert float(d.max()) <= step + 2.0 ** -11


def test_predict_masks_volume_with_organ_mask_and_z_chunks(pair, monkeypatch):
    """Z-chunking (patched down to 36 slices) and organ-mask window skips,
    against the JAX function under the same patch."""
    monkeypatch.setattr(jpredict, "Z_CHUNK", 36)
    monkeypatch.setattr(tpredict, "Z_CHUNK", 36)
    vol = np.random.default_rng(4).normal(size=(72, 32, 20)).astype(
        np.float32)
    organ = np.zeros(vol.shape, np.uint8)
    organ[:40] = 1
    ref = jpredict.predict_masks_volume(
        [pair.apply_fn], [pair.jparams], vol, CLASSES, window=WINDOW,
        batch=2, organ_mask=organ)
    got = tpredict.predict_masks_volume(
        [pair.model_fn], vol, CLASSES, window=WINDOW, batch=2,
        organ_mask=organ, device="cpu")
    # the allowed band comes from the port's own chunks, which are the
    # probabilities that decided each voxel
    probs = np.zeros((*vol.shape, len(CLASSES)), np.float32)
    for z, z1, lo, hi in ((0, 36, 0, 68), (36, 72, 4, 72)):
        p = tsw.sliding_window_probs_device(
            pair.model_fn, vol[lo:hi], len(CLASSES), window=WINDOW, batch=2,
            organ_mask=organ, device="cpu").numpy()
        probs[z:z1] = p[z - lo:z1 - lo]
    _assert_masks_agree(got, ref, probs)


def test_ungated_path_matches_jax(pair):
    """predict_folder's path without organ gating: probabilities on the host
    through ``predict_volume`` (a float16 transfer on both sides), then
    thresholds and the largest component of each lesion."""
    ref_p = jpredict.predict_volume([pair.apply_fn], [pair.jparams],
                                    pair.volume, len(CLASSES), window=WINDOW,
                                    batch=2)
    got_p = tpredict.predict_volume([pair.model_fn], pair.volume,
                                    len(CLASSES), window=WINDOW, batch=2,
                                    device="cpu")
    assert got_p.dtype == ref_p.dtype == np.float16
    d = np.abs(got_p.astype(np.float32) - ref_p.astype(np.float32))
    assert float(d.max()) <= PROB_TOL + 2.0 ** -11
    ref_m = jpredict.postprocess_prediction(
        ref_p, CLASSES, organ_mask_on_lesion=False, connected_components=True)
    got_m = tpredict.postprocess_prediction(got_p, CLASSES,
                                            connected_components=True)
    _assert_masks_agree(got_m, ref_m, got_p.astype(np.float32))


def test_device_postprocess_packed_matches_jax():
    rng = np.random.default_rng(5)
    probs = rng.random((9, 8, 7, len(CLASSES))).astype(np.float32)
    probs[..., 0] = (probs[..., 0] > 0.9) * 0.9  # sparse organs
    probs[..., 2] = 0.0
    probs[..., 3] = (probs[..., 3] > 0.95) * 0.9
    ref = np.asarray(jpredict.device_postprocess_packed(jnp.asarray(probs),
                                                        CLASSES))
    got = tpredict.device_postprocess_packed(torch.from_numpy(probs), CLASSES)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tpredict._lesion_routing(CLASSES) == jpredict._lesion_routing(
        CLASSES)
    masks = tpredict.unpack_masks(got.numpy(), CLASSES)
    np.testing.assert_array_equal(masks["kidney_left"], probs[..., 0] > 0.5)


@pytest.mark.parametrize("gz", [False, True])
def test_nifti_preprocess_and_restore_match_jax(tmp_path, gz):
    """The port's own NIfTI and preprocessing copies against the JAX
    package's: files written by either side read the same on both sides,
    and a scan with 1.5 mm voxels and flipped axes is reoriented, resampled
    to 1 mm³, normalised and padded, then a mask restored, identically."""
    from rsuper_tpu.data import nifti as jnifti

    ext = ".nii.gz" if gz else ".nii"
    ct = (np.random.default_rng(7).normal(size=(14, 10, 8)) * 300.0
          ).astype(np.float32)
    affine = np.diag([-1.5, 1.5, 2.0, 1.0])
    affine[:3, 3] = [20.0, -5.0, 3.0]
    a, b = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    write_nifti(a, ct, affine)
    jnifti.write_nifti(b, ct, affine)
    for path in (a, b):
        for reader in (read_nifti, jnifti.read_nifti):
            img = reader(path)
            np.testing.assert_array_equal(img.data, ct)
            np.testing.assert_allclose(img.affine, affine, rtol=1e-6)
    got, gmeta = tpredict.preprocess_volume(a, min_size=(24, 24, 24))
    ref, rmeta = jpredict.preprocess_volume(a, min_size=(24, 24, 24))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert sorted(gmeta) == sorted(rmeta)
    for k in gmeta:
        np.testing.assert_allclose(np.asarray(gmeta[k]), np.asarray(rmeta[k]))
    mask = (got > 0.3).astype(np.uint8)
    np.testing.assert_array_equal(tpredict.restore_geometry(mask, gmeta),
                                  jpredict.restore_geometry(mask, rmeta))


def test_predict_cli_end_to_end_on_cpu(pair, tmp_path):
    """``python -m rsuper_tpu_torch.predict`` with --device cpu on a small
    NIfTI written by the port's own writer."""
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    ct = (np.random.default_rng(6).normal(size=(30, 34, 20)) * 200.0
          ).astype(np.float32)
    affine = np.diag([1.0, 1.0, 1.0, 1.0])
    write_nifti(str(src / "case_a.nii.gz"), ct, affine)
    np.savez(tmp_path / "params.npz", **pair.flat)
    (tmp_path / "classes.json").write_text(json.dumps(CLASSES))
    (tmp_path / "model.json").write_text(json.dumps(TINY))
    done = cli.main([
        "--input_dir", str(src), "--output_dir", str(dst),
        "--params_npz", str(tmp_path / "params.npz"),
        "--classes_json", str(tmp_path / "classes.json"),
        "--model_args_json", str(tmp_path / "model.json"),
        "--window", "32", "32", "32", "--batch_windows", "2",
        "--save_probabilities", "--device", "cpu"])
    assert done == ["case_a"]
    assert not (dst / "prediction_errors.txt").exists()
    for cls in CLASSES:
        m = read_nifti(str(dst / "case_a" / f"{cls}.nii.gz"))
        assert m.data.shape == ct.shape
        assert set(np.unique(m.data)) <= {0, 1}
        if "lesion" in cls:
            p = read_nifti(str(dst / "case_a" / f"{cls}_prob.nii.gz")).data
            assert np.isfinite(p).all() and 0 <= p.min() <= p.max() <= 1
    assert os.path.exists(dst / "case_a" / "done")
