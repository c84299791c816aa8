"""Host augmentation (``data/host_augment.py``, ``PrefetchLoader(transform=)``)
and the ``DevicePrefetcher`` of the port, on the CPU.

* Against the JAX package: ``make_host_augment``'s transform returns, for
  the same record and the same ``np.random.Generator`` state, arrays equal
  to the JAX package's in every key (the port takes the channel-first
  record, the JAX package its channels-last copy; the port's masks are
  uint8 0/1 where the JAX package's are float32, the values equal), with
  the affine on and off, the record's ``apply_affine`` gate closed, and the
  intensity ops all on and all off; the generators stay in step.
* Port only: the loader's workers apply the transform with their own
  generator; the loop in host mode trains without ``device_augment``; the
  ``DevicePrefetcher`` yields the batches the inline path makes, holds at
  most `depth` prepared batches beside the consumer's, raises a feeder
  error in the consuming thread and stops its feeder when closed; a loop
  with ``device_prefetch = 2`` ends bit-equal to the inline loop.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from rsuper_tpu.data import host_augment as jhost
from rsuper_tpu.data.dataset import to_channels_last as jto_channels_last
from rsuper_tpu_torch.data import host_augment as host
from rsuper_tpu_torch.data import pipeline as pipe
from rsuper_tpu_torch.train import loop
from test_torch_loop import (_one_intra_op_thread,  # noqa: F401
                             _same_state, _train_port, _write_cases)

LOAD, CROP, C = (20, 26, 22), (12, 16, 14), 9


def _record(seed, apply_affine=1.0):
    rng = np.random.default_rng(seed)
    masks = {k: (rng.random((C,) + LOAD) < p).astype(np.uint8)
             for k, p in (("label", 0.3), ("unk", 0.1),
                          ("segment_mask", 0.05))}
    return dict(image=rng.normal(size=LOAD).astype(np.float32),
                volumes=rng.random(10).astype(np.float32),
                diameters=rng.random((10, 3)).astype(np.float32),
                apply_affine=np.asarray(apply_affine, np.float32), **masks)


class _Gates:
    """A generator that keeps the draws of ``uniform()`` with no arguments:
    the transform's gates (the affine's, when the record's gate is open,
    then one for each of the six intensity ops)."""

    def __init__(self, rng):
        self.rng, self.gates = rng, []

    def uniform(self, *args, **kwargs):
        out = self.rng.uniform(*args, **kwargs)
        if not args and not kwargs:
            self.gates.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.rng, name)


KW = dict(scale=(0.1, 0.1, 0.1), rotate=(30.0, 20.0, 10.0),
          translate=(0.05, 0.0, 0.05))
# seeds under which, with the gate open, the affine runs and is skipped,
# and each intensity op runs and is skipped (test_the_seeds_cover_...)
SEEDS = range(6)


@pytest.mark.parametrize("gate", [1.0, 0.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_host_transform_equals_jax(gate, seed):
    ours = host.make_host_augment(CROP, **KW)
    theirs = jhost.make_host_augment(CROP, **KW)
    rec = _record(seed, gate)
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = ours(dict(rec), rng_a)
    want = theirs(jto_channels_last(dict(rec)), rng_b)
    assert sorted(got) == sorted(want)
    assert "apply_affine" not in got
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), (seed, k)
    assert got["image"].dtype == np.float32
    assert got["label"].dtype == np.uint8
    assert rng_a.random() == rng_b.random()  # the same draws were made


def test_the_seeds_cover_every_branch():
    """The cases above take the affine and skip it, and take and skip each
    intensity op, at the reference's odds (AFFINE_PROB, INTENSITY_PROB)."""
    transform = host.make_host_augment(CROP, **KW)
    affine, ops = set(), [set() for _ in range(6)]
    for gate in (1.0, 0.0):
        for seed in SEEDS:
            rng = _Gates(np.random.default_rng(seed))
            transform(_record(seed, gate), rng)
            gates = rng.gates
            if gate:
                affine.add(gates[0] < host.AFFINE_PROB)
            assert len(gates) == 6 + int(gate)
            for i, g in enumerate(gates[-6:]):
                ops[i].add(g < host.INTENSITY_PROB)
    assert affine == {True, False}
    assert all(o == {True, False} for o in ops), ops


def test_mask_words_round_trip():
    rng = np.random.default_rng(0)
    for n in (1, 8, 27, 48, 52):
        m = (rng.random((3, 4, 5, n)) < 0.5).astype(np.uint8)
        packed = np.packbits(m, axis=-1, bitorder="little")
        words = host._pack_f64(packed)
        assert np.array_equal(words, jhost._pack_f64(m))
        assert np.array_equal(host._unpack_f64(words, n), m)
    with pytest.raises(ValueError, match="float64 word"):
        host.make_host_augment(CROP)(
            dict(_record(0), label=np.zeros((18,) + LOAD, np.uint8)),
            np.random.default_rng(0))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_cases(tmp_path_factory.mktemp("cases"))


def test_loader_workers_apply_the_transform(data, tmp_path):
    from test_torch_loop import OVERRIDES, PRESET, _port_dataset

    from rsuper_tpu_torch.config import load_config

    cfg = load_config(PRESET, overrides=dict(OVERRIDES,
                                             cp_path=str(tmp_path)))
    dataset = _port_dataset(data, cfg)
    transform = host.make_host_augment(cfg.training_size)
    loader = pipe.PrefetchLoader(dataset, 2, [0, 1, 2, 3], num_workers=1,
                                 seed=3, transform=transform)
    batches = list(loader)
    rng = np.random.default_rng(3 * 10007)  # the worker's generator
    want = [transform(dataset.sample(i, rng), rng) for i in range(4)]
    assert len(batches) == 2
    for b, batch in enumerate(batches):
        assert batch["image"].shape == (2, 32, 32, 32, 1)
        assert batch["label"].shape == (2, 32, 32, 32, 9)
        for k, v in batch.items():
            assert np.array_equal(v, np.stack([w[k] for w in
                                               want[2 * b: 2 * b + 2]])), k


def test_the_loop_in_host_mode_runs_no_device_augment(data, tmp_path,
                                                      monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("device_augment ran in host mode")

    seen = []
    step = loop.build_train_step

    def recording(*a, **k):
        fn = step(*a, **k)

        def wrapped(state, batch):
            seen.append({k: (v.dtype, tuple(v.shape)) for k, v in
                         batch.items()})
            return fn(state, batch)

        return wrapped

    monkeypatch.setattr(loop, "device_augment", refuse)
    monkeypatch.setattr(loop, "build_train_step", recording)
    state = _train_port(data, tmp_path, max_steps=2,
                        cfg={"host_augment": True})
    assert state.step == 2 and len(seen) == 2
    assert seen[0]["image"] == (torch.float32, (2, 32, 32, 32, 1))
    assert seen[0]["segment_mask"] == (torch.float32, (2, 32, 32, 32, 9))
    recs = (tmp_path / "test" / "metrics.jsonl").read_text()
    assert '"train/overall"' in recs and "NaN" not in recs


def _host_batches(n):
    rng = np.random.default_rng(0)
    return [(i, {"x": rng.normal(size=(2, 3)).astype(np.float32)})
            for i in range(n)]


def _prepare(index, h):
    return {"x": torch.from_numpy(h["x"]) * (index + 1)}


def test_device_prefetcher_yields_the_inline_batches_within_depth():
    for depth in (1, 2, 3):
        got, yielded = [], [0]

        def prepare(index, h):
            assert index + 1 <= depth + yielded[0]
            return _prepare(index, h)

        for batch in pipe.DevicePrefetcher(iter(_host_batches(6)), prepare,
                                           "cpu", depth=depth):
            yielded[0] += 1
            time.sleep(0.01)  # a slow consumer: the feeder runs ahead
            got.append(batch)
        want = [_prepare(i, h) for i, h in _host_batches(6)]
        assert len(got) == 6
        assert all(torch.equal(g["x"], w["x"]) for g, w in zip(got, want))


def test_device_prefetcher_raises_feeder_errors_and_stops_on_close():
    def failing(index, h):
        if index == 1:
            raise KeyError("boom")
        return _prepare(index, h)

    it = iter(pipe.DevicePrefetcher(iter(_host_batches(4)), failing, "cpu"))
    next(it)
    with pytest.raises(KeyError, match="boom"):
        next(it)

    closed = threading.Event()

    def source():
        try:
            yield from _host_batches(100)
        finally:
            closed.set()

    before = threading.active_count()
    it = iter(pipe.DevicePrefetcher(source(), _prepare, "cpu", depth=2))
    next(it)
    it.close()
    assert closed.wait(5) and threading.active_count() == before


def test_a_prefetching_loop_equals_the_inline_loop(data, tmp_path):
    inline = _train_port(data, tmp_path / "a", max_steps=2)
    prefetched = _train_port(data, tmp_path / "b", max_steps=2,
                             cfg={"device_prefetch": 2})
    assert inline.step == prefetched.step == 2
    _same_state(inline, prefetched)
    # `load` is the loop's wait in both modes; only the feeder waits for
    # the loader as `feeder_load`
    for run, feeder in (("a", False), ("b", True)):
        recs = [json.loads(line) for line in (
            tmp_path / run / "test" / "metrics.jsonl").read_text().splitlines()]
        phases = [r for r in recs if "phase/load_ms" in r][-1]
        assert ("phase/feeder_load_ms" in phases) == feeder
        assert phases["phase/load_count"] == 2
