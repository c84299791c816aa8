"""Input pipeline: host-side prefetching, the transfer to the card and the
batched device augmentation (the port's counterpart of
``rsuper_tpu/data/pipeline.py`` for one GPU).

The host threads do IO and the branchy cropping (``dataset.py``) and pack
each record for the transfer: the 3·C binary mask channels as one
``np.packbits`` byte plane, the image as float16 (``pack_record_cf``). The
batch goes to the card from pinned memory without blocking the host
(``to_device``). There the masks ride as 24-bit float words through the
warp and are unpacked once; the image is warped by the shear-decomposed
matrix products (``ops/shear_warp.py``), centre-cropped, and put through the
intensity stack (``device_augment``). In the host-augmentation mode the
workers augment instead (``PrefetchLoader(transform=)``,
``host_augment.py``). ``DevicePrefetcher`` moves the transfer and the
augmentation of the next batches onto a side stream.

JAX draws the augmentation from a key stream that PyTorch cannot reproduce,
so ``device_augment`` takes its draws as an argument (``AugmentDraws``):
``draw_augment`` makes them from two explicit ``torch.Generator``s — the
small ones on the CPU generator, the noise tensor on the device's — and the
parity tests pass the values the JAX key stream gives.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import (Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from ..ops.shear_warp import shear_affine_window
from .augment import (_affine_theta, _nearest_window_multichannel,
                      _uniform, center_crop, intensity_augment)
from .dataset import RSuperDataset

_BITS = 24  # binary channels per float32 word (exact integers up to 2^24)
AFFINE_PROB = 0.4
INTENSITY_PROB = 0.3
NOISE_STD_MAX = 0.2
IMAGE_DTYPE = np.float16  # the image's type on the way to the device
PREFETCH = 4  # batches the loader keeps ready


def _unpack_bits(w: torch.Tensor, C: int) -> torch.Tensor:
    """(..., ceil(C/24)) float32 words → (..., C) float32 of 0/1: bit b of
    word i is channel 24·i + b."""
    outs = []
    for i, s in enumerate(range(0, C, _BITS)):
        n = min(_BITS, C - s)
        word = w[..., i].to(torch.int32)
        shifts = torch.arange(n, dtype=torch.int32, device=w.device)
        outs.append((word[..., None] >> shifts) & 1)
    return torch.cat(outs, dim=-1).to(torch.float32)


def _bytes_to_words(packed_u8: torch.Tensor) -> torch.Tensor:
    """(..., W8) little-bitorder packed bytes → (..., ceil(8·W8/24)) float32
    words (byte k of a 3-byte group lands at bits 8k..8k+7, so
    ``np.packbits(bitorder='little')`` channel j is bit j % 24 of word
    j // 24)."""
    W8 = packed_u8.shape[-1]
    b = packed_u8.to(torch.float32)
    words = []
    for s in range(0, W8, 3):
        chunk = b[..., s: s + 3]
        pows = 256.0 ** torch.arange(chunk.shape[-1], dtype=torch.float32,
                                     device=b.device)
        words.append(torch.sum(chunk * pows, dim=-1))
    return torch.stack(words, dim=-1)


def pack_masks(label: np.ndarray, unk: np.ndarray,
               seg: np.ndarray) -> np.ndarray:
    """The three (C, D, H, W) binary stacks → (D, H, W, ceil(3C/8)) bytes in
    ``np.packbits(..., bitorder='little')`` layout (channel j is bit j % 8 of
    byte j // 8), in one pass through the native encoder
    (``native_io.pack_masks_cl``) where the host library is built (numpy
    otherwise)."""
    from . import native_io

    packed = native_io.pack_masks_cl(label, unk, seg)
    if packed is None:  # no native library: numpy on channel-first stacks
        m = np.concatenate([label, unk, seg], axis=0)
        packed = np.moveaxis(
            np.packbits(m.astype(np.uint8), axis=0, bitorder="little"), 0, -1
        )
        packed = np.ascontiguousarray(packed)
    return packed


def pack_record_cf(rec_cf):
    """Channel-first record (out of ``RSuperDataset.sample``) → packed
    channels-last transfer record: the 3·C mask channels as one byte plane
    (``pack_masks``) and the image as float16."""
    packed = pack_masks(rec_cf.pop("label"), rec_cf.pop("unk"),
                        rec_cf.pop("segment_mask"))
    out = {"masks_packed": packed}
    for k, v in rec_cf.items():
        out[k] = v
    out["image"] = np.asarray(out["image"])[..., None].astype(IMAGE_DTYPE)
    return out


@dataclasses.dataclass
class AugmentDraws:
    """The random numbers of one batch's augmentation, per item: the affine
    matrix θ (B, 3, 4), the affine coin (B,), the six intensity coins
    (B, 6), each intensity op's parameter (B,) — the brightness factor, the
    standard normal of the additive brightness, γ, the contrast factor, the
    blur's σ, the noise std — and the standard-normal noise (B, *crop) on
    the device. All but the noise are host arrays."""

    theta: np.ndarray
    affine_coin: np.ndarray
    coins: np.ndarray
    multiply: np.ndarray
    additive: np.ndarray
    gamma: np.ndarray
    contrast: np.ndarray
    sigma: np.ndarray
    noise_std: np.ndarray
    noise: torch.Tensor


def draw_augment(gen_host: torch.Generator, gen_dev: torch.Generator,
                 B: int, crop_size: Sequence[int], scale=(0.0, 0.0, 0.0),
                 rotate=(30.0, 30.0, 30.0),
                 translate=(0.0, 0.0, 0.0)) -> AugmentDraws:
    """Draws of one batch: the small ones from `gen_host` (a CPU generator)
    in the parameter ranges of the JAX package, the noise on `gen_dev`'s
    device."""
    u = torch.rand((B, 15), generator=gen_host).numpy()
    theta = np.stack([_affine_theta(r[0:3], r[3:9], r[9:12], r[12:15],
                                    scale, rotate, translate) for r in u])
    coin = torch.rand((B,), generator=gen_host).numpy()
    coins = torch.rand((B, 6), generator=gen_host).numpy()
    r = torch.rand((B, 5), generator=gen_host).numpy()
    additive = torch.randn((B,), generator=gen_host).numpy()
    noise = torch.randn((B, *crop_size), generator=gen_dev,
                        device=gen_dev.device)
    return AugmentDraws(
        theta=theta, affine_coin=coin, coins=coins,
        multiply=_uniform(r[:, 0], 0.7, 1.3), additive=additive,
        gamma=_uniform(r[:, 1], 0.7, 1.5), contrast=_uniform(r[:, 2], 0.7, 1.3),
        sigma=_uniform(r[:, 3], 0.5, 1.5),
        noise_std=_uniform(r[:, 4], 0.0, NOISE_STD_MAX), noise=noise)


def device_augment(batch: Dict, draws: AugmentDraws, *, num_classes: int,
                   crop_size=(96, 96, 96), out_dtype=torch.float32):
    """Batched augmentation on the batch's device (the counterpart of the
    JAX package's ``device_augment`` and ``_augment_items``): image
    (B, *crop, 1) and the three mask stacks (B, *crop, C) in `out_dtype`;
    the other entries pass through. Per item:

    * the random affine with probability AFFINE_PROB, gated by each
      record's ``apply_affine`` flag (segment-targeted report crops are never
      warped): an item whose gate is off skips the warp;
    * the centre crop from the margined load size down to `crop_size`;
    * the 6-op intensity stack (probability INTENSITY_PROB each).

    The `num_classes` · 3 binary mask channels come as the host's
    ``masks_packed`` bytes (``pack_record_cf``), ride as 24-bit float words
    through the warp or crop and are unpacked once. The gate
    ``apply_affine & coin`` is decided on the host: ``apply_affine`` stays
    a host array."""
    B, C = batch["image"].shape[0], num_classes
    words = _bytes_to_words(batch["masks_packed"])
    flags = np.asarray(batch.get("apply_affine", np.ones((B,), np.float32)))
    warp = ((flags.reshape(B) > 0)
            & (np.asarray(draws.affine_coin) < AFFINE_PROB))
    crop_size = tuple(crop_size)
    imgs, labs, unks, segs = [], [], [], []
    for i in range(B):
        img3 = batch["image"][i, ..., 0].to(torch.float32)
        w = words[i]
        starts = tuple((s - c) // 2 for s, c in zip(img3.shape, crop_size))
        if warp[i]:
            img3 = shear_affine_window(img3, draws.theta[i], crop_size, starts)
            w = _nearest_window_multichannel(w, draws.theta[i], crop_size,
                                             starts)
        else:
            img3, w = center_crop(img3, crop_size), center_crop(w, crop_size)
        img3 = intensity_augment(
            img3, draws.coins[i], draws.multiply[i], draws.additive[i],
            draws.gamma[i], draws.contrast[i], draws.sigma[i],
            draws.noise_std[i], draws.noise[i], p=INTENSITY_PROB)
        masks = _unpack_bits(w, 3 * C).to(out_dtype)
        imgs.append(img3.to(out_dtype)[..., None])
        labs.append(masks[..., :C])
        unks.append(masks[..., C: 2 * C])
        segs.append(masks[..., 2 * C:])
    out = {k: v for k, v in batch.items()
           if k not in ("masks_packed", "apply_affine", "image")}
    out.update(image=torch.stack(imgs), label=torch.stack(labs),
               unk=torch.stack(unks), segment_mask=torch.stack(segs))
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    """A host batch on `device`: every array but ``apply_affine`` (which the
    augment's gate reads on the host), from pinned memory without blocking
    the host when `device` is a card."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k == "apply_affine":
            out[k] = np.asarray(v)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class PrefetchLoader:
    """Thread-pool loader: samples records with `RSuperDataset.sample`,
    packs each for the transfer (``pack_record_cf``) or, with `transform`
    (``host_augment.make_host_augment``), augments it in the worker with the
    worker's generator, stacks them into batches and keeps `PREFETCH`
    batches ready.

    Each worker thread draws from its own ``np.random.default_rng(seed ·
    10007 + worker)``; which worker takes which item depends on the
    scheduling, so the records are reproducible with ``num_workers=1``.
    ``item_seconds`` collects each record's loading time in its worker (the
    host's clock)."""

    def __init__(
        self,
        dataset: RSuperDataset,
        batch_size: int,
        indices: Sequence[int],
        num_workers: int = 4,
        seed: int = 0,
        transform: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = list(indices)
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.transform = transform
        self.item_seconds: List[float] = []

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n_batches = len(self.indices) // self.batch_size
        if n_batches == 0:
            return
        jobs: "queue.Queue" = queue.Queue()
        results: "queue.Queue" = queue.Queue(
            maxsize=PREFETCH * self.batch_size)
        for bi in range(n_batches):
            for j in range(self.batch_size):
                jobs.put((bi, self.indices[bi * self.batch_size + j]))
        for _ in range(self.num_workers):
            jobs.put(None)

        stop = threading.Event()  # set when the consumer stops early

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    results.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(wid: int):
            rng = np.random.default_rng(self.seed * 10007 + wid)
            while not stop.is_set():
                job = jobs.get()
                if job is None:
                    put(None)
                    return
                bi, idx = job

                def load(i):
                    rec = self.dataset.sample(i, rng)
                    if self.transform is not None:
                        return self.transform(rec, rng)
                    return pack_record_cf(rec)

                t0 = time.perf_counter()
                try:
                    rec = load(idx)
                except Exception as e:  # degrade to another record, once
                    try:
                        rec = load(int(rng.integers(len(self.dataset))))
                    except Exception:
                        put((bi, e))
                        continue
                self.item_seconds.append(time.perf_counter() - t0)
                put((bi, rec))

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            yield from self._batches(results, n_batches)
        finally:
            stop.set()

    def _batches(self, results: "queue.Queue", n_batches: int):
        pending: Dict[int, list] = {}
        done_workers = 0
        emitted = 0
        next_batch = 0
        while emitted < n_batches:
            item = results.get()
            if item is None:
                done_workers += 1
                if done_workers == self.num_workers and not pending:
                    break
                continue
            bi, rec = item
            if isinstance(rec, Exception):
                raise rec
            pending.setdefault(bi, []).append(rec)
            while (next_batch in pending
                   and len(pending[next_batch]) == self.batch_size):
                recs = pending.pop(next_batch)
                yield {k: np.stack([r[k] for r in recs]) for k in recs[0]}
                emitted += 1
                next_batch += 1


class DevicePrefetcher:
    """Overlaps the transfer and the device augmentation of batch N+1 with
    step N (the counterpart of the JAX package's ``DevicePrefetcher``): a
    feeder thread takes ``(index, host batch)`` pairs from `batches` and runs
    ``prepare(index, host)`` (the transfer from pinned memory and the
    augmentation's launches, with the draws of that index) on a side CUDA
    stream, and records an event after it. The consuming stream waits on
    the event, and ``record_stream`` keeps the caching allocator from
    reusing a batch's memory before the consumer's work on it is done.
    At most `depth` prepared batches wait beside the one being consumed.
    An error of the feeder is raised in the consuming thread. On the CPU
    the feeder prepares the batches without streams.

    The feeder closes `batches` when it stops; closing this iterator stops
    the feeder and waits for it."""

    def __init__(self, batches: Iterable[Tuple[int, Dict]],
                 prepare: Callable[[int, Dict], Dict], device,
                 depth: int = 2):
        self.batches = batches
        self.prepare = prepare
        self.device = torch.device(device)
        self.depth = max(1, depth)

    def _feed(self, out: "queue.Queue", slots: threading.Semaphore,
              stop: threading.Event) -> None:
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        try:
            for index, host in self.batches:
                while not slots.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                if cuda:
                    with torch.cuda.stream(stream):
                        batch = self.prepare(index, host)
                        event = torch.cuda.Event()
                        event.record(stream)
                else:
                    batch, event = self.prepare(index, host), None
                out.put((batch, event))
        except Exception as e:  # raised again in the consuming thread
            out.put(e)
        finally:
            close = getattr(self.batches, "close", None)
            if close is not None:
                close()
            out.put(None)

    def __iter__(self) -> Iterator[Dict]:
        out: "queue.Queue" = queue.Queue()
        slots = threading.Semaphore(self.depth)
        stop = threading.Event()
        feeder = threading.Thread(target=self._feed, args=(out, slots, stop),
                                  daemon=True)
        feeder.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            v.record_stream(current)
                yield batch
                slots.release()
        finally:
            stop.set()
            feeder.join()
