#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, one card

Phases, in order (any failure exits non-zero):

1. build   — nvcc builds every kernel of ``rsuper_tpu_torch/csrc`` for
             sm_90a, one process per source, all at once; what
             ``-Xptxas -v`` reports for the conv, depthwise and top-N kernels
             (registers, spills, static shared memory) is printed, one line
             a source;
2. kernels — each kernel against its plain PyTorch version at the shapes the
             serving path (forward, window batches of 8) and the training
             step (backward, batch 1) give it, and the validation path's
             forward at 128³ windows in batches of 4, in bf16 and float32,
             with the stated tolerance; times of the kernel, the plain version and
             the library call, and the kernel's bound; for the conv kernels
             their route (tensor cores or CUDA cores) and achieved TFLOP/s,
             for the fused forward the same kernel's time without its
             prologue, and for the bf16 weight gradients the kernel's and
             the plain version's distance from a float64 sum (recorded, not
             bounded); for the depthwise kernels (forward also at the
             training step's batch of 1) and the stem's forward and weight
             gradient (route ``"stem"``) the device time of one call alone
             (``device_ms``: a CUDA graph of the call replayed) and the
             device operations one call launches (``kernels_per_call``:
             the nodes of a CUDA graph of the call; for the depthwise
             backward also through the autograd Function). The two top-N
             bisection kernels at the Ball Loss's shapes (and B = 9 items,
             more clusters than the card holds at once): thresholds and masks
             equal to the plain version's, also on a volume of tied values;
             ``device_ms``, ``kernels_per_call`` and the cluster size;
3. model   — default-config MedFormer (16 classes, seeded random weights)
             on one 96³ window batch of 2, through the kernels and through
             the plain versions, in float32 and in bf16; forward times at
             batch 8 and a torch.profiler breakdown of one forward;
4. predict — whole-volume prediction through ``predict_folder`` (NIfTI in,
             per-class masks out) on a synthetic abdominal CT phantom (256³
             voxels of 1 mm: 125 windows) with 96³ windows in batches of 8
             and bf16 compute; the launch counts of every kernel are set to 0 just
             before that run and read just after it. Then seconds per volume
             of ``predict_masks_volume`` through the kernels and through the
             plain versions, and blended float32 probabilities against the
             plain versions;
5. serve   — a checkpoint of any origin served by the predict CLI
             (``python -m rsuper_tpu_torch.predict``) at the same windows on
             synthetic CTs of 144³ and 120³: a ``CheckpointManager``
             directory (``--checkpoint``, ``--tag``, ``--ema``; masks equal,
             bit for bit, to ``--params_npz`` of the same weights), and a
             reference-layout ``.pth`` through ``convert_checkpoint``,
             served with ``torch_port`` numerics (launch counts set to 0
             just before and read just after; blended float32
             probabilities against the plain versions); ``evaluate`` on
             those predictions; ``bench_infer`` once; the CLI's 128³
             window at batches of 4 and 8 (seconds a volume, peak memory);
6. train   — training steps of the default MedFormer on ``bench.py``'s
             synthetic 96³ batch of 1 (bf16 compute, float32 parameters,
             ``remat`` off) with the full R-Super losses (``LossConfig()``,
             ``loss="ball_dice_last"``: masked BCE + adaptive-Tversky Dice on
             both heads, the Ball Loss on the final head, the Volume Loss on
             the auxiliary head), clipping, AdamW and EMA. The Ball Loss on
             identical logits through the top-N kernel and through its plain
             version (equal pseudo-masks); losses and every parameter's
             gradient through the kernels against the plain versions, in
             float32 and in bf16, with the ball centres and pseudo-mask
             voxel counts of every run; then 1 warm-up and 10 timed steps
             with the launch counts of every kernel set to 0 just before and
             read just after, peak memory, host reads, a split of one step
             into forward, loss (and the Ball Loss inside it), backward and
             optimizer, and a torch.profiler breakdown; the loss must be
             finite at every step and lower after the steps than at the
             first; one step with ``remat`` on gives the same loss; the
             public ``topn_masks_multi`` on the path's own masked volume
             equals the batched kernel's masks; 1 + 5 steps of the
             ``loss="dice"`` step beside it;
7. augment — the device augmentation of the training CLI at the preset's
             sizes: a batch of 2 packed records at the 148 × 168 × 168 load
             size (16 classes) through ``device_augment`` on the card and on
             the CPU with the same draws; the image within 1e-5·(1+max|ref|),
             the masks equal but for voxels whose source coordinate lies
             within 1e-4 of a half (counted); TF32 off on the path; device
             ms a batch;
8. train_cli — ``python -m rsuper_tpu_torch.train``'s ``main`` with
             ``--preset abdomenatlas_ufo/medformer_3d`` (default MedFormer,
             128³ crops, batch 2, bf16, ``ball_dice_last``) on synthetic
             CT-Mask and CT-Report cases written through ``preprocess_case``
             and a per-tumour report CSV: 6 steps with a ``torch.profiler``
             window over the last and the launch counts set to 0 just before
             and read just after, then ``--resume`` for 2 more; step counts,
             finite losses, ``latest`` and ``metrics.jsonl``, the restored
             optimizer state and every kernel of the step in the profiled
             window are checked; ms a step, loader, transfer and augment ms,
             busy share, peak memory and host reads are printed;
9. validate — on the same synthetic cases: ``validate_cases`` at 128³
             windows in batches of 4, the seeded model's final head made
             confident, in bf16 and in float32 through the kernels and the
             plain versions (probabilities held against the plain versions',
             the metrics of both, Dice within what the voxels whose
             threshold differs allow, launches of the forward kernels a
             case, seconds a case on the device and on the host), the CLI's
             ``--k_fold 2`` for both folds, the loop's validation every
             epoch with ``best``, ``--pretrained`` without and with
             ``--old_classes`` (parameters right after the load held
             against the donor and the fresh initialisation), host
             augmentation, and ``device_prefetch`` 2 against 0 (equal
             batches and first losses, batches intact after their step, ms
             an iteration of both);
10. clip   — CLIP pretraining and the classification branch on the same
             cases: ``main`` with ``--clip_pretrain --clip_source DIR`` (seeded
             768-wide report embeddings) for 4 steps, the last profiled, and 2
             on ``--resume``, the launch counts set to 0 just before and read
             just after (finite contrastive losses, one crop organ a batch,
             the resumed batches those of the uninterrupted run, no top-N
             launch, float32 embeddings at the step; ms an iteration, busy
             share, device operations against the full CLI step's, peak
             memory); a CLIP step and a classification step through the
             kernels against the plain versions (the train phase's rules);
             2 steps of the preset with the classification branch. The
             kernels phase also holds the depthwise kernels at the heads'
             (2,4,4,4,C) shapes.
11. zoo    — the 3D model zoo: ``main`` with ``--preset
             abdomenatlas/resunet_3d`` (ResUNet, 128³ crops, batch 2, bf16,
             ``ball_dice_last``) on the same cases, fold 0 of ``--k_fold
             2``: 4 steps with a profiled last step and the launch counts set
             to 0 just before and read just after, the fold's validation,
             then 2 on ``--resume`` (ms an iteration and a step, the loop's
             wait, busy share, device operations, top-N launches a step,
             peak memory); the Ball Loss of the last step's batch through
             the top-N kernel against its plain version (bit-equal masks);
             ``predict --arch resunet --checkpoint`` of what it wrote on a
             144³ phantom (seconds a volume, the windows' device time); and
             every other 3D arch at the JAX registry's defaults: a bf16
             forward and backward at 96³ × 1 (swin_unetr and nnformer at
             128³: their deepest stage must be a multiple of the window 4),
             ms and peak memory, and the float32 logits on the card against
             the CPU's.
12. dim2   — the 2D pathway: ``main`` with ``--preset slices/resunet_2d``
             (UNet2D base 32, 256² slices × 2, ``dice``, EMA) on the
             CT-Mask cases alone, fold 0 of ``--k_fold 2``: 4 steps, the
             fold's slice-wise validation (``validate_cases_2d``), 2 on
             ``--resume`` (ms an iteration, the loop's wait, worker ms an
             item, the validation's seconds); every 2D arch at the JAX
             registry's defaults: a bf16 forward and backward at 256² × 8
             (ms, peak memory), float32 logits on the card against the
             CPU's within max(1e-3, 4ρ)·(1 + max|ref|).
13. mf_variants — two MedFormer configurations at the default widths on a
             96³ volume: ``mf_aniso`` (scale (1, 2, 2) first) and
             ``mf_mbconv`` (MBConv stages beside attention, linear
             projections, GELU): a bf16 forward and backward with the launch
             counts set to 0 just before and read just after (rows 1–6 for
             the first, rows 5–6 and no launch of rows 1–4 for the second),
             every shape they launch rows 1–6 at, each row against its plain
             version at each of those shapes, float32 through the kernels
             against the plain versions.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. It imports nothing of JAX or of
``rsuper_tpu``, and exits non-zero without CUDA or without the
``rsuper_tpu_torch`` package beside it.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CLASSES = [  # 16 classes for the serving phases
    "aorta", "adrenal_gland_left", "adrenal_gland_right", "colon",
    "duodenum", "gall_bladder", "kidney_left", "kidney_right", "liver",
    "pancreas", "pancreatic_lesion", "postcava", "spleen", "stomach",
    "liver_lesion", "kidney_lesion",
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 w/o TC
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max|Δ| ≤ tol·(1+max|ref|)
# whole model, kernels vs plain versions. float32: sums in another order
# through ~60 layers, max|Δ| ≤ MODEL32_TOL·(1+max|ref|). bf16: a different
# rounding of single bf16 activations propagates through the layers, so the
# bound is the plain bf16 run's own distance from the plain float32 run
MODEL32_TOL, BF16_NOISE_FACTOR = 1e-3, 1.5
# blended float32 probabilities, kernels vs plain: the sigmoid's slope is at
# most 1/4, so the float32 model bound MODEL32_TOL·(1 + max|logit|), at the
# logits' magnitude of this model (max|logit| ≈ 11, model phase), gives
# 0.25 · 1e-3 · 12 = 3e-3
PROB_TOL = 3e-3
# the same, each side rounded to float16 as validation leaves them: half a
# float16 spacing each (2^-12 in [0.5, 1))
PROB16_TOL = PROB_TOL + 2.0 ** -11
WINDOW = 96  # edge of the sliding window, as the serving path runs it
VOLUME = 256  # edge of the synthetic phantom, voxels of 1 mm (125 windows)
REPS = 3  # timed calls per measurement, after one warm-up call
DEVICE_REPS = 20  # graph replays of a device_ms measurement
TRAIN_STEPS = 10  # timed training steps, after one warm-up step
# training step, kernels vs plain versions. float32: losses 1e-4 relative;
# per parameter ‖Δg‖ ≤ tol·(‖g_ref‖ + TRAIN_FLOOR·max‖g_ref‖) with tol the
# larger of TRAIN32_TOL and 4× what one float32 rounding of the input moves
# the gradients by (`_kernels_vs_plain`); the floor gives a scale to
# gradients that are zero but for rounding. bf16: losses and the global
# relative L2 of all gradients against the plain bf16 run's own distance from
# the plain float32 run, times BF16_NOISE_FACTOR
TRAIN32_TOL, TRAIN_FLOOR = 2e-3, 1e-3
RHO_MAX = 2e-2  # a larger amplification ρ would let the float32 bound pass anything
# the agreement check also runs at three cut depths (full width; the
# shallowest has one attention block a stage), where bf16 rounding is not yet
# amplified to saturation
CUT_DEPTH = {"trans_num": (0, 1, 1, 1, 1, 1, 0, 0), "fusion_depth": 1}
MID_DEPTH = {"trans_num": (0, 1, 2, 3, 2, 1, 0, 0), "fusion_depth": 1}
DEEP_DEPTH = {"trans_num": (0, 2, 3, 4, 3, 2, 0, 0)}
MODEL_ARGS: dict = {}  # MedFormer's default configuration


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int) -> float:
    """The device time of one call alone: the call is captured once in a
    CUDA graph (after two warm-up calls on the capturing stream) and the
    graph replayed `reps` times between two events, so the host's launch
    path is not timed. The kernels' ctypes launches go to the current
    stream, which is the capturing one inside the capture."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / reps


def device_ops(fn) -> int:
    """The device operations (kernels, and copies or fills if any) that one
    call launches: the nodes of a CUDA graph of the call
    (``rsuper_tpu_torch.utils.device.graph_ops``). A torch.profiler window
    of the same calls now and then recorded no device event at all."""
    from rsuper_tpu_torch.utils.device import graph_ops

    return len(graph_ops(fn))


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


# ------------------------------------------------------------ kernel cases
# (name, route source, TPU kernel it replaces, shapes at 96³ windows, batch 8)
CONV_SHAPES = {  # (B, D, Ci, H, W, Co)
    # the stem: the serving path's window batch of 8, the training step's 1
    "conv3x3x3_cf": [(8, 96, 1, 96, 96, 32), (1, 96, 1, 96, 96, 32)],
    "in_relu_conv3x3x3_cf": [(8, 96, 32, 96, 96, 32),
                             (8, 96, 96, 96, 96, 64),
                             (8, 48, 64, 48, 48, 64),
                             (8, 48, 192, 48, 48, 128)],
}
# the validation path: 128³ windows in batches of 4 (the preset's
# training_size, validate_cases' batch): the stem, the fused forward's
# largest shape and those it runs most, the depthwise forward's largest
# and those it runs most (a forward's launches: the stem 1; fused
# (4,128,32,…,32) 5, (4,64,64,…,64) 7; depthwise (4,16,16,16,256) 15,
# (4,8,8,8,320) 12, (4,32,32,32,128) 7, (4,64,64,64,256) 1)
VAL_CONV_SHAPES = {
    "conv3x3x3_cf": [(4, 128, 1, 128, 128, 32)],
    "in_relu_conv3x3x3_cf": [(4, 128, 96, 128, 128, 64),
                             (4, 128, 32, 128, 128, 32),
                             (4, 64, 64, 64, 64, 64)],
}
VAL_DW_SHAPES = [(4, 64, 64, 64, 256), (4, 32, 32, 32, 128),
                 (4, 16, 16, 16, 256), (4, 8, 8, 8, 320)]
# the CLIP and classification heads' extra DownBlockMF on x4 at the
# preset's 128³ × 2 (8³ × 320 → 4³): the patch merge (8·320 channels), the
# attention's input projection (160), its output projection (4 heads × 32)
# and the MBConv feed-forward's depthwise (4 × 160); forward and backward
CLIP_DW_SHAPES = [(2, 4, 4, 4, c) for c in (2560, 640, 160, 128)]
DW_SHAPES = [  # (B, D, H, W, C)
    (8, 48, 48, 48, 256), (8, 24, 24, 24, 128), (8, 24, 24, 24, 384),
    (8, 24, 24, 24, 512), (8, 12, 12, 12, 256), (8, 12, 12, 12, 576),
    (8, 12, 12, 12, 1024), (8, 6, 6, 6, 320), (8, 6, 6, 6, 1280),
    (8, 6, 6, 6, 2048),
]
# training step at one 96³ patch: (B, D, C of dy, H, W, C of dx) for dgrad,
# (B, D, Ci, H, W, Co) for wgrad; the last of each list has B = 2
DGRAD_SHAPES = [(1, 96, 32, 96, 96, 32), (1, 96, 64, 96, 96, 96),
                (1, 48, 64, 48, 48, 64), (1, 48, 128, 48, 48, 192),
                (2, 48, 64, 48, 48, 64)]
WGRAD_SHAPES = {
    "conv3x3x3_cf_wgrad": [(1, 96, 1, 96, 96, 32), (2, 96, 1, 96, 96, 32)],
    "in_relu_conv3x3x3_cf_wgrad": [(1, 96, 32, 96, 96, 32),
                                   (1, 96, 96, 96, 96, 64),
                                   (1, 48, 64, 48, 48, 64),
                                   (1, 48, 192, 48, 48, 128),
                                   (2, 48, 64, 48, 48, 64)],
}
DW_BWD_SHAPES = [(1,) + s[1:] for s in DW_SHAPES] + [(2, 24, 24, 24, 512)]
# the depthwise forward at the serving path's window batches of 8 and at the
# training step's batch of 1
DW_FWD_SHAPES = DW_SHAPES + DW_BWD_SHAPES[:-1]
# top-N bisection, float32 as the Ball Loss calls it: (B, V, K) for the
# batched kernel, the first being the training step's shape and B = 9 more
# clusters of 16 than the card holds at once; (V, K) for the single volume
TOPN_SHAPES = [(1, 96 ** 3, 3), (2, 96 ** 3, 3), (1, 128 ** 3, 3),
               (2, 4099, 2), (9, 96 ** 3, 3)]
TOPN_SINGLE_SHAPES = [(96 ** 3, 3), (96 ** 3, 1)]
TOPN_ITERS = 26
TOPN_REPS = 20  # timed calls of a top-N measurement (well under 1 ms each)
DICE_STEPS = 5  # timed steps of the loss="dice" step beside the main path
KERNELS = {
    "conv3x3x3_cf": dict(
        source="rsuper_tpu_torch/csrc/conv_cf.cu",
        replaces="rsuper_tpu/ops/conv_cf.py:1080"),
    "in_relu_conv3x3x3_cf": dict(
        source="rsuper_tpu_torch/csrc/conv_cf.cu",
        replaces="rsuper_tpu/ops/conv_cf.py:1080"),
    "depthwise_conv3x3x3": dict(
        source="rsuper_tpu_torch/csrc/dwconv.cu",
        replaces="rsuper_tpu/ops/dwconv.py:212"),
    "conv3x3x3_cf_dgrad": dict(  # the forward kernel on flipped weights
        source="rsuper_tpu_torch/csrc/conv_cf.cu",
        replaces="rsuper_tpu/ops/conv_cf.py:1207"),
    "conv3x3x3_cf_wgrad": dict(
        source="rsuper_tpu_torch/csrc/conv_cf_wgrad.cu",
        replaces="rsuper_tpu/ops/conv_cf.py:1169"),
    "in_relu_conv3x3x3_cf_wgrad": dict(
        source="rsuper_tpu_torch/csrc/conv_cf_wgrad.cu",
        replaces="rsuper_tpu/ops/conv_cf.py:1169"),
    "depthwise_conv3x3x3_bwd": dict(  # dx and dw in one kernel
        source="rsuper_tpu_torch/csrc/dwconv_bwd.cu",
        replaces="rsuper_tpu/ops/dwconv.py:229"),
    "topn_threshold_multi": dict(
        source="rsuper_tpu_torch/csrc/topn.cu",
        replaces="rsuper_tpu/ops/pallas_topn.py:63"),
    "topn_threshold_multi_batched": dict(
        source="rsuper_tpu_torch/csrc/topn.cu",
        replaces="rsuper_tpu/ops/pallas_topn.py:128"),
}
NO_LIBRARY = ("in_relu_conv3x3x3_cf", "in_relu_conv3x3x3_cf_wgrad")
SERVING_KERNELS = ("conv3x3x3_cf", "in_relu_conv3x3x3_cf",
                   "depthwise_conv3x3x3")


def wrappers():
    """name → wrapper (each counts its launches) for every ported kernel."""
    from rsuper_tpu_torch.ops import conv_cf, dwconv, topn

    mods = {**{n: conv_cf for n in KERNELS if "conv3x3x3_cf" in n},
            **{n: topn for n in KERNELS if n.startswith("topn_")},
            "depthwise_conv3x3x3": dwconv, "depthwise_conv3x3x3_bwd": dwconv}
    return {n: getattr(mods[n], n) for n in KERNELS}


def _err(got, ref):
    import torch

    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        return math.inf, 0.0
    return (g - r).abs().max().item(), r.abs().max().item()


def phase_kernels(dev, reps: int):
    import torch
    import torch.nn.functional as F

    from rsuper_tpu_torch.ops import conv_cf, dwconv
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, failures = [], []

    def case(name, fn, args, ref_args, flops, nbytes, library, dtype, shape,
             route=None, ref64=None, no_prologue=None, device=False,
             function=None, path=None):
        got = fn(*args)
        with plain_on_device():
            ref = fn(*ref_args)
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        acc = {}
        if ref64 is not None:  # recorded beside the check, not a bound
            r64 = ref64()
            top = r64.abs().max().item()
            acc = dict(rel_err64=(got[0].double() - r64).abs().max().item() / top,
                       plain_rel_err64=(ref[0].double() - r64).abs().max().item()
                       / top)
            del r64
        err, tol, ok = 0.0, 0.0, True
        for g, r in zip(got, ref):  # each output at its own type's tolerance
            e, mx = _err(g, r)
            t = TOL[str(g.dtype).split(".")[-1]] * (1.0 + mx)
            ok = ok and e <= t
            if e >= err:
                err, tol = e, t
        row = dict(name=name, dtype=dtype, shape=list(shape),
                   max_abs_err=err, tol=tol, ok=ok, **acc)
        if route is not None:
            row["route"] = route
        if path is not None:  # a shape of another path than the line's
            row["path"] = path
        if device:  # device operations of one call (and of the Function's
            # backward, where it is given as (forward and backward, forward
            # alone): a graph captures the backward on the forward's stream)
            row["kernels_per_call"] = device_ops(lambda: fn(*args))
            if function is not None:
                row["function_kernels_per_call"] = (device_ops(function[0])
                                                    - device_ops(function[1]))
        if dtype == "bfloat16":  # timings in the serving path's type
            row["ms"] = time_ms(lambda: fn(*args), reps)
            if device:  # the device work alone, without the host's path
                row["device_ms"] = graph_ms(lambda: fn(*args), DEVICE_REPS)
            if route is not None:
                row["tflops"] = flops / row["ms"] / 1e9
            if no_prologue is not None:  # what the fused prologue costs
                row["no_prologue_ms"] = time_ms(no_prologue, reps)
            with plain_on_device():
                row["plain_ms"] = time_ms(lambda: fn(*ref_args), reps)
            row["library_ms"], row["library_call"] = (
                (time_ms(library[1], reps), library[0]) if library
                else (None, None))
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
        log(json.dumps({"kernel_case": row}))
        if not ok:
            failures.append(f"{name} {dtype} {shape}: max|Δ| {err} > {tol}")
        rows.append(row)
        del got, ref
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        conv_shapes = [(name, shape, None)
                       for name, shapes in CONV_SHAPES.items()
                       for shape in shapes]
        conv_shapes += [(name, shape, "validate")
                        for name, shapes in VAL_CONV_SHAPES.items()
                        for shape in shapes]
        for name, (B, D, Ci, H, W, Co), path in conv_shapes:
            fn = getattr(conv_cf, name)
            x = torch.randn((B, D, Ci, H, W), generator=gen, device=dev
                            ).to(dtype)
            w = torch.randn((3, 3, 3, Ci, Co), generator=gen, device=dev
                            ) / math.sqrt(27 * Ci)
            flops = 2.0 * B * D * H * W * Ci * Co * 27
            nbytes = x.numel() * x.element_size() + w.numel() * 4 \
                + B * D * Co * H * W * x.element_size()
            xn = x.permute(0, 2, 1, 3, 4).contiguous()
            wn = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous()
            lib = ("F.conv3d (cuDNN), NCDHW copy of x",
                   lambda xn=xn, wn=wn: F.conv3d(xn, wn, padding=1))
            alone = None
            if name == "in_relu_conv3x3x3_cf":
                # no library call fuses the norm: F.conv3d times the
                # conv alone, a yardstick kept out of library_ms; so
                # does the port's own kernel without the prologue
                lib = ("F.conv3d (cuDNN) of the conv alone, no norm",
                       lib[1])
                flops += 3.0 * x.numel()
                alone = lambda x=x, w=w: conv_cf.conv3x3x3_cf(x, w)
            case(name, fn, (x, w), (x, w), flops, nbytes, lib, dname,
                 (B, D, Ci, H, W, Co), conv_cf.conv_route(dtype, Ci),
                 no_prologue=alone, device=Ci == 1, path=path)
            del x, w
        dw_shapes = ([(s, None) for s in DW_FWD_SHAPES]
                     + [(s, "validate") for s in VAL_DW_SHAPES]
                     + [(s, "clip") for s in CLIP_DW_SHAPES])
        for (B, D, H, W, C), path in dw_shapes:
            x = torch.randn((B, D, H, W, C), generator=gen, device=dev
                            ).to(dtype)
            w = torch.randn((3, 3, 3, 1, C), generator=gen, device=dev) / 27
            flops = 2.0 * 27 * x.numel()
            nbytes = 2 * x.numel() * x.element_size() + 27 * C * 4
            xn = x.permute(0, 4, 1, 2, 3)  # channels_last_3d view, no copy
            wn = w.to(dtype).reshape(27, C).t().reshape(C, 1, 3, 3, 3)
            lib = ("F.conv3d groups=C (cuDNN), channels_last_3d view",
                   lambda xn=xn, wn=wn, C=C: F.conv3d(xn, wn, padding=1,
                                                      groups=C))
            case("depthwise_conv3x3x3", dwconv.depthwise_conv3x3x3, (x, w),
                 (x, w), flops, nbytes, lib, dname, (B, D, H, W, C),
                 device=True, path=path)
            del x, w
        backward_cases(case, gen, dev, dtype, dname)
    topn_cases(rows, failures, dev)
    return rows, failures


def topn_cases(rows, failures, dev):
    """The two top-N bisection kernels against the plain bisection, float32:
    thresholds and masks must be EQUAL (integer counts, the same float32
    arithmetic). Inputs per shape: a seeded uniform volume that is positive
    only inside one inserted ball (most voxels exactly 0; the timed one,
    with targets of the order the training batch gives), a dense normal
    volume (negatives), the ball volume with its last item all zero, the
    ball volume with a target above the positive count, and the ball volume
    quantized to 4 positive levels (ties: many mids and counts equal). The
    bound is the larger of the volume read once and iters·K + 1 compares a
    value. ``device_ms`` is one call captured in a CUDA graph and replayed,
    ``kernels_per_call`` the nodes of that graph, ``cluster`` the CTAs an
    item of the launch (``topn.plan_for``). ``library_ms`` times one
    ``torch.topk`` of every item's volume for the largest target n: the
    n-th value it returns is the threshold the bisection approximates.
    ``kthvalue_ms`` times ``torch.kthvalue`` for each target: an exact
    select, which gives the same mask up to the bisection's resolution but
    not the same threshold."""
    import torch

    from rsuper_tpu_torch.ops import selection, topn
    from rsuper_tpu_torch.ops.balls import insert_ball
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    gen = torch.Generator(device=dev).manual_seed(7)

    def inputs(B, V, K):
        edge = round(V ** (1.0 / 3.0))
        u = torch.rand((B, V), generator=gen, device=dev)
        if edge ** 3 == V:  # one ball of diameter 20 · 1.2, off the centre
            c = torch.full((B,), edge // 2, device=dev)
            inside = insert_ball((edge,) * 3, (c, c + 3, c - 5),
                                 torch.full((B,), 24.0, device=dev))
            ns = torch.tensor([4000.0, 3200.0, 4800.0][:K], device=dev)
        else:
            inside = (torch.rand((B, V), generator=gen, device=dev) < 0.5
                      ).float()
            ns = torch.tensor([1000.0, 800.0, 1200.0][:K], device=dev)
        x, ns = u * inside.reshape(B, V), ns.repeat(B, 1)
        zero, above = x.clone(), ns.clone()
        zero[-1] = 0.0
        above[:, 0] = float(V + 1)
        return [("ball", x, ns),
                ("dense", torch.randn((B, V), generator=gen, device=dev), ns),
                ("an_all_zero_item", zero, ns),
                ("n_above_the_positive_count", x, above),
                ("ties", torch.ceil(x * 4.0) / 4.0, ns)]

    def run(name, fn, mask_fn, B, V, K, single, on_path):
        worst, mismatches = 0.0, 0
        cases = inputs(B, V, K)
        for _, x, ns in cases:
            a = (x[0], ns[0]) if single else (x, ns)
            got = fn(*a, iters=TOPN_ITERS)
            masks = mask_fn(*a, iters=TOPN_ITERS)
            with plain_on_device():
                ref = fn(*a, iters=TOPN_ITERS)
                ref_masks = mask_fn(*a, iters=TOPN_ITERS)
            torch.cuda.synchronize()
            worst = max(worst, _err(got, ref)[0])
            mismatches += int((masks != ref_masks).sum().item())
            del masks, ref_masks
        ok = worst == 0.0 and mismatches == 0
        _, x, ns = cases[0]
        a = (x[0], ns[0]) if single else (x, ns)
        row = dict(name=name, dtype="float32",
                   shape=[V, K] if single else [B, V, K], max_abs_err=worst,
                   mask_mismatches=mismatches, tol=0.0, ok=ok,
                   on_path=on_path)
        row["ms"] = time_ms(lambda: fn(*a, iters=TOPN_ITERS), TOPN_REPS)
        row["device_ms"] = graph_ms(lambda: fn(*a, iters=TOPN_ITERS),
                                    DEVICE_REPS)
        row["kernels_per_call"] = device_ops(lambda: fn(*a, iters=TOPN_ITERS))
        row["cluster"] = topn.plan_for(V, K, x.dtype, x.device, B).cluster
        with plain_on_device():
            row["plain_ms"] = time_ms(lambda: fn(*a, iters=TOPN_ITERS),
                                      TOPN_REPS)
        # the largest n values of each item in one call: the n-th of them is
        # the threshold the bisection approximates
        top_n = int(ns.max().clamp(1, V).item())
        row["library_ms"] = time_ms(
            lambda: torch.topk(a[0], top_n, dim=-1), TOPN_REPS)
        row["library_call"] = "torch.topk over the volume, n = max target"
        ks = (V - ns + 1).clamp(1, V).long().tolist()
        row["kthvalue_ms"] = time_ms(
            lambda: [torch.kthvalue(x[b], k) for b in range(B)
                     for k in ks[b]], TOPN_REPS)
        row["bound_ms"], row["bound_by"] = bound_ms(
            float(B) * V * (TOPN_ITERS * K + 1), B * V * 4 + 2 * B * K * 4,
            "float32")
        log(json.dumps({"kernel_case": row}))
        if not ok:
            failures.append(f"{name} {row['shape']}: max|Δ| {worst}, "
                            f"{mismatches} mask voxels differ (must be 0)")
        rows.append(row)
        torch.cuda.empty_cache()

    for i, (B, V, K) in enumerate(TOPN_SHAPES):
        run("topn_threshold_multi_batched", topn.topn_threshold_multi_batched,
            selection.topn_masks_multi_batched, B, V, K, False, i == 0)
    for i, (V, K) in enumerate(TOPN_SINGLE_SHAPES):
        run("topn_threshold_multi", topn.topn_threshold_multi,
            selection.topn_masks_multi, 1, V, K, True, i == 0)


def backward_cases(case, gen, dev, dtype, dname):
    """The backward kernels at the training step's shapes. The library call
    is ``aten.convolution_backward`` (cuDNN) with the matching output mask,
    on NCDHW copies made outside the timer."""
    import torch

    from rsuper_tpu_torch.ops import conv_cf, dwconv

    cb = torch.ops.aten.convolution_backward

    def conv_lib(xn, gn, wn, mask, groups=1):
        return lambda: cb(gn, xn, wn, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                          False, [0, 0, 0], groups, mask)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    for (B, D, Cg, H, W, Cx) in DGRAD_SHAPES:
        dy = rand((B, D, Cg, H, W)).to(dtype)
        w = rand((3, 3, 3, Cx, Cg)) / math.sqrt(27 * Cx)
        flops = 2.0 * B * D * H * W * Cx * Cg * 27
        nbytes = (dy.numel() + B * D * Cx * H * W) * dy.element_size() \
            + w.numel() * 4
        gn = dy.permute(0, 2, 1, 3, 4).contiguous()
        xn = torch.empty((B, Cx, D, H, W), dtype=dtype, device=dev)
        wn = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous()
        lib = ("aten.convolution_backward (cuDNN), input gradient only",
               conv_lib(xn, gn, wn, [True, False, False]))
        case("conv3x3x3_cf_dgrad", conv_cf.conv3x3x3_cf_dgrad, (dy, w),
             (dy, w), flops, nbytes, lib, dname, (B, D, Cg, H, W, Cx),
             conv_cf.conv_route(dtype, Cg))
        del dy, w, gn, xn, wn
    for name, shapes in WGRAD_SHAPES.items():
        fused = name.startswith("in_relu")
        for (B, D, Ci, H, W, Co) in shapes:
            x = rand((B, D, Ci, H, W)).to(dtype)
            dy = rand((B, D, Co, H, W)).to(dtype)
            flops = 2.0 * B * D * H * W * Ci * Co * 27
            nbytes = (x.numel() + dy.numel()) * x.element_size() \
                + 27 * Ci * Co * 4
            xn = x.permute(0, 2, 1, 3, 4).contiguous()
            gn = dy.permute(0, 2, 1, 3, 4).contiguous()
            wn = torch.empty((Co, Ci, 3, 3, 3), dtype=dtype, device=dev)
            lib = ("aten.convolution_backward (cuDNN), weight gradient only"
                   + (" of the conv alone, no norm" if fused else ""),
                   conv_lib(xn, gn, wn, [False, True, False]))
            args = (x, dy)
            if fused:
                args += (conv_cf._in_stats_cf(x, 1e-4),)
                flops += 3.0 * x.numel()
            case(name, getattr(conv_cf, name), args, args, flops, nbytes, lib,
                 dname, (B, D, Ci, H, W, Co), conv_cf.conv_route(dtype, Ci),
                 (lambda args=args: _wgrad64(*args)) if dname == "bfloat16"
                 else None, device=Ci == 1)
            del x, dy, xn, gn, wn, args
    for (B, D, H, W, C), path in ([(s, None) for s in DW_BWD_SHAPES]
                                  + [(s, "clip") for s in CLIP_DW_SHAPES]):
        x = rand((B, D, H, W, C)).to(dtype)
        dy = rand((B, D, H, W, C)).to(dtype)
        w = rand((3, 3, 3, 1, C)) / 27
        flops = 4.0 * 27 * x.numel()  # dx and dw
        nbytes = 3 * x.numel() * x.element_size() + 2 * 27 * C * 4
        xn, gn = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        wn = w.to(dtype).reshape(27, C).t().reshape(C, 1, 3, 3, 3)
        lib = ("aten.convolution_backward groups=C (cuDNN), input and weight "
               "gradients, channels_last_3d views",
               conv_lib(xn, gn, wn, [True, True, False], groups=C))
        xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()

        def forward(xg=xg, wg=wg):
            return dwconv.depthwise_conv3x3x3(xg, wg)

        def function(xg=xg, wg=wg, dy=dy):  # the Function's backward: dx
            # and dw (rounded to x's type, cast to w's) from dy
            return torch.autograd.grad(forward(xg, wg), (xg, wg), dy)

        case("depthwise_conv3x3x3_bwd", dwconv.depthwise_conv3x3x3_bwd,
             (x, w, dy), (x, w, dy), flops, nbytes, lib, dname,
             (B, D, H, W, C), device=True, function=(function, forward),
             path=path)
        del x, dy, w, xg, wg


def _wgrad64(x, dy, stats=None):
    """dw of the SAME 3³ conv summed in float64, from the activation that
    the kernels and the plain version both use (rounded to x's type): the
    yardstick of the float32 sums' own error."""
    import torch
    import torch.nn.functional as F

    B, D, Ci, H, W = x.shape
    a = x
    if stats is not None:
        st = stats.reshape(B, 2, Ci)
        a = torch.clamp(x.float() * st[:, 0, None, :, None, None]
                        + st[:, 1, None, :, None, None], min=0.0).to(x.dtype)
    ap = F.pad(a.double(), (1, 1, 1, 1, 0, 0, 1, 1))
    g = dy.double()
    taps = [torch.einsum("bdihw,bdohw->io",
                         ap[:, kd:kd + D, :, kh:kh + H, kw:kw + W], g)
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, Ci, dy.shape[2])


def kernels_line(rows, launches):
    """One entry per kernel: its error is the largest over the production
    shapes in the path's type (the timed rows: bf16, float32 for top-N), the
    validation path's included; its times are those of its heaviest shape
    of the serving or training path, for top-N those of the training step's
    shape."""
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["name"] == name and "ms" in r]
        own = [r for r in mine if "path" not in r]
        top = max([r for r in own if r.get("on_path")] or own,
                  key=lambda r: r["bound_ms"])
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            sources=meta.get("sources", [meta["source"]]),
            replaces=meta["replaces"], launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"],
            library_ms=(None if name in NO_LIBRARY else top["library_ms"]),
            shape=top["shape"]))
        if "device_ms" in top:
            out[-1]["device_ms"] = top["device_ms"]
        if "kernels_per_call" in top:
            out[-1]["kernels_per_call"] = top["kernels_per_call"]
        if "route" in top:  # the conv kernels' own route at that shape
            out[-1]["conv_route"] = top["route"]
        if "cluster" in top:  # the top-N kernel's CTAs an item
            out[-1]["cluster"] = top["cluster"]
    return {"kernels": out}


def ptxas_summary(report: str):
    """Per kernel of nvcc's ``-Xptxas -v`` report: its (mangled) name,
    registers a thread, static shared memory, stack and spill bytes."""
    out = []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"kernel": m.group(1)})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem"] = int(m.group(1)) if m else 0
    return out


def _model_fn(model):
    def fn(x):
        out = model(x)["segmentation"]
        return out[0] if isinstance(out, (list, tuple)) else out
    return fn


def _build_models(dev):
    """Default-config MedFormer with seeded random weights: the serving
    model (bf16 compute) and the same weights computing in float32."""
    import torch

    from rsuper_tpu_torch.models import get_model, init_params

    model = get_model("medformer", len(CLASSES), MODEL_ARGS, dtype=torch.bfloat16)
    model = init_params(model, seed=0).to(dev).eval()
    model32 = get_model("medformer", len(CLASSES), MODEL_ARGS, dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    return model, model32.to(dev).eval()


def _dist(got, ref):
    import torch

    g, r = got.float(), ref.float()
    return dict(finite=bool(torch.isfinite(g).all()),
                max_abs_err=(g - r).abs().max().item(),
                max_abs_ref=r.abs().max().item(),
                rel_l2=((g - r).norm() / r.norm()).item())


def phase_model(model, model32, dev, reps: int):
    """One 96³ window batch of 2 through the kernels and through the plain
    versions: in float32 at MODEL32_TOL, and in bf16 against the bf16
    rounding noise (the plain bf16 run's distance from the plain float32
    run, times BF16_NOISE_FACTOR). Then forward times at batch 8 and a
    profile of one batch-8 forward."""
    import torch

    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, *(WINDOW,) * 3, 1), generator=gen, device=dev)
    with torch.inference_mode():
        got = model(x)["segmentation"]
        got32 = model32(x)["segmentation"]
        with plain_on_device():
            ref = model(x)["segmentation"]
            ref32 = model32(x)["segmentation"]
    torch.cuda.synchronize()
    failures, res = [], {}
    for i, name in enumerate(("logits", "aux")):
        shape_ok = tuple(got[i].shape) == (2, *(WINDOW,) * 3, len(CLASSES))
        f32 = _dist(got32[i], ref32[i])
        bf16 = _dist(got[i], ref[i])
        noise = _dist(ref[i], ref32[i])
        f32["tol"] = MODEL32_TOL * (1 + f32["max_abs_ref"])
        bf16["tol_rel_l2"] = BF16_NOISE_FACTOR * noise["rel_l2"]
        bf16["tol_max"] = BF16_NOISE_FACTOR * noise["max_abs_err"]
        ok = (shape_ok and f32["finite"] and bf16["finite"]
              and f32["max_abs_err"] <= f32["tol"]
              and bf16["rel_l2"] <= bf16["tol_rel_l2"]
              and bf16["max_abs_err"] <= bf16["tol_max"])
        res[name] = dict(shape=list(got[i].shape), float32=f32,
                         bfloat16=bf16, bf16_noise=noise, ok=ok)
        if not ok:
            failures.append(f"model {name}: {res[name]}")
    del got, got32, ref, ref32
    xb = torch.randn((8, *(WINDOW,) * 3, 1), generator=gen, device=dev)
    with torch.inference_mode():
        res["forward_b8_ms"] = time_ms(lambda: model(xb), reps)
        with plain_on_device():
            res["forward_b8_plain_ms"] = time_ms(lambda: model(xb), reps)
        res["profile_b8"] = _profile(lambda: model(xb))
    log(json.dumps({"model": res}))
    return failures


def _profile(fn, top: int = 25, spans=(), between=None):
    """Device time of one call by kernel (torch.profiler), the busy share of
    the call's wall time, the number of device operations, the depthwise
    kernels' device time and launches (kernel names holding ``dw3``), those
    of the stem's forward and weight gradient kernels (``stem_fwd``,
    ``stem_wgrad``), and the `top` kernels by device time. For every
    name in `spans` (in the order they run) that `fn` marks with
    ``torch.profiler.record_function``: the stretch of the device's timeline
    from its first kernel to its last, and the kernel time inside it. A
    marked range covers only kernels launched from the marking thread, and
    autograd launches the backward's from its own: that span is named by
    `between` and taken as what lies between its neighbours' ranges, which
    is exact on one in-order stream. A first call of `fn` is the profiler's
    warm-up and is dropped: the first device records after the profiler
    starts can be lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()  # the warm-up call ends: recording begins
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # an operator's device time is its kernels' rows too, and a marked
        # range shows on the device's timeline as one more row: skip both
        if ev.device_type == DeviceType.CPU or ev.is_user_annotation:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    dw = [r for r in rows if "dw3" in r[2]]  # the depthwise kernels
    res = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_busy_share=busy_ms / wall_ms if wall_ms else None,
               device_ops=sum(r[1] for r in rows),
               depthwise=dict(ms=sum(r[0] for r in dw),
                              kernels=sum(r[1] for r in dw)),
               stem={k: dict(ms=sum(r[0] for r in rows if k in r[2]),
                             kernels=sum(r[1] for r in rows if k in r[2]))
                     for k in ("stem_fwd", "stem_wgrad")},
               top=[dict(ms=ms, calls=n, name=k[:90])
                    for ms, n, k in rows[:top]])
    if spans:
        on_dev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
        kernels = [e.time_range for e in on_dev if not e.is_user_annotation]
        marked = {e.name: e.time_range for e in on_dev
                  if e.is_user_annotation and e.name in spans}
        res["spans"] = {}
        for i, name in enumerate(spans):
            if name == between:  # its neighbours' ranges bound it
                start = marked[spans[i - 1]].end
                end = marked[spans[i + 1]].start
            else:
                start, end = marked[name].start, marked[name].end
            busy_us = sum(k.end - k.start for k in kernels
                          if start <= k.start and k.end <= end)
            res["spans"][name] = dict(device_span_ms=(end - start) / 1e3,
                                      device_busy_ms=busy_us / 1e3,
                                      device_busy_share=busy_us / (end - start))
    return res


def phantom_ct(edge: int, seed: int = 2):
    """A synthetic abdominal CT in HU, 1 mm voxels: air around an elliptic
    body of soft tissue, with liver-, spleen- and kidney-like ellipsoids, a
    bone column, and Gaussian noise (σ 15 HU)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ax = np.linspace(-1.0, 1.0, edge, dtype=np.float32)
    z, y, x = ax[:, None, None], ax[None, :, None], ax[None, None, :]

    def inside(cz, cy, cx, rz, ry, rx):
        return ((z - cz) / rz) ** 2 + ((y - cy) / ry) ** 2 \
            + ((x - cx) / rx) ** 2 <= 1.0

    ct = np.full((edge,) * 3, -1000.0, np.float32)
    for hu, ell in ((40.0, (0.0, 0.0, 0.0, 2.0, 0.7, 0.9)),     # body
                    (60.0, (0.2, -0.1, -0.4, 0.5, 0.35, 0.3)),  # liver
                    (45.0, (0.2, 0.1, 0.5, 0.3, 0.2, 0.15)),    # spleen
                    (30.0, (-0.2, 0.3, -0.35, 0.25, 0.12, 0.1)),
                    (30.0, (-0.2, 0.3, 0.35, 0.25, 0.12, 0.1)),
                    (700.0, (0.0, 0.45, 0.0, 2.0, 0.1, 0.1))):   # spine
        ct[np.broadcast_to(inside(*ell), ct.shape)] = hu
    ct += rng.normal(0.0, 15.0, ct.shape).astype(np.float32)
    return ct


def phase_predict(model, model32, dev, edge: int):
    """predict_folder on a synthetic CT (the CLI's path), launch counts read
    around it; the host's preprocessing alone; predict_masks_volume through
    the kernels (masks only, and with the lesion probabilities as
    predict_folder asks for them) and through the plain versions; blended
    float32 probabilities against the plain versions."""
    import numpy as np
    import torch

    from rsuper_tpu_torch.data.nifti import read_nifti, write_nifti
    from rsuper_tpu_torch.data.preprocess import clip_and_normalize
    from rsuper_tpu_torch.inference.predict import (predict_folder,
                                                    predict_masks_volume,
                                                    preprocess_volume)
    from rsuper_tpu_torch.inference.sliding_window import (
        _grid, sliding_window_probs_device)
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    ct = phantom_ct(edge)
    fn = _model_fn(model)
    counted = wrappers()
    win = (WINDOW,) * 3
    n_windows = len(_grid((edge,) * 3, win, (WINDOW // 2,) * 3))
    failures, res = [], {"volume": [edge] * 3, "window": list(win),
                         "batch": 8, "windows": n_windows,
                         "window_batches": math.ceil(n_windows / 8)}
    lesions = [c for c in CLASSES if "lesion" in c]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        write_nifti(os.path.join(src, "case0.nii"), ct, np.eye(4))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in counted.values():
            w.launches = 0
        t0 = time.time()
        done = predict_folder([fn], src, dst, CLASSES, window=win,
                              batch=8, save_probabilities=True, device=dev)
        torch.cuda.synchronize()
        res["predict_folder_s"] = time.time() - t0
        res["launches"] = {k: counted[k].launches for k in SERVING_KERNELS}
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        err_file = os.path.join(dst, "prediction_errors.txt")
        if done != ["case0"] or os.path.exists(err_file):
            msg = open(err_file).read() if os.path.exists(err_file) else ""
            failures.append(f"predict_folder did not finish: {done} {msg}")
        else:
            for cls in CLASSES:
                m = read_nifti(os.path.join(dst, "case0", f"{cls}.nii.gz"))
                if m.data.shape != ct.shape or not set(
                        np.unique(m.data)) <= {0, 1}:
                    failures.append(f"mask {cls}: {m.data.shape}")
            for cls in lesions:
                p = read_nifti(os.path.join(dst, "case0",
                                            f"{cls}_prob.nii.gz")).data
                if not (np.isfinite(p).all() and p.min() >= 0
                        and p.max() <= 1):
                    failures.append(f"lesion probabilities {cls} invalid")
        for k, n in res["launches"].items():
            if n <= 0:
                failures.append(f"kernel {k} was not launched on the path")
        t0 = time.time()  # the host's share of predict_folder: reading
        preprocess_volume(os.path.join(src, "case0.nii"), min_size=win)
        res["preprocess_s"] = time.time() - t0
    vol = clip_and_normalize(ct)
    torch.cuda.synchronize()
    t0 = time.time()
    predict_masks_volume([fn], vol, CLASSES, window=win, batch=8,
                         device=dev)
    torch.cuda.synchronize()
    res["predict_masks_volume_s"] = time.time() - t0
    t0 = time.time()  # as predict_folder calls it: lesion probabilities too
    predict_masks_volume([fn], vol, CLASSES, window=win, batch=8,
                         prob_channels=[CLASSES.index(c) for c in lesions],
                         device=dev)
    torch.cuda.synchronize()
    res["predict_masks_volume_probs_s"] = time.time() - t0
    with plain_on_device():
        t0 = time.time()
        predict_masks_volume([fn], vol, CLASSES, window=win,
                             batch=8, device=dev)
        torch.cuda.synchronize()
        res["predict_masks_volume_plain_s"] = time.time() - t0

    e = WINDOW + WINDOW // 6
    small = vol[:e, :e, :e].copy()  # 8 windows: one batch
    fn32 = _model_fn(model32)
    got = sliding_window_probs_device(fn32, small, len(CLASSES),
                                      window=win, batch=8,
                                      device=dev)
    with plain_on_device():
        ref = sliding_window_probs_device(fn32, small, len(CLASSES),
                                          window=win, batch=8,
                                          device=dev)
    d = (got - ref).abs()
    res["probs32_vs_plain"] = dict(max_abs_err=d.max().item(),
                                   mean_abs_err=d.mean().item(),
                                   tol=PROB_TOL)
    if not d.max().item() <= PROB_TOL:
        failures.append(f"probabilities vs plain: {res['probs32_vs_plain']}")
    log(json.dumps({"predict": res}))
    return failures, res["launches"]


SERVE_EDGES = (144, 120)  # the serve phase's two cases: 8 windows of 96³ each
CLI_WINDOW = 128  # the predict CLI's default window
CLI_BATCHES = (4, 8)  # window batches timed at CLI_WINDOW
SERVE_GT = (  # per-CT lesion counts: liver, pancreatic, kidney
    ("BDMAP_00000001", 0, 1, 0), ("BDMAP_00000002", 0, 0, 0))
EVAL_FILES = 18  # 9 detection tables and 9 metric tables


def _masks(out: Path, case: str):
    import numpy as np

    from rsuper_tpu_torch.data.nifti import read_nifti

    return {c: np.asarray(read_nifti(str(out / case / f"{c}.nii.gz")).data)
            for c in CLASSES}


def _same_masks(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(a[c], b[c]) for c in CLASSES)


def phase_serve(dev):
    """Serving a checkpoint of any origin, scoring the predictions, and the
    serving benchmark, at full width (default MedFormer, 16 classes, bf16,
    96³ windows in batches of 8 on synthetic CTs of SERVE_EDGES):

    a. a checkpoint that ``CheckpointManager`` writes from seeded weights,
       with an EMA copy of other seeded weights: the predict CLI's masks from
       ``--checkpoint DIR --tag best`` equal, bit for bit, those from
       ``--params_npz`` of the same weights; ``--ema`` those of the EMA
       weights' ``.npz`` and not the parameters'; ``--tag best`` on a
       directory holding ``latest`` alone falls back to it;
    b. the same weights exported to a reference-layout ``.pth``
       (``{'model_state_dict', 'ema_model_state_dict'}``, DDP prefixes),
       converted by ``convert_checkpoint`` and served with ``{"torch_port":
       true}`` with the lesion probabilities saved, on two cases, the launch
       counts set to 0 just before and read just after (rows 1, 2 and 5
       must be launched); the torch_port model's blended float32
       probabilities through the kernels against the plain versions
       (PROB_TOL);
    c. ``evaluate.main`` on (b)'s folder with a per-CT CSV (one case with a
       pancreatic lesion): every file written, its seconds;
    d. ``bench_infer.main --reps 1``: its line and its keys;
    e. ``predict_masks_volume`` on a VOLUME³ phantom at the CLI's 128³
       windows in batches of 4 and of 8: seconds a volume and peak
       memory."""
    import numpy as np
    import torch

    from rsuper_tpu_torch import bench_infer, convert_checkpoint, evaluate
    from rsuper_tpu_torch import predict as cli
    from rsuper_tpu_torch.data.nifti import write_nifti
    from rsuper_tpu_torch.data.preprocess import clip_and_normalize
    from rsuper_tpu_torch.eval.sens_spec import best_f1
    from rsuper_tpu_torch.inference.predict import predict_masks_volume
    from rsuper_tpu_torch.inference.sliding_window import \
        sliding_window_probs_device
    from rsuper_tpu_torch.models import (flax_from_state_dict, get_model,
                                         init_params)
    from rsuper_tpu_torch.models.torch_port import export_state_dict
    from rsuper_tpu_torch.ops.dispatch import plain_on_device
    from rsuper_tpu_torch.train import create_train_state, make_optimizer
    from rsuper_tpu_torch.train.checkpoint import (CheckpointManager,
                                                   load_params)
    from rsuper_tpu_torch.utils.device import card_line

    t_phase = time.time()
    failures, res = [], {"card": card_line(), "window": WINDOW, "batch": 8,
                         "edges": list(SERVE_EDGES)}
    counted = wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cases = [g[0] for g in SERVE_GT]
        for d in ("in1", "in2"):
            (root / d).mkdir()
        for i, (case, edge) in enumerate(zip(cases, SERVE_EDGES)):
            ct = phantom_ct(edge, seed=3 + i)
            for d in (("in1", "in2") if i == 0 else ("in2",)):
                write_nifti(str(root / d / f"{case}.nii"), ct, np.eye(4))
        (root / "classes.json").write_text(json.dumps(CLASSES))

        # a. the port's own checkpoints
        t0 = time.time()
        model = get_model("medformer", len(CLASSES), MODEL_ARGS,
                          dtype=torch.bfloat16)
        params = init_params(model, seed=0).state_dict()
        ema = init_params(get_model("medformer", len(CLASSES), MODEL_ARGS),
                          seed=1).state_dict()
        state = create_train_state(model, make_optimizer(model.parameters()))
        state.ema_params = ema
        CheckpointManager(str(root / "run")).save_epoch(state, 0, metric=1.0)
        CheckpointManager(str(root / "latest_only")).save_epoch(state, 0)
        for name, sd in (("params", params), ("ema", ema)):
            np.savez(root / f"{name}.npz", **flax_from_state_dict(sd))

        def serve(name, source, inputs="in1", extra=()):
            out = root / "out" / name
            done = cli.main([
                "--input_dir", str(root / inputs), "--output_dir", str(out),
                *source, "--classes_json", str(root / "classes.json"),
                "--window", *[str(WINDOW)] * 3, "--batch_windows", "8",
                *extra])
            want = sorted(f.split(".nii")[0]
                          for f in os.listdir(root / inputs))
            if sorted(done) != want or (out / "prediction_errors.txt"
                                        ).exists():
                failures.append(f"serve {name}: predicted {done}")
            return out

        runs = {
            "checkpoint_best": ["--checkpoint", str(root / "run"),
                                "--tag", "best"],
            "params_npz": ["--params_npz", str(root / "params.npz")],
            "checkpoint_ema": ["--checkpoint", str(root / "run"), "--ema"],
            "ema_npz": ["--params_npz", str(root / "ema.npz")],
            "fallback_latest": ["--checkpoint", str(root / "latest_only"),
                                "--tag", "best"],
        }
        masks, secs = {}, {}
        for name, source in runs.items():
            t1 = time.time()
            masks[name] = _masks(serve(name, source), cases[0])
            secs[name] = time.time() - t1
        checks = {
            "checkpoint_equals_params_npz": _same_masks(
                masks["checkpoint_best"], masks["params_npz"]),
            "ema_equals_ema_npz": _same_masks(masks["checkpoint_ema"],
                                              masks["ema_npz"]),
            "ema_differs_from_params": not _same_masks(
                masks["checkpoint_ema"], masks["params_npz"]),
            "fallback_equals_params_npz": _same_masks(
                masks["fallback_latest"], masks["params_npz"]),
        }
        res["checkpoint"] = dict(
            checks, cli_s=secs, phase_s=time.time() - t0,
            mask_voxels={k: int(sum(m[c].sum() for c in CLASSES))
                         for k, m in masks.items()})
        failures += [f"serve checkpoint: {k}" for k, ok in checks.items()
                     if not ok]

        # b. a reference .pth through the converter, served with torch_port
        t0 = time.time()
        ref = {k: export_state_dict(flax_from_state_dict(sd))
               for k, sd in (("model_state_dict", params),
                             ("ema_model_state_dict", ema))}
        torch.save({k: {"module." + n: torch.from_numpy(v)
                        for n, v in sd.items()} for k, sd in ref.items()},
                   root / "model.pth")
        convert_checkpoint.main([str(root / "model.pth"), str(root / "conv"),
                                 "--classes", str(len(CLASSES))])
        conv = load_params(str(root / "conv"))
        res["pth"] = dict(converted_equal=all(
            torch.equal(conv[k], v) for k, v in params.items()),
            convert_s=time.time() - t0)
        tp = ["--checkpoint", str(root / "conv"),
              "--model_args_json", json.dumps({**MODEL_ARGS,
                                               "torch_port": True})]
        torch.cuda.synchronize()
        for w in counted.values():
            w.launches = 0
        t1 = time.time()
        pred = serve("torch_port", tp, "in2", ("--save_probabilities",))
        torch.cuda.synchronize()
        res["pth"]["serve_s"] = time.time() - t1
        res["pth"]["launches"] = {k: counted[k].launches
                                  for k in SERVING_KERNELS}
        for k, n in res["pth"]["launches"].items():
            if n <= 0:
                failures.append(f"serve torch_port: kernel {k} was not "
                                "launched")
        if not res["pth"]["converted_equal"]:
            failures.append("serve pth: converted parameters differ")
        model32 = get_model("medformer", len(CLASSES),
                            {**MODEL_ARGS, "torch_port": True},
                            dtype=torch.float32)
        model32.load_state_dict(conv)
        fn32 = _model_fn(model32.to(dev).eval())
        e = WINDOW + WINDOW // 6
        small = clip_and_normalize(phantom_ct(e, seed=3))  # 8 windows
        win = (WINDOW,) * 3
        got = sliding_window_probs_device(fn32, small, len(CLASSES),
                                          window=win, batch=8, device=dev)
        with plain_on_device():
            want = sliding_window_probs_device(fn32, small, len(CLASSES),
                                               window=win, batch=8,
                                               device=dev)
        d = (got - want).abs()
        res["pth"]["probs32_vs_plain"] = dict(
            max_abs_err=d.max().item(), mean_abs_err=d.mean().item(),
            tol=PROB_TOL)
        if not d.max().item() <= PROB_TOL:
            failures.append(f"serve torch_port probabilities vs plain: "
                            f"{res['pth']['probs32_vs_plain']}")
        del model32, fn32, got, want, d

        # c. the evaluation of (b)'s predictions
        gt = root / "per_ct.csv"
        gt.write_text("BDMAP_ID,number of liver lesion instances,number of "
                      "pancreatic lesion instances,number of kidney lesion "
                      "instances\n" + "".join(
                          ",".join(map(str, row)) + "\n" for row in SERVE_GT))
        t1 = time.time()
        evaluated = evaluate.main(["--pred_dir", str(pred), "--ground_truth",
                                   str(gt), "--out_dir", str(root / "eval")])
        eval_s = time.time() - t1
        names = sorted(os.listdir(root / "eval"))
        res["evaluate"] = dict(seconds=eval_s, files=len(names),
                               best_f1_pancreatic=best_f1(evaluated))
        if len(names) != EVAL_FILES or not all(
                (root / "eval" / f"metrics_th{th}.csv").exists()
                for th in (0.1, 0.5, 0.9)):
            failures.append(f"evaluate wrote {names}")

    # d. the serving benchmark
    t1 = time.time()
    line = bench_infer.main(["--reps", "1"])
    res["bench_infer"] = dict(line, call_s=time.time() - t1)
    keys = {"metric", "value", "unit", "seconds_per_volume",
            "seconds_per_volume_prob_transfer",
            "seconds_per_volume_masks_plus_lesion_probs", "prob_wire",
            "first_call_with_compile_s"}
    if set(line) != keys or not line["value"] > 0:
        failures.append(f"bench_infer line: {line}")

    # e. the CLI's default window at two window batches
    vol = clip_and_normalize(phantom_ct(VOLUME))
    fn = _model_fn(model.to(dev).eval())
    res["cli_window"] = {}
    for batch in CLI_BATCHES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        predict_masks_volume([fn], vol, CLASSES, window=(CLI_WINDOW,) * 3,
                             batch=batch, device=dev)  # warm-up
        torch.cuda.synchronize()
        t1 = time.time()
        predict_masks_volume([fn], vol, CLASSES, window=(CLI_WINDOW,) * 3,
                             batch=batch, device=dev)
        torch.cuda.synchronize()
        res["cli_window"][f"b{batch}"] = dict(
            s_per_volume=time.time() - t1,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model, fn
    torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"serve": res}))
    return failures


@contextmanager
def _ball_trace(keep_masks: bool = False):
    """Inside the block, record for every slot the Ball Loss isolates: the
    ball centres (z, y, x) and the voxel counts of the normal, small and big
    pseudo-masks, per item; with `keep_masks` the masks themselves. Each
    record reads from the device, so this wraps the checks and never a timed
    step."""
    import torch

    from rsuper_tpu_torch.losses import ball

    trace = []
    centres_of, isolate = ball._ball_centres, ball.isolate_tumor_batched

    def centres(x, diameter, cfg):
        c = centres_of(x, diameter, cfg)
        trace.append({"centres": torch.stack(c, dim=-1).tolist()})
        return c

    def isolated(x, diameter, volume, cfg):
        masks = isolate(x, diameter, volume, cfg)
        trace[-1]["voxels"] = torch.stack(
            [m.sum(dim=(1, 2, 3)) for m in masks], dim=-1).tolist()
        if keep_masks:
            trace[-1]["masks"] = masks
        return masks

    ball._ball_centres, ball.isolate_tumor_batched = centres, isolated
    try:
        yield trace
    finally:
        ball._ball_centres, ball.isolate_tumor_batched = centres_of, isolate


def _train_losses_and_grads(state, batch, lmap, cfg, clip_only=False):
    """One forward and backward from `state` (no update): every loss term as
    a float, the gradient of every parameter the loss reaches, and the Ball
    Loss's trace."""
    from rsuper_tpu_torch.train import loss_fn

    state.model.zero_grad(set_to_none=True)
    with _ball_trace() as trace:
        overall, losses = loss_fn(state.model, batch, lmap, cfg,
                                  clip_only=clip_only)
    overall.backward()
    grads = {k: p.grad.detach().clone()
             for k, p in state.model.named_parameters() if p.grad is not None}
    state.model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads, trace


def _kernels_vs_plain(dev, margs, batch, lmap, cfg, clip_only=False):
    """Losses and gradients of one forward and backward through the kernels
    against the plain versions, from the same seeded state (with
    `clip_only`, the CLIP step: the encoder and its head).

    With random weights the model amplifies rounding: one float32 rounding
    of the input image (x·(1 ± 2^-22)) moves the plain float32 gradients by
    ρ, about 1e-3 at the cut depth and 1e-2 at full depth. So the float32
    bound is, per parameter, ‖Δg‖ ≤ max(TRAIN32_TOL, 4ρ)·(‖g‖ + TRAIN_FLOOR·
    max‖g‖), with ρ measured here and held under RHO_MAX. In bf16 the kernel
    run is held against the plain bf16 run at BF16_NOISE_FACTOR times the
    largest of the plain bf16 run's own distance from plain float32 and its
    distances from three plain bf16 runs whose input differs by one bf16
    rounding. The gradient norms of all runs are recorded beside it: at full
    depth the bf16 norm itself moves by a factor of two from one such
    rounding, and the shallower depths show the kernels' distance growing
    with the noise, below it.

    The Ball Loss puts its ball at the argmax of a convolution of the
    sigmoid output, which is discontinuous in the logits: every run's ball
    centres and pseudo-mask voxel counts are recorded. The same nudged runs
    are the witness for its two terms. In float32, where the plain run's
    trace stays as it is under the nudge, the ball terms are held like the
    other terms (1e-4 relative); where the witness itself moves, the line
    says so and they are held at the witness's own spread times
    BF16_NOISE_FACTOR. In bf16 they are held at BF16_NOISE_FACTOR times the
    largest of the bf16 noise and the three witnesses' spreads."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    def run(state, b, plain=False):
        with plain_on_device() if plain else nullcontext():
            return _train_losses_and_grads(state, b, lmap, cfg, clip_only)

    fails = []
    state32 = bench_train.build_state(dev, False, margs, dtype=torch.float32)
    got32, ref32 = run(state32, batch), run(state32, batch, plain=True)
    image = batch["image"].float()

    def nudge(seed, step):  # x·(1 ± step), the signs drawn from `seed`
        sign = (torch.rand(image.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed)) > 0.5).float() * 2 - 1
        return image * (1 + step * sign)

    nudged = run(state32, {**batch, "image": nudge(3, 2.0 ** -22)},
                 plain=True)
    del state32
    state = bench_train.build_state(dev, False, margs)
    got16, ref16 = run(state, batch), run(state, batch, plain=True)
    # the witnesses: the plain bf16 run again, one bf16 rounding of the
    # input away (x·(1 ± 2^-8) moves about half the voxels by one ulp), for
    # three draws of the signs
    nudged16 = []
    for seed in (3, 4, 5):
        b = {**batch, "image": nudge(seed, 2.0 ** -8).to(batch["image"].dtype)}
        nudged16.append(run(state, b, plain=True))
    del state
    torch.cuda.synchronize()
    agree = {"model_args": {k: list(v) if isinstance(v, tuple) else v
                            for k, v in margs.items()}, "losses": {}}
    agree["ball_trace"] = dict(
        float32=got32[2], float32_plain=ref32[2],
        float32_plain_nudged=nudged[2], bfloat16=got16[2],
        bfloat16_plain=ref16[2],
        bfloat16_plain_nudged=[n[2] for n in nudged16])
    witness_moved = ref32[2] != nudged[2]
    for k, r in ref32[0].items():
        noise = abs(ref16[0][k] - r)
        d32, d16 = abs(got32[0][k] - r), abs(got16[0][k] - ref16[0][k])
        tol32 = 1e-4 * abs(r)
        if k.startswith("ball_loss"):
            if witness_moved:
                tol32 = BF16_NOISE_FACTOR * abs(nudged[0][k] - r)
            noise = max(noise, *(abs(n[0][k] - ref16[0][k])
                                 for n in nudged16))
        tol16 = max(BF16_NOISE_FACTOR * noise, TOL["bfloat16"] * abs(r))
        ok = (all(math.isfinite(v) for v in (got32[0][k], got16[0][k]))
              and d32 <= tol32 and d16 <= tol16)
        agree["losses"][k] = dict(
            float32=got32[0][k], float32_plain=r, float32_tol=tol32,
            bfloat16=got16[0][k], bfloat16_plain=ref16[0][k],
            bf16_tol=tol16, ok=ok)
        if k.startswith("ball_loss"):
            agree["losses"][k]["float32_witness_moved"] = witness_moved
        if not ok:
            fails.append(f"loss {k}: {agree['losses'][k]}")
    rho = _grad_rel_l2(nudged[1], ref32[1])
    tol32 = max(TRAIN32_TOL, 4.0 * rho)
    top = max(g.norm().item() for g in ref32[1].values())
    worst, bad = 0.0, []
    for k, r in ref32[1].items():
        err = (got32[1][k] - r).norm().item()
        bound = tol32 * (r.norm().item() + TRAIN_FLOOR * top)
        worst = max(worst, err / bound)
        if not (math.isfinite(err) and err <= bound):
            bad.append(k)
    agree["float32"] = dict(parameters=len(ref32[1]), tol=tol32,
                            one_rounding_of_the_input_rel_l2=rho,
                            rho_max=RHO_MAX,
                            floor=TRAIN_FLOOR, worst_err_over_bound=worst,
                            rel_l2_all=_grad_rel_l2(got32[1], ref32[1]),
                            failed=bad[:10])
    if not rho <= RHO_MAX:
        fails.append(f"float32 gradients: one rounding of the input moves "
                     f"them by {rho} > {RHO_MAX}; the bound means nothing")
    if bad:
        fails.append(f"float32 gradients: {len(bad)} parameters over the "
                     f"bound, e.g. {bad[:5]}")
    noise = _grad_rel_l2(ref16[1], ref32[1])
    witness = [_grad_rel_l2(n[1], ref16[1]) for n in nudged16]
    rel16 = _grad_rel_l2(got16[1], ref16[1])
    tol16 = BF16_NOISE_FACTOR * max(noise, *witness)
    finite16 = all(bool(torch.isfinite(g).all()) for g in got16[1].values())
    agree["bfloat16"] = dict(
        rel_l2_all=rel16, bf16_noise_rel_l2=noise,
        plain_one_bf16_rounding_of_the_input_rel_l2=witness,
        kernels_vs_float32_rel_l2=_grad_rel_l2(got16[1], ref32[1]),
        tol=tol16, finite=finite16)
    agree["grad_norms"] = dict(
        float32=_grad_norm(got32[1]), float32_plain=_grad_norm(ref32[1]),
        bfloat16=_grad_norm(got16[1]), bfloat16_plain=_grad_norm(ref16[1]),
        bfloat16_plain_nudged=[_grad_norm(n[1]) for n in nudged16])
    if not (finite16 and rel16 <= tol16):
        fails.append(f"bf16 gradients: {agree['bfloat16']}")
    torch.cuda.empty_cache()
    return agree, fails


def _grad_norm(grads):
    import torch

    return torch.stack([g.float().norm() for g in grads.values()]).norm().item()


def _grad_rel_l2(got, ref):
    import torch

    num = torch.stack([(got[k] - ref[k]).float().norm() for k in ref]).norm()
    den = torch.stack([ref[k].float().norm() for k in ref]).norm()
    return (num / den).item()


def _ball_loss_on_identical_logits(state, batch, lmap, cfg):
    """The Ball Loss of the same logits (the final head's) through the top-N
    kernel and through its plain version: nothing else differs, so ball
    centres, pseudo-masks and loss values must be equal (losses to 1e-6
    relative: the same operations on the same masks)."""
    import torch

    from rsuper_tpu_torch.losses import ball_loss
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    with torch.no_grad():
        seg = state.model(batch["image"])["segmentation"]
        logits = seg[0] if isinstance(seg, (list, tuple)) else seg

    def run():
        with _ball_trace(keep_masks=True) as trace:
            losses = ball_loss(logits, batch["label"], batch["unk"],
                               batch["segment_mask"], batch["volumes"],
                               batch["diameters"], lmap, cfg.ball_config())
        return {k: float(v) for k, v in losses.items()}, trace

    got, trace = run()
    with plain_on_device():
        ref, ref_trace = run()
    mismatches = sum(int((a != b).sum().item())
                     for t, r in zip(trace, ref_trace)
                     for a, b in zip(t.pop("masks"), r.pop("masks")))
    ok = (len(trace) > 0 and trace == ref_trace and mismatches == 0
          and all(math.isfinite(v) and abs(v - ref[k]) <= 1e-6 * abs(ref[k])
                  for k, v in got.items()))
    return dict(losses=got, losses_plain=ref, slots=trace,
                slots_plain=ref_trace, mask_voxels_that_differ=mismatches,
                ok=ok)


def _single_volume_path(state, batch, lmap, cfg, counted):
    """The path of the single-volume kernel: on the masked volume of slot 0
    that the Ball Loss of the final logits hands its batched selection, the
    public ``topn_masks_multi`` of item 0 must give the batched kernel's
    three masks. Returns (result, launches of topn_threshold_multi)."""
    import torch

    from rsuper_tpu_torch.losses import ball, ball_loss
    from rsuper_tpu_torch.ops import selection

    calls = []
    batched = ball.topn_masks_multi_batched

    def recording(x, ns, *, iters):
        masks = batched(x, ns, iters=iters)
        calls.append((x, ns, iters, masks))
        return masks

    ball.topn_masks_multi_batched = recording
    try:
        with torch.no_grad():
            logits = state.model(batch["image"])["segmentation"][0]
            ball_loss(logits, batch["label"], batch["unk"],
                      batch["segment_mask"], batch["volumes"],
                      batch["diameters"], lmap, cfg.ball_config())
    finally:
        ball.topn_masks_multi_batched = batched
    x, ns, iters, masks = calls[0]
    counted["topn_threshold_multi"].launches = 0
    got = selection.topn_masks_multi(x[0], ns[0], iters=iters)
    launches = counted["topn_threshold_multi"].launches
    differ = int((got != masks[0]).sum().item())
    res = dict(targets=ns[0].tolist(), voxels=got.sum(dim=(1, 2, 3)).tolist(),
               positive_voxels=int((x[0] > 0).sum().item()),
               mask_voxels_that_differ=differ, launches=launches,
               ok=differ == 0 and launches == 1)
    return res, launches


def phase_train(dev, steps: int):
    """The training step on bench.py's synthetic 96³ batch with the full
    R-Super losses: (a) the Ball Loss on identical logits, kernel against
    plain, and the whole step's kernels against the plain versions from the
    same state, float32 and bf16; (b) 1 warm-up and `steps` timed steps with
    launch counts, peak memory, host reads, a split of one step and a
    profile; (c) finite, falling loss; (d) remat; (e) the single-volume
    top-N kernel on the path's own volume; (f) the loss="dice" step."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import (LesionChannelMap, LossConfig,
                                         calculate_loss, dispatcher)
    from rsuper_tpu_torch.losses.ball import host_reads
    from rsuper_tpu_torch.train import build_train_step

    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    cfg = LossConfig()  # loss="ball_dice_last"
    batch = bench_train.synthetic_batch(WINDOW, 1, device=dev)
    live_slots = int((batch["volumes"] > 0).sum(dim=1).max())
    failures, res = [], {"size": WINDOW, "batch": 1, "loss": cfg.loss,
                         "classes": len(bench_train.CLASSES),
                         "live_slots": live_slots}
    counted = wrappers()

    # (a) kernels against the plain versions, no update in between: at full
    # depth, and at a cut depth where bf16 is not yet chaotic
    for key, margs in (("full_depth", MODEL_ARGS),
                       ("deep_depth", {**MODEL_ARGS, **DEEP_DEPTH}),
                       ("mid_depth", {**MODEL_ARGS, **MID_DEPTH}),
                       ("cut_depth", {**MODEL_ARGS, **CUT_DEPTH})):
        agree, fails = _kernels_vs_plain(dev, margs, batch, lmap, cfg)
        res[f"kernels_vs_plain_{key}"] = agree
        failures += [f"train {key}: {f}" for f in fails]
    state = bench_train.build_state(dev, False, MODEL_ARGS)
    res["ball_loss_on_identical_logits"] = _ball_loss_on_identical_logits(
        state, batch, lmap, cfg)
    if not res["ball_loss_on_identical_logits"]["ok"]:
        failures.append("train: the Ball Loss through the top-N kernel "
                        "differs from its plain version on identical "
                        f"logits: {res['ball_loss_on_identical_logits']}")

    # (b) warm-up, then the timed steps: the training path
    step = build_train_step(lmap, cfg)
    state, losses = step(state, batch)
    history = [float(losses["overall"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in counted.values():
        w.launches = 0
    reads = host_reads()
    t0 = time.time()
    for _ in range(steps):
        state, losses = step(state, batch)
        history.append(losses["overall"])
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = {k: w.launches for k, w in counted.items()}
    history = [float(v) for v in history]
    res.update(steps=steps, ms_per_step=elapsed / steps * 1e3,
               patches_per_s=steps / elapsed,
               host_reads_per_step=(host_reads() - reads) / steps,
               launches=launches,
               launches_per_step={k: n / steps for k, n in launches.items()},
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               loss_history=history,
               last_losses={k: float(v) for k, v in losses.items()})
    expect = {"conv3x3x3_cf": 1, "in_relu_conv3x3x3_cf": 14,
              "depthwise_conv3x3x3": 58, "conv3x3x3_cf_dgrad": 14,
              "conv3x3x3_cf_wgrad": 1, "in_relu_conv3x3x3_cf_wgrad": 14,
              "depthwise_conv3x3x3_bwd": 58,
              "topn_threshold_multi_batched": live_slots}
    for k, n in expect.items():
        if launches[k] != n * steps:
            failures.append(f"train: {k} launched {launches[k]} times in "
                            f"{steps} steps, expected {n} a step")
    # (c) finite at every step, lower after the steps than at the first
    if not all(math.isfinite(v) for v in history):
        failures.append(f"train: non-finite loss {history}")
    elif not history[-1] < history[0]:
        failures.append(f"train: loss did not fall: {history}")
    for k in ("ball_loss_bce", "ball_loss_dice"):
        if not math.isfinite(res["last_losses"].get(k, math.nan)):
            failures.append(f"train: {k} missing or not finite: "
                            f"{res['last_losses']}")

    # one step split into its parts: by CUDA events (which read the host's
    # launch time where the device waits for the host), and by the profiler
    # (the device's own timeline: the stretch of each part and the kernel
    # time inside it)
    model = state.model
    parts = ("forward", "loss", "backward", "optimizer")
    inner = ("ball_loss",)  # inside "loss": the Ball Loss's own forward

    def split_step(span):
        ball_loss = dispatcher.ball_loss

        def spanned(*args, **kwargs):
            with span("ball_loss"):
                return ball_loss(*args, **kwargs)

        model.zero_grad(set_to_none=True)
        with span("forward"):
            out = model(batch["image"])
        dispatcher.ball_loss = spanned
        try:
            with span("loss"):
                ls = calculate_loss(out, batch["label"], batch["unk"],
                                    batch["segment_mask"], batch["volumes"],
                                    batch["diameters"], lmap, cfg)
        finally:
            dispatcher.ball_loss = ball_loss
        with span("backward"):
            ls["overall"].backward()
        with span("optimizer"):
            state.apply_gradients()

    @contextmanager
    def timed(name):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        yield
        ev[1].record()
        events.setdefault(name, []).append(ev)

    events: dict = {}
    split_step(timed)
    events.clear()
    for _ in range(3):  # per part, the median of 3
        split_step(timed)
    torch.cuda.synchronize()
    res["split_ms"] = {k: sorted(a.elapsed_time(b) for a, b in events[k])[1]
                       for k in parts + inner}
    res["profile_step"] = _profile(
        lambda: split_step(torch.profiler.record_function),
        spans=parts + inner, between="backward")
    # the profiler slows the host down; the device's kernels take the same
    # time with it, so their sum is also held against the timed steps
    res["device_busy_share_of_timed_step"] = (
        res["profile_step"]["device_busy_ms"] / res["ms_per_step"])

    # (e) the single-volume kernel on the path's own masked volume
    res["single_volume_path"], launches["topn_threshold_multi"] = \
        _single_volume_path(state, batch, lmap, cfg, counted)
    if not res["single_volume_path"]["ok"]:
        failures.append("train: topn_masks_multi on the path's volume: "
                        f"{res['single_volume_path']}")

    # (d) remat on: same first loss as remat off, and a whole step runs
    del state, model
    torch.cuda.empty_cache()
    state_r = bench_train.build_state(dev, True, MODEL_ARGS)
    torch.cuda.reset_peak_memory_stats()
    _, losses_r = step(state_r, batch)
    first_r = float(losses_r["overall"])
    res["remat"] = dict(first_loss=first_r, first_loss_off=history[0],
                        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not abs(first_r - history[0]) <= 1e-6 * abs(history[0]):
        failures.append(f"train: remat changes the loss: {res['remat']}")

    # (f) the step without the Ball Loss, timed in the same call: what the
    # Ball Loss costs is the difference
    del state_r
    torch.cuda.empty_cache()
    state_d = bench_train.build_state(dev, False, MODEL_ARGS)
    step_d = build_train_step(lmap, LossConfig(loss="dice"))
    state_d, losses_d = step_d(state_d, batch)
    history_d = [float(losses_d["overall"])]
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(DICE_STEPS):
        state_d, losses_d = step_d(state_d, batch)
        history_d.append(losses_d["overall"])
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    history_d = [float(v) for v in history_d]
    busy_d = _profile(lambda: step_d(state_d, batch), top=0)["device_busy_ms"]
    res["dice_step"] = dict(loss="dice", steps=DICE_STEPS,
                            ms_per_step=elapsed / DICE_STEPS * 1e3,
                            patches_per_s=DICE_STEPS / elapsed,
                            device_busy_ms=busy_d, loss_history=history_d)
    if not (all(math.isfinite(v) for v in history_d)
            and history_d[-1] < history_d[0]):
        failures.append(f"train: the dice step's loss: {history_d}")
    log(json.dumps({"train": res}))
    return failures, launches


# ------------------------------------------------------ the training CLI
AUG_CROP = (128, 128, 128)  # the preset's crop
AUG_LOAD = (148, 168, 168)  # the crop plus the affine's margin
AUG_TOL = 1e-5  # image, card vs CPU: max|Δ| ≤ AUG_TOL·(1+max|ref|)
HALF_EPS = 1e-4  # a label voxel whose source coordinate lies this near a half
REPORT_CLASSES = ["aorta", "kidney_left", "kidney_right", "liver",
                  "pancreas_body", "pancreas_head", "pancreas_tail",
                  "spleen", "stomach"]
CLI_STEPS, CLI_RESUME_STEPS = 6, 2
# the kernels the profiled step must show, by a part of their names in the
# trace: each conv route forward and weight gradient, the depthwise forward
# and backward, and top-N
CLI_KERNELS = {
    "conv_tensor_core": "conv3_tc_kernel", "conv_stem": "stem_fwd_kernel",
    "wgrad_tensor_core": "wgrad_tc_kernel", "wgrad_stem": "stem_wgrad_kernel",
    "depthwise_fwd": "dw3_fwd_kernel", "depthwise_bwd": "dw3_bwd_kernel",
    "topn": "multisect_kernel",
}


def _organs(shape, rng, report: bool):
    """Boolean organ masks of a synthetic abdomen on a voxel grid of
    `shape` (ellipsoids in normalised coordinates, jittered by `rng`): the
    CT-Mask classes with a pancreatic lesion, or the CT-Report classes with
    the pancreas as head, body and tail."""
    import numpy as np

    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in shape]
    x, y, z = axes[0][:, None, None], axes[1][None, :, None], axes[2][None, None, :]
    j = rng.uniform(-0.04, 0.04, 3)
    body = (x / 0.95) ** 2 + (y / 0.8) ** 2 <= 1.0

    def ell(c, r):
        return (((x - c[0] - j[0]) / r[0]) ** 2 + ((y - c[1] - j[1]) / r[1]) ** 2
                + ((z - c[2] - j[2]) / r[2]) ** 2) <= 1.0

    out = {"body": np.broadcast_to(body, shape), "liver": ell((-0.35, -0.1, 0.2), (0.35, 0.4, 0.35)),
           "spleen": ell((0.45, 0.2, 0.2), (0.15, 0.2, 0.2)),
           "kidney_left": ell((0.35, 0.45, -0.2), (0.12, 0.12, 0.22)),
           "kidney_right": ell((-0.35, 0.45, -0.2), (0.12, 0.12, 0.22)),
           "stomach": ell((0.25, -0.25, 0.35), (0.2, 0.2, 0.2)),
           "aorta": ell((0.0, 0.3, 0.0), (0.05, 0.05, 0.9))}
    pancreas = ell((0.05, 0.1, 0.0), (0.35, 0.08, 0.1))
    if report:
        out["pancreas_head"] = pancreas & (x < -0.12)
        out["pancreas_body"] = pancreas & (x >= -0.12) & (x < 0.15)
        out["pancreas_tail"] = pancreas & (x >= 0.15)
    else:
        out["pancreas"] = pancreas
        out["pancreatic_lesion"] = ell((0.1, 0.1, 0.0), (0.06, 0.05, 0.06))
    return out


def write_cli_cases(root: Path, seed: int = 0):
    """Two CT-Mask and two CT-Report cases through the port's own
    ``preprocess_case``: CT phantoms in HU of 152 × 172 × 136 voxels of
    1 × 1 × 1.25 mm (resampled to 1 mm³: 152 × 172 × 170, no smaller than
    the 148 × 168 × 168 load size), a NIfTI a labelled organ, the sorted
    class lists, and the per-tumour report CSV (the columns of
    ``tests/test_data.py:_report_rows``): a head tumour, a body/tail one and
    a left-kidney one."""
    import numpy as np

    from rsuper_tpu_torch.data.nifti import write_nifti
    from rsuper_tpu_torch.data.preprocess import preprocess_case

    shape, affine = (152, 172, 136), np.diag([1.0, 1.0, 1.25, 1.0])
    rng = np.random.default_rng(seed)
    roots = {False: root / "masks", True: root / "reports"}
    for report, classes in ((False, sorted(CLASSES)),
                            (True, sorted(REPORT_CLASSES))):
        roots[report].mkdir(parents=True)
        (roots[report] / "classes.json").write_text(json.dumps(classes))
        for k in range(2):
            cid = f"BDMAP_{'R' if report else 'M'}{k}"
            organs = _organs(shape, rng, report)
            ct = np.full(shape, -1000.0, np.float32)
            ct[organs.pop("body")] = 40.0
            for hu, name in ((60, "liver"), (45, "spleen"), (30, "stomach"),
                             (35, "kidney_left"), (35, "kidney_right"),
                             (200, "aorta")):
                ct[organs[name]] = hu
            ct += rng.normal(0.0, 15.0, shape).astype(np.float32)
            tmp = root / "nii" / cid
            tmp.mkdir(parents=True)
            write_nifti(str(tmp / "ct.nii.gz"), ct, affine)
            paths = {}
            for name, m in organs.items():
                paths[name] = str(tmp / f"{name}.nii.gz")
                write_nifti(paths[name], m.astype(np.uint8), affine)
            preprocess_case(str(tmp / "ct.nii.gz"), paths,
                            str(roots[report] / f"{cid}.npz"),
                            classes=classes, min_size=AUG_LOAD)
    (root / "reports.csv").write_text(
        "BDMAP_ID,Standardized Organ,Standardized Location,Tumor Size (mm),"
        "Unknow Tumor Size,no lesion\n"
        "BDMAP_R0,pancreas,head,22.0,no,0\n"
        "BDMAP_R1,pancreas,body / tail,30 x 18,no,0\n"
        "BDMAP_R1,kidney,left,15,no,0\n")
    return roots[False], roots[True], root / "reports.csv"


def _augment_records(seed: int = 0):
    """A batch of 2 loader records at the load size with the 16 classes,
    packed as the loader packs them (``pack_record_cf``)."""
    import numpy as np

    from rsuper_tpu_torch.data.pipeline import pack_record_cf

    rng = np.random.default_rng(seed)
    C = len(CLASSES)
    recs = []
    for i in range(2):
        organs = _organs(AUG_LOAD, rng, report=False)
        organs.pop("body")
        label = np.zeros((C,) + AUG_LOAD, np.uint8)
        for name, m in organs.items():
            if name in CLASSES:
                label[CLASSES.index(name)] = m
        unk = np.zeros_like(label)
        seg = np.zeros_like(label)
        if i == 1:  # a report record: unknown lesion voxels, a segment
            les = CLASSES.index("pancreatic_lesion")
            unk[les] = organs["pancreas"]
            seg[les] = organs["pancreas"]
        recs.append(pack_record_cf({
            "image": rng.normal(size=AUG_LOAD).astype(np.float32),
            "label": label, "unk": unk, "segment_mask": seg,
            "volumes": np.zeros(10, np.float32),
            "diameters": np.zeros((10, 3), np.float32),
            "apply_affine": np.ones((), np.float32)}))
    return {k: np.stack([r[k] for r in recs]) for k in recs[0]}


def phase_augment(dev):
    """The device augmentation at the preset's sizes: one batch of 2 records
    at the 148 × 168 × 168 load size (16 classes) through the port's
    ``device_augment`` on the card and on the CPU with the same draws (item 0
    warped with every intensity op on, item 1 centre-cropped with none); the
    image within AUG_TOL, the masks equal but for voxels whose source
    coordinate lies within HALF_EPS of a half (counted); TF32 off for the
    matmuls and cuDNN on this path, and no TF32 kernel in its profile; the
    augment's device ms a batch (CUDA events), the transfer's, the draws'."""
    import dataclasses

    import numpy as np
    import torch

    from rsuper_tpu_torch.data import augment as aug
    from rsuper_tpu_torch.data.pipeline import (device_augment, draw_augment,
                                                to_device)
    from rsuper_tpu_torch.utils.device import card_line

    failures = []
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        failures.append("augment: TF32 is on for the float32 matmuls or cuDNN")
    host = _augment_records()
    C = len(CLASSES)

    def draw():
        return draw_augment(torch.Generator().manual_seed(0),
                            torch.Generator(device=dev).manual_seed(0), 2,
                            AUG_CROP, (0.0,) * 3, (30.0,) * 3, (0.0,) * 3)

    draw()  # the first draw on the device initialises its generator
    torch.cuda.synchronize()
    t0 = time.time()
    draws = draw()
    draw_ms = (time.time() - t0) * 1e3
    draws.affine_coin[:] = [0.0, 1.0]  # item 0 warps, item 1 does not
    draws.coins[0], draws.coins[1] = 0.0, 1.0  # every op on item 0, none on 1
    cpu_draws = dataclasses.replace(draws, noise=draws.noise.cpu())

    def run(batch, d):
        return device_augment(batch, d, crop_size=AUG_CROP,
                              out_dtype=torch.float32, num_classes=C)

    got = run(to_device(host, dev), draws)
    torch.cuda.synchronize()
    ref = run(to_device(host, "cpu"), cpu_draws)
    err = (got["image"].cpu() - ref["image"]).abs().max().item()
    bound = AUG_TOL * (1 + ref["image"].abs().max().item())
    if not (torch.isfinite(got["image"]).all() and err <= bound):
        failures.append(f"augment: image differs from the CPU run by {err} "
                        f"(bound {bound})")
    masks = torch.cat([got[k].cpu() for k in ("label", "unk",
                                              "segment_mask")], -1)
    rmasks = torch.cat([ref[k] for k in ("label", "unk", "segment_mask")], -1)
    starts = [(s - c) // 2 for s, c in zip(AUG_LOAD, AUG_CROP)]
    vox = aug._window_vox(AUG_LOAD, draws.theta[0], AUG_CROP, starts)
    half = torch.zeros(AUG_CROP, dtype=torch.bool)
    for v in vox:
        half |= (v - torch.floor(v) - 0.5).abs() < HALF_EPS
    diff = (masks != rmasks).any(dim=-1)
    mism = int(diff.sum())
    if bool((diff[1]).any()) or bool((diff[0] & ~half).any()):
        failures.append(f"augment: {mism} mask voxels differ, not all on a "
                        "half")

    xfer = lambda: to_device(host, dev)  # noqa: E731
    batch = xfer()
    prof = _profile(lambda: run(batch, draws), top=1000)
    names = [r["name"] for r in prof["top"]]
    tf32 = [n for n in names if "tf32" in n.lower() or "cudnn" in n.lower()]
    if tf32:
        failures.append(f"augment: TF32 or cuDNN kernels on the path: {tf32}")
    res = dict(card=card_line(), load=list(AUG_LOAD), crop=list(AUG_CROP),
               classes=C, max_abs_err=err, bound=bound,
               half_boundary_voxels=int(half.sum()), mask_mismatches=mism,
               device_ms=time_ms(lambda: run(batch, draws), 3),
               h2d_ms=time_ms(xfer, 3), draw_host_ms=draw_ms,
               device_busy_ms=prof["device_busy_ms"],
               device_ops=prof["device_ops"], warped=[True, False])
    log(json.dumps({"augment": res}))
    return failures


def _trace_kernels(path: Path):
    """Kernel names, launches and merged busy ms of a Chrome trace."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return [e["name"] for e in events], busy / 1e3


def _trace_top(path: Path, top: int = 8):
    """The `top` kernel names of a Chrome trace by summed device ms, with
    their launches."""
    sums = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            ms, n = sums.get(e["name"], (0.0, 0))
            sums[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    rows = sorted(sums.items(), key=lambda kv: -kv[1][0])[:top]
    return [dict(ms=ms, calls=n, name=k[:90]) for k, (ms, n) in rows]


def phase_train_cli(dev):
    """``python -m rsuper_tpu_torch.train``'s ``main`` at the preset's own
    sizes (default MedFormer, 128³ crops, batch 2, bf16, ball_dice_last) on
    synthetic cases written through ``preprocess_case``: CLI_STEPS steps
    with a torch.profiler window over the last, the launch counts set to 0
    just before and read just after, then ``--resume`` for CLI_RESUME_STEPS
    more. Fails unless the step counts, finite losses, the checkpoint and
    metrics files, the restored optimizer state and the kernels in the
    window are as they must be. Returns the failures and the device
    operations of the profiled step."""
    import torch

    from rsuper_tpu_torch.data import native_io
    from rsuper_tpu_torch.losses.ball import host_reads
    from rsuper_tpu_torch.train.__main__ import main as train_main
    from rsuper_tpu_torch.utils.device import card_line

    failures, res = [], {"card": card_line(), "crop": list(AUG_CROP),
                         "batch": 2, "loss": "ball_dice_last"}
    counted = wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.time()
        masks, reports, csv = write_cli_cases(root)
        res["write_cases_s"] = time.time() - t0
        args = ["--preset", "abdomenatlas_ufo/medformer_3d",
                "--data_root", str(masks), "--report_root", str(reports),
                "--reports", str(csv), "--cp_path", str(root / "exp"),
                "--unique_name", "cli", "--iter_per_epoch", "3",
                "--epochs", "4"]
        exp = root / "exp" / "cli"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for w in counted.values():
            w.launches = 0
        reads = host_reads()
        t0 = time.time()
        state = train_main(args + ["--max_steps", str(CLI_STEPS),
                                   "--profile_steps", "1"])
        torch.cuda.synchronize()
        res["run_s"] = time.time() - t0
        launches = {k: w.launches for k, w in counted.items()}
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["loader_path"] = native_io.path()
        if state.step != CLI_STEPS:
            failures.append(f"train_cli: step {state.step} after the run, "
                            f"expected {CLI_STEPS}")
        recs = [json.loads(line) for line in
                (exp / "metrics.jsonl").read_text().splitlines()]
        phases = [r for r in recs if "phase/step_ms" in r][-1]
        losses = {r["step"]: r["train/overall"] for r in recs
                  if "train/overall" in r}
        res.update(
            steps=CLI_STEPS, logged_losses=losses,
            ms_per_step=phases["phase/iteration_median_ms"],
            step_call_ms=phases["phase/step_median_ms"],
            loader_item_ms=phases["phase/loader_item_ms"],
            loader_worker_ms_per_batch=2 * phases["phase/loader_item_ms"],
            loader_wait_ms=phases["phase/load_median_ms"],
            h2d_host_ms=phases["phase/h2d_median_ms"],
            augment_host_ms=phases["phase/augment_median_ms"],
            host_reads_per_step=(host_reads() - reads
                                 + phases["phase/host_read_count"])
            / CLI_STEPS,
            launches_per_step={k: n / CLI_STEPS for k, n in launches.items()})
        if not (exp / "latest").exists():
            failures.append("train_cli: no latest checkpoint")
        if not losses or not all(math.isfinite(v) for v in losses.values()):
            failures.append(f"train_cli: logged losses {losses}")
        for k in KERNELS:
            if k != "topn_threshold_multi" and launches[k] <= 0:
                failures.append(f"train_cli: {k} was not launched")
        names, busy_ms = _trace_kernels(exp / "trace" / "trace.json")
        found = {k: sum(part in n for n in names)
                 for k, part in CLI_KERNELS.items()}
        res.update(profiled_step_kernels=found,
                   profiled_step_kernel_records=len(names),
                   device_busy_ms=busy_ms,
                   device_busy_share_of_step=busy_ms / res["ms_per_step"])
        for k, n in found.items():
            if n <= 0:
                failures.append(f"train_cli: no {k} kernel in the profiled "
                                "step")

        state = train_main(args + ["--max_steps", str(CLI_RESUME_STEPS),
                                   "--resume"])
        saved = torch.load(exp / "latest", weights_only=True)
        counts = {float(s["step"]) for s in saved["opt_state"]["state"].values()}
        total = CLI_STEPS + CLI_RESUME_STEPS
        res["resumed"] = dict(step=state.step, saved_step=saved["step"],
                              adam_counts=sorted(counts))
        if not (state.step == saved["step"] == total
                and counts == {float(total)}):
            failures.append(f"train_cli: the resumed run: {res['resumed']}")
        if "resumed from step 6" not in (exp / "train.log").read_text():
            failures.append("train_cli: the resumed run did not start from "
                            "the saved step")
        recs = [json.loads(line) for line in
                (exp / "metrics.jsonl").read_text().splitlines()]
        first = [r for r in recs if "train/overall" in r][-1]
        if first["step"] != CLI_STEPS + 1 or not math.isfinite(
                first["train/overall"]):
            failures.append(f"train_cli: first resumed step {first}")
    del state
    torch.cuda.empty_cache()
    log(json.dumps({"train_cli": res}))
    return failures, res["profiled_step_kernel_records"]


# ------------------------------------------------- CLIP and classification
CLIP_STEPS, CLIP_RESUME_STEPS = 4, 2
CLIP_FEATS = 768  # the reference's report encoder (Clinical-Longformer) width
# the kernels a CLIP step must show in its profile: the CLI step's, but
# top-N (the CLIP step has no Ball Loss)
CLIP_KERNELS = {k: v for k, v in CLI_KERNELS.items() if k != "topn"}
TOPN_KERNELS = ("topn_threshold_multi", "topn_threshold_multi_batched")
CLS_STEPS = 2  # steps of the preset with the classification branch


@contextmanager
def _loader_spy():
    """Inside the block, keep the dataset, the batch size and the indices
    of every loader the training loop builds (one an epoch)."""
    from rsuper_tpu_torch.train import loop

    seen, inner = [], loop.PrefetchLoader

    class Recording(inner):
        def __init__(self, dataset, batch_size, indices, **kwargs):
            super().__init__(dataset, batch_size, indices, **kwargs)
            seen.append((dataset, batch_size, [int(i) for i in self.indices]))

    loop.PrefetchLoader = Recording
    try:
        yield seen
    finally:
        loop.PrefetchLoader = inner


def _loader_batches(loaders):
    """The index batches of the recorded loaders, in the order the loop
    meets them."""
    return [idx[i:i + bs] for _, bs, idx in loaders
            for i in range(0, len(idx) - bs + 1, bs)]


@contextmanager
def _preset(**fields):
    """Inside the block, the preset with `fields` replaced."""
    from rsuper_tpu_torch.config import config

    saved = config.DEFAULT_CONFIGS[PRESET]
    config.DEFAULT_CONFIGS[PRESET] = {**saved, **fields}
    try:
        yield
    finally:
        config.DEFAULT_CONFIGS[PRESET] = saved


def phase_clip(dev, full_step_ops: int):
    """CLIP pretraining and the classification branch at the preset's sizes
    (default MedFormer, 128³ crops, batch 2, bf16, ``remat`` on) on the
    ``train_cli`` phase's synthetic cases (BDMAP_R1 with one more pancreas
    tumour), with seeded CLIP_FEATS-wide report embeddings for the two
    CT-Report cases (the CT-Mask cases take the zero embedding):

    * ``main`` with ``--clip_pretrain --clip_source DIR`` for CLIP_STEPS
      steps, the last profiled, the launch counts set to 0 just before and
      read just after, then ``--resume`` for CLIP_RESUME_STEPS more: finite
      contrastive losses, every batch of one crop organ, the resumed run's
      batches those of the uninterrupted run's epoch (and of the organ
      sampler), no top-N launch (no Ball Loss, no decoder); ms an
      iteration, the profiled step's busy share and device operations
      against the full ``ball_dice_last`` step's (`full_step_ops`), peak
      memory;
    * one CLIP step's losses and gradients through the kernels against the
      plain versions, float32 and bf16, at full and cut depth
      (``_kernels_vs_plain``: the train phase's rules) on a seeded 128³ × 2
      batch;
    * the classification branch: CLS_STEPS steps of the preset with
      ``classification_branch`` and one output a lesion class, on the
      kernels (finite terms every step), and one step of the train phase's
      batch with the head through the kernels against the plain versions
      (``_kernels_vs_plain``)."""
    import numpy as np
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.data.sampler import OrganBatchSampler
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.train.__main__ import main as train_main
    from rsuper_tpu_torch.utils.device import card_line

    failures, res = [], {"card": card_line(), "crop": list(AUG_CROP),
                         "batch": 2, "clip_feats": CLIP_FEATS}
    counted = wrappers()
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        masks, reports, csv = write_cli_cases(root)
        # a second pancreas tumour for BDMAP_R1 (its kidney one ties it
        # otherwise): both report cases tag "pancreas", so a pancreas batch
        # holds two cases and two embeddings
        with open(csv, "a") as f:
            f.write("BDMAP_R1,pancreas,tail,25,no,0\n")
        emb_dir = root / "embeddings"
        emb_dir.mkdir()
        rng = np.random.default_rng(7)
        for k in range(2):  # unit-norm, as the reference's encoder writes
            v = rng.normal(size=CLIP_FEATS).astype(np.float32)
            np.save(emb_dir / f"BDMAP_R{k}.npy", v / np.linalg.norm(v))
        args = ["--preset", PRESET, "--data_root", str(masks),
                "--report_root", str(reports), "--reports", str(csv),
                "--cp_path", str(root / "exp"), "--unique_name", "clip",
                "--iter_per_epoch", "3", "--epochs", "4",
                "--clip_pretrain", "--clip_source", str(emb_dir)]
        exp = root / "exp" / "clip"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for w in counted.values():
            w.launches = 0
        with _loop_spy() as spy, _loader_spy() as loaders:
            t0 = time.time()
            state = train_main(args + ["--max_steps", str(CLIP_STEPS),
                                       "--profile_steps", "1"])
            torch.cuda.synchronize()
            res["run_s"] = time.time() - t0
        launches = {k: w.launches for k, w in counted.items()}
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(v) for v in spy["losses"]]
        phases = [r for r in _metrics_log(exp) if "phase/step_ms" in r][-1]
        names, busy_ms = _trace_kernels(exp / "trace" / "trace.json")
        found = {k: sum(part in n for n in names)
                 for k, part in CLIP_KERNELS.items()}
        res.update(
            steps=CLIP_STEPS, contrastive_losses=losses,
            heads=list(state.model.heads), batch_layout=spy["batch_layout"],
            ms_per_step=phases["phase/iteration_median_ms"],
            step_call_ms=phases["phase/step_median_ms"],
            loader_item_ms=phases["phase/loader_item_ms"],
            loader_wait_ms=phases["phase/load_median_ms"],
            launches_per_step={k: n / CLIP_STEPS
                               for k, n in launches.items()},
            profiled_step_kernels=found, device_busy_ms=busy_ms,
            device_busy_share_of_step=busy_ms / phases[
                "phase/iteration_median_ms"],
            device_ops=len(names), full_step_device_ops=full_step_ops,
            device_ops_share_of_full_step=len(names) / full_step_ops)
        if state.step != CLIP_STEPS or state.model.heads != ("clip",):
            failures.append(f"clip: step {state.step}, heads "
                            f"{state.model.heads} after the run")
        if len(losses) != CLIP_STEPS or not all(map(math.isfinite, losses)):
            failures.append(f"clip: contrastive losses {losses}")
        if spy["batch_layout"].get("report_embedding") != [
                "torch.float32", [2, CLIP_FEATS], dev.type]:
            failures.append("clip: the step's report embeddings are not "
                            f"float32 (2, {CLIP_FEATS}) on the device: "
                            f"{spy['batch_layout']}")
        for k in KERNELS:
            if k in TOPN_KERNELS:
                if launches[k]:
                    failures.append(f"clip: {k} launched {launches[k]} "
                                    "times: the CLIP step has no Ball Loss")
            elif launches[k] <= 0:
                failures.append(f"clip: {k} was not launched")
        for k, n in found.items():
            if n <= 0:
                failures.append(f"clip: no {k} kernel in the profiled step")

        # organ-homogeneous batches; the resumed run draws the batches of
        # the uninterrupted run's epoch
        dataset = loaders[0][0]
        organs = dataset.crop_organs()
        batches = _loader_batches(loaders)
        res["crop_organs"] = organs
        res["batch_organs"] = [[organs[i] for i in b]
                               for b in batches[:CLIP_STEPS]]
        with _loop_spy() as spy2, _loader_spy() as loaders2:
            state = train_main(args + ["--max_steps", str(CLIP_RESUME_STEPS),
                                       "--resume"])
        losses2 = [float(v) for v in spy2["losses"]]
        # the resumed run starts in epoch 1 after its first batch
        first, skip = divmod(CLIP_STEPS, 3)
        resumed = _loader_batches(loaders2)[skip:skip + CLIP_RESUME_STEPS]
        uninterrupted = batches[CLIP_STEPS:CLIP_STEPS + CLIP_RESUME_STEPS]
        sampler = OrganBatchSampler(organs, 2, seed=load_config(PRESET).seed)
        drawn = [sampler.batch(s).tolist() for s in
                 range(CLIP_STEPS, CLIP_STEPS + CLIP_RESUME_STEPS)]
        res["resumed"] = dict(step=state.step, contrastive_losses=losses2,
                              batches=resumed, uninterrupted=uninterrupted,
                              sampler=drawn,
                              batch_organs=[[organs[i] for i in b]
                                            for b in resumed])
        if not (loaders2[0][2] == loaders[first][2]
                and resumed == uninterrupted == drawn):
            failures.append(f"clip: the resumed batches {resumed} differ "
                            f"from the uninterrupted run's {uninterrupted} "
                            f"or the sampler's {drawn}")
        if any(len({organs[i] for i in b}) != 1
               for b in batches + _loader_batches(loaders2)):
            failures.append(f"clip: a batch mixes organs: {batches}")
        if (state.step != CLIP_STEPS + CLIP_RESUME_STEPS
                or len(losses2) != CLIP_RESUME_STEPS
                or not all(map(math.isfinite, losses2))):
            failures.append(f"clip: the resumed run: {res['resumed']}")

        # the classification branch at the preset's sizes, on the kernels
        classes = sorted(CLASSES)
        n_cls = len(LesionChannelMap.from_classes(classes)
                    .lesion_class_indices())
        margs = {**load_config(PRESET).model_args,
                 "classification_classes": n_cls}
        with _preset(classification_branch=True, model_args=margs), \
                _loop_spy() as spy3:
            state = train_main(args[:args.index("--clip_pretrain")]
                               + ["--unique_name", "cls", "--max_steps",
                                  str(CLS_STEPS)])
        terms = [{k: float(v) for k, v in t.items()} for t in spy3["terms"]]
        res["classification"] = dict(classes=n_cls, steps=terms,
                                     heads=list(state.model.heads))
        if (len(terms) != CLS_STEPS or state.model.heads != ("cls",)
                or not all("classification" in t
                           and all(map(math.isfinite, t.values()))
                           for t in terms)):
            failures.append(f"clip: the classification steps: "
                            f"{res['classification']}")
    del state
    torch.cuda.empty_cache()

    # kernels against the plain versions: the CLIP step on a seeded batch
    # at the preset's sizes, the classification step on the train phase's
    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    batch = bench_train.synthetic_batch(AUG_CROP[0], 2, device=dev)
    batch["report_embedding"] = torch.randn(
        (2, CLIP_FEATS), generator=torch.Generator().manual_seed(8)).to(dev)
    for key, margs in (("full_depth", MODEL_ARGS),
                       ("cut_depth", {**MODEL_ARGS, **CUT_DEPTH})):
        agree, fails = _kernels_vs_plain(dev, {**margs, "clip_branch": True},
                                         batch, lmap, LossConfig(),
                                         clip_only=True)
        res[f"kernels_vs_plain_{key}"] = agree
        failures += [f"clip {key}: {f}" for f in fails]
    del batch
    n_cls = len(lmap.lesion_class_indices())
    agree, fails = _kernels_vs_plain(
        dev, {**MODEL_ARGS, "classification_classes": n_cls},
        bench_train.synthetic_batch(WINDOW, 1, device=dev), lmap,
        LossConfig(classification_branch=True))
    res["classification"]["kernels_vs_plain"] = agree
    failures += [f"classification: {f}" for f in fails]
    if "classification" not in agree["losses"]:
        failures.append("classification: no classification term")
    res["phase_s"] = time.time() - t_phase
    torch.cuda.empty_cache()
    log(json.dumps({"clip": res}))
    return failures


VAL_WINDOW = (128, 128, 128)  # cfg.training_size of the preset
VAL_BATCH = 4  # validate_cases' window batch
PRESET = "abdomenatlas_ufo/medformer_3d"
# the seeded model's final head made confident: the bias of each class the
# cases hold moves its logits, over one window of the first case, to these
# many standard deviations from 0 in turn (mostly on, mostly off, all on,
# all off), so the thresholded masks of the kernels and the plain versions
# differ at few voxels or none
HEAD_SIGMAS = (3.0, -3.0, 8.0, -8.0)
LOOP_STEPS = 3  # steps of the host-augment and prefetch runs
# the same batches give the same first loss bit for bit; after the first
# update two runs of the step differ (PyTorch's backward of the trilinear
# upsampling adds with atomics on the card, and the random bf16 model
# amplifies it): later losses within 3x the largest relative spread of two
# inline runs measured on the H100 (1.5e-3)
LOSS_SPREAD_TOL = 4.5e-3


@contextmanager
def _recorded_probs():
    """Inside the block, keep each float16 probability volume that
    ``validate_cases`` thresholds."""
    from rsuper_tpu_torch.train import validation

    seen, inner = [], validation.sliding_window_inference

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out)
        return out

    validation.sliding_window_inference = recording
    try:
        yield seen
    finally:
        validation.sliding_window_inference = inner


@contextmanager
def _loop_spy():
    """Inside the block, count ``device_augment`` calls of the training
    loop, and keep each step's loss terms and a checksum of each step's
    batch, taken before and after the step on the consuming stream, as
    device tensors (no host read in the loop), and the type, shape and
    device of the first batch's tensors."""
    import torch

    from rsuper_tpu_torch.train import loop

    spy = {"augments": 0, "losses": [], "terms": [], "sums": [],
           "sums_after": []}
    build, augment = loop.build_train_step, loop.device_augment

    def counted_augment(*args, **kwargs):
        spy["augments"] += 1
        return augment(*args, **kwargs)

    def recording_build(*args, **kwargs):
        step = build(*args, **kwargs)

        def checksum(batch):
            return torch.stack([v.float().sum() for _, v in
                                sorted(batch.items())
                                if isinstance(v, torch.Tensor)])

        def recorded(state, batch):
            spy.setdefault("batch_layout", {  # the first batch's tensors
                k: [str(v.dtype), list(v.shape), v.device.type]
                for k, v in batch.items() if isinstance(v, torch.Tensor)})
            spy["sums"].append(checksum(batch))
            state, losses = step(state, batch)
            spy["losses"].append(losses["overall"].detach().float())
            spy["terms"].append({k: v.detach().float()
                                 for k, v in losses.items()})
            spy["sums_after"].append(checksum(batch))
            return state, losses

        return recorded

    loop.device_augment, loop.build_train_step = counted_augment, \
        recording_build
    try:
        yield spy
    finally:
        loop.device_augment, loop.build_train_step = augment, build


@contextmanager
def _captured_warm_start():
    """Inside the block, keep a copy of the model's parameters right after
    each ``load_pretrained_params`` of the training loop."""
    from rsuper_tpu_torch.train import loop

    seen, inner = [], loop.load_pretrained_params

    def capturing(state, *args, **kwargs):
        out = inner(state, *args, **kwargs)
        seen.append({k: v.detach().cpu().clone()
                     for k, v in out.model.state_dict().items()})
        return out

    loop.load_pretrained_params = capturing
    try:
        yield seen
    finally:
        loop.load_pretrained_params = inner


def _whole_volume_asd_hd95(pred, target):
    """ASD and HD95 as the JAX package computes them: surfaces and both
    EDTs over the whole volume, once for each of the two metrics."""
    import numpy as np
    from scipy import ndimage as ndi

    def dists():
        ps = pred & ~ndi.binary_erosion(pred)
        ts = target & ~ndi.binary_erosion(target)
        if not ps.any() or not ts.any():
            return np.array([500.0]), np.array([500.0])
        return (ndi.distance_transform_edt(~ts)[ps],
                ndi.distance_transform_edt(~ps)[ts])

    a = dists()
    asd = float(min((a[0].mean() + a[1].mean()) / 2.0, 500.0))
    b = dists()
    hd = float(min(max(np.percentile(b[0], 95), np.percentile(b[1], 95)),
                   500.0))
    return asd, hd


def _metrics_log(exp: Path):
    return [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]


def _confident_heads(model, model32, cases):
    """Set the final head's bias of both models so that, over one 128³
    window of the first case, the logits of the i-th class the cases hold
    sit HEAD_SIGMAS[i % 4] standard deviations from 0. Returns the
    (class index, sigmas) pairs."""
    import torch

    from rsuper_tpu_torch.train import validation

    image = cases[0][0]
    starts = [(n - w) // 2 for n, w in zip(image.shape, VAL_WINDOW)]
    win = image[tuple(slice(s, s + w) for s, w in zip(starts, VAL_WINDOW))]
    x = torch.as_tensor(win, device=model.outc.bias.device)[None, ..., None]
    with torch.inference_mode():
        logits = validation.head_fn(model)(x).float().flatten(0, 3)
    mean, std = logits.mean(0), logits.std(0)
    present = [c for c in range(len(mean))
               if any(labels[c].any() for _, labels in cases)]
    sigmas = [(c, HEAD_SIGMAS[i % len(HEAD_SIGMAS)])
              for i, c in enumerate(present)]
    with torch.no_grad():
        for c, k in sigmas:
            model.outc.bias[c] += float(k * std[c] - mean[c])
        model32.outc.bias.copy_(model.outc.bias)
    return sigmas


def _prob_dist(got, ref):
    """max|Δ| and the relative L2 of two lists of float16 probability
    volumes, in float32 one case at a time."""
    import numpy as np

    err = num = den = 0.0
    for g, r in zip(got, ref):
        for lo in range(0, g.shape[0], 16):
            d = (g[lo: lo + 16].astype(np.float32)
                 - r[lo: lo + 16].astype(np.float32))
            err = max(err, float(np.abs(d).max()))
            num += float((d * d).sum())
            den += float(np.square(r[lo: lo + 16].astype(np.float32)).sum())
    return dict(max_abs_err=err, rel_l2=(num / den) ** 0.5)


def _agreement(cases, classes, a, b, what, failures):
    """Two ``validate_cases`` runs: the voxels whose thresholded masks
    differ, a class at a time; each Dice difference within what they allow
    (k flipped voxels move 2I/(P+T) by at most 3k/(min(P, P') + T)); ASD and
    HD95 finite, and equal where the masks are."""
    import numpy as np

    C = len(classes)
    diff_voxels, bounds = np.zeros(C, np.int64), np.zeros(C)
    for (_, labels), pa, pb in zip(cases, a["probs"], b["probs"]):
        ma, mb = pa > 0.5, pb > 0.5
        for c in range(C):
            t = labels[c] > 0
            if not t.any():
                continue
            n = int((ma[..., c] != mb[..., c]).sum())
            diff_voxels[c] += n
            lo = min(int(ma[..., c].sum()), int(mb[..., c].sum()))
            bounds[c] += 3.0 * n / (lo + int(t.sum()))
    bounds /= np.maximum(a["out"]["cases_per_class"], 1)
    for c in range(C):
        d = abs(a["out"]["dice"][c] - b["out"]["dice"][c])
        if d > bounds[c] + 1e-12:
            failures.append(f"validate: {what} {classes[c]} Dice differs by "
                            f"{d} > {bounds[c]} ({diff_voxels[c]} voxels)")
        for m in ("asd", "hd95"):
            for run in (a, b):
                v = run["out"][m][c]
                if not (math.isfinite(v) and 0.0 <= v <= 500.0):
                    failures.append(f"validate: {what} {classes[c]} {m} {v}")
            if diff_voxels[c] == 0 and a["out"][m][c] != b["out"][m][c]:
                failures.append(f"validate: {what} {classes[c]} {m} differs "
                                "on equal masks")
    return dict(threshold_diff_voxels=[int(v) for v in diff_voxels],
                dice_bound=[float(v) for v in bounds],
                dice_diff=[float(abs(x - y)) for x, y in
                           zip(a["out"]["dice"], b["out"]["dice"])])


def _validate_cases_both(dev, cases, classes, res, failures):
    """Step 1: ``validate_cases`` of the default MedFormer (seeded, the
    final head made confident) in bf16 and in float32, each through the
    kernels and through the plain versions. float32: the probabilities
    within PROB16_TOL, few voxels whose threshold differs, the metrics
    agreeing (``_agreement``). bf16: the probabilities within
    BF16_NOISE_FACTOR times the plain bf16 run's distance from the plain
    float32 run, the metrics agreeing."""
    import numpy as np
    import torch

    from rsuper_tpu_torch.metrics import asd_hd95
    from rsuper_tpu_torch.ops.dispatch import plain_on_device
    from rsuper_tpu_torch.train import validation
    from rsuper_tpu_torch.utils.profiling import PhaseTimer

    C = len(classes)
    model, model32 = _build_models(dev)
    sigmas = _confident_heads(model, model32, cases)
    res["head_sigmas"] = {classes[c]: k for c, k in sigmas}
    counted = wrappers()
    runs = {}
    for name, net, plain in (("kernels", model, False),
                             ("plain", model, True),
                             ("kernels32", model32, False),
                             ("plain32", model32, True)):
        timer = PhaseTimer()
        for w in counted.values():
            w.launches = 0
        torch.cuda.synchronize()
        with _recorded_probs() as probs, (plain_on_device() if plain
                                          else nullcontext()):
            out = validation.validate_cases(
                validation.head_fn(net), cases, C, window=VAL_WINDOW,
                batch=VAL_BATCH, device=dev, timer=timer)
        runs[name] = dict(out=out, probs=probs, phases=timer.summary(),
                          launches={k: counted[k].launches / len(cases)
                                    for k in SERVING_KERNELS})
    k, p = runs["kernels"], runs["plain"]
    k32, p32 = runs["kernels32"], runs["plain32"]
    res["launches_per_case"] = k["launches"]
    for kname, n in k["launches"].items():
        if n <= 0:
            failures.append(f"validate: {kname} was not launched")
    for name, run in runs.items():
        res[f"{name}_case_s"] = dict(
            window_device_s=run["phases"]["val_window_ms"] / 1e3,
            metrics_host_s=run["phases"]["val_metrics_ms"] / 1e3)
        res[f"{name}_metrics"] = {m: [float(v) for v in run["out"][m]]
                                  for m in ("dice", "asd", "hd95")}
    for run in runs.values():
        for pr in run["probs"]:
            if not (np.isfinite(pr).all() and pr.min() >= 0
                    and pr.max() <= 1):
                failures.append("validate: probabilities outside [0, 1]")

    d32 = _prob_dist(k32["probs"], p32["probs"])
    res["probs32_vs_plain"] = dict(d32, tol=PROB16_TOL)
    if not d32["max_abs_err"] <= PROB16_TOL:
        failures.append(f"validate: float32 probabilities vs plain {d32}")
    res["float32"] = _agreement(cases, classes, k32, p32, "float32",
                                failures)
    # no more voxels cross the threshold than lie within PROB16_TOL of it
    near = sum(int((np.abs(pr.astype(np.float32) - 0.5) <= PROB16_TOL).sum())
               for pr in p32["probs"])
    res["float32"]["voxels_near_threshold"] = near
    if sum(res["float32"]["threshold_diff_voxels"]) > near:
        failures.append(f"validate: float32 masks differ at more voxels "
                        f"than lie near the threshold ({near})")

    bf16 = _prob_dist(k["probs"], p["probs"])
    noise = _prob_dist(p["probs"], p32["probs"])
    bf16["tol_max"] = BF16_NOISE_FACTOR * noise["max_abs_err"]
    bf16["tol_rel_l2"] = BF16_NOISE_FACTOR * noise["rel_l2"]
    res["probs_bf16_vs_plain"] = dict(bf16, bf16_noise=noise)
    if not (bf16["max_abs_err"] <= bf16["tol_max"]
            and bf16["rel_l2"] <= bf16["tol_rel_l2"]):
        failures.append(f"validate: bf16 probabilities vs plain "
                        f"{res['probs_bf16_vs_plain']}")
    res["bfloat16"] = _agreement(cases, classes, k, p, "bf16", failures)
    res["cases_per_class"] = [int(v) for v in k["out"]["cases_per_class"]]

    # the port's metrics against the whole-volume formulation, on the
    # first case's mostly-on and mostly-off classes
    image, labels = cases[0]
    pred = k["probs"][0] > 0.5
    whole = {}
    for c, _ in sigmas[:2]:
        t0 = time.perf_counter()
        ours = asd_hd95(pred[..., c], labels[c] > 0)
        t1 = time.perf_counter()
        theirs = _whole_volume_asd_hd95(pred[..., c], labels[c] > 0)
        whole[classes[c]] = dict(port_s=t1 - t0,
                                 whole_volume_s=time.perf_counter() - t1,
                                 equal=ours == theirs)
        if ours != theirs:
            failures.append(f"validate: {classes[c]} ASD/HD95 {ours} != the "
                            f"whole-volume {theirs}")
    res["surface_metrics_host_s"] = whole
    del model, model32, runs, k, p, k32, p32
    torch.cuda.empty_cache()


def phase_validate(dev):
    """Validation, cross-validation, warm starts, host augmentation and the
    prefetcher at the preset's sizes on the synthetic cases of
    ``write_cli_cases`` (2 CT-Mask, 2 CT-Report; a 2-fold split holds a
    CT-Mask case in each test fold):

    1. ``validate_cases`` (default MedFormer, bf16, seeded; 128³ windows in
       batches of 4; the final head made confident, HEAD_SIGMAS) on both
       CT-Mask cases through the kernels and the plain versions:
       probabilities in [0, 1] and within BF16_NOISE_FACTOR times the plain
       bf16 run's distance from the plain float32 run (max and relative
       L2), Dice within what the voxels whose threshold differs allow, ASD
       and HD95 finite (equal where the masks are); the same in float32,
       where the probabilities of both cases lie within
       PROB16_TOL of the plain versions; launches of rows 1, 2 and 5 a case;
       seconds a case on the device (the sliding window) and on the host
       (the metrics); the port's ASD/HD95 against the whole-volume
       formulation, equal and timed;
    2. ``main --k_fold 2 --fold 0`` then ``--fold 1`` (2 steps each): both
       ``fold_results.json`` and the summary, finite;
    3. ``loop.train`` with ``val_freq = 1`` over 2 epochs of 2 steps on
       fold 0: ``val/dice_mean`` twice and ``best``;
    4. ``main --pretrained`` (step 3's directory) for 1 step, without and
       with ``--old_classes`` (the classes less two, reversed): the
       parameters right after the load equal the donor's, the surgery's
       head rows the donor's row of the class in the sorted old list, the
       other rows the fresh initialisation;
    5. ``loop.train`` with ``host_augment`` for LOOP_STEPS steps: finite
       losses, no ``device_augment``; the loader's worker ms an item;
    6. ``loop.train`` with ``device_prefetch`` 2 and 0 (twice), one loader
       worker, LOOP_STEPS steps each: equal batches (checksums on the
       device) and first losses, each batch unchanged by its step (its
       checksum again after the step, on the consuming stream), later
       losses within LOSS_SPREAD_TOL; the medians of ms an iteration and of
       the loop's wait for its batch."""
    import dataclasses

    import numpy as np
    import torch

    from rsuper_tpu_torch.data.preprocess import load_case
    from rsuper_tpu_torch.models import get_model, init_params
    from rsuper_tpu_torch.train import __main__ as cli
    from rsuper_tpu_torch.train import loop
    from rsuper_tpu_torch.utils.device import card_line

    failures, res = [], {"card": card_line(), "window": list(VAL_WINDOW),
                         "batch": VAL_BATCH}
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        masks, reports, csv = write_cli_cases(root)
        classes = json.loads((masks / "classes.json").read_text())
        exp = root / "exp"
        args = ["--preset", PRESET, "--data_root", str(masks),
                "--report_root", str(reports), "--reports", str(csv),
                "--cp_path", str(exp), "--iter_per_epoch", "2",
                "--epochs", "2"]

        # 1. validate_cases, kernels and plain
        t0 = time.time()
        cases = [load_case(str(p), num_classes=len(classes))
                 for p in sorted(masks.glob("*.npz"))]
        res["case_shape"] = list(cases[0][0].shape)
        _validate_cases_both(dev, cases, classes, res, failures)
        res["step1_s"] = time.time() - t0

        # 2. k-fold: each test fold holds a CT-Mask case
        t0 = time.time()
        for fold in (0, 1):
            fold_args = args + ["--unique_name", "cv", "--k_fold", "2",
                                "--fold", str(fold)]
            if all(c.is_report for c in cli.build_run(fold_args).test_cases):
                failures.append(f"validate: fold {fold} holds no CT-Mask "
                                "test case")
            state = cli.main(fold_args + ["--max_steps", "2"])
            if state.step != 2:
                failures.append(f"validate: fold {fold} ran {state.step}")
            fr = exp / f"cv_fold{fold}" / "fold_results.json"
            vals = json.loads(fr.read_text()) if fr.exists() else {}
            if not all(len(vals.get(m, ())) == len(classes) and all(
                    math.isfinite(v) for v in vals[m])
                    for m in ("dice", "asd", "hd95")):
                failures.append(f"validate: {fr} missing or not finite")
        summary = exp / "cv_cross_validation.txt"
        if not summary.exists():
            failures.append("validate: no cross-validation summary")
        else:
            last = summary.read_text().splitlines()[-1].split()
            res["cross_validation_mean"] = last[1:]
            if not all(math.isfinite(float(x.split("±")[0]))
                       for x in last[1:]):
                failures.append(f"validate: summary {last}")
        res["step2_s"] = time.time() - t0

        # 3. the loop's validation every epoch, and best
        t0 = time.time()
        run = cli.build_run(args + ["--unique_name", "val", "--k_fold", "2",
                                    "--fold", "0"])
        cfg = dataclasses.replace(run.cfg, val_freq=1)
        state = loop.train(cfg, run.model, run.dataset,
                           test_cases=run.held_out(), device=dev)
        donor_dir = exp / "val_fold0"
        recs = _metrics_log(donor_dir)
        vals = [r["val/dice_mean"] for r in recs if "val/dice_mean" in r]
        phases = [r for r in recs if "phase/val_window_ms" in r][-1]
        res["loop_validation"] = dict(
            steps=state.step, val_dice_mean=vals,
            val_window_ms=phases["phase/val_window_ms"],
            val_metrics_ms=phases["phase/val_metrics_ms"])
        if not (len(vals) == 2 and all(math.isfinite(v) for v in vals)
                and (donor_dir / "best").exists() and state.step == 4):
            failures.append(f"validate: the loop's validation "
                            f"{res['loop_validation']}")
        del state, run
        res["step3_s"] = time.time() - t0

        # 4. warm starts, without and with class surgery
        t0 = time.time()
        donor = torch.load(donor_dir / "best", map_location="cpu",
                           weights_only=True)["params"]
        old = [c for c in classes if c not in ("colon", "spleen")]
        warm = args + ["--all_train", "--max_steps", "1", "--pretrained",
                       str(donor_dir)]
        with _captured_warm_start() as seen:
            cli.main(warm + ["--unique_name", "warm"])
            cli.main(warm + ["--unique_name", "surgery", "--old_classes",
                             ",".join(reversed(old))])
        fresh = init_params(get_model("medformer", len(classes),
                                      dict(cfg.model_args),
                                      dtype=torch.bfloat16),
                            seed=cfg.seed).state_dict()
        heads = [k for k in donor if k.split(".")[0] in ("outc", "aux_out")]
        bad = [k for k in donor if not torch.equal(seen[0][k], donor[k])]
        bad += [k for k in donor if k not in heads
                and not torch.equal(seen[1][k], donor[k])]
        for key in heads:
            for j, cls in enumerate(classes):
                want = (donor[key][old.index(cls)] if cls in old
                        else fresh[key][j])
                if not torch.equal(seen[1][key][j], want):
                    bad.append(f"{key}[{cls}]")
        res["warm_start"] = dict(tensors=len(donor), heads=heads,
                                 old_classes=len(old), mismatched=bad)
        if len(seen) != 2 or bad:
            failures.append(f"validate: warm starts {res['warm_start']}")
        res["step4_s"] = time.time() - t0

        # 5. host augmentation
        t0 = time.time()
        run = cli.build_run(args + ["--all_train", "--unique_name", "host"])
        with _loop_spy() as spy:
            state = loop.train(dataclasses.replace(run.cfg,
                                                   host_augment=True),
                               run.model, run.dataset, max_steps=LOOP_STEPS,
                               device=dev)
        losses = [float(v) for v in spy["losses"]]
        ph = [r for r in _metrics_log(exp / "host") if "phase/step_ms" in r][-1]
        res["host_augment"] = dict(
            steps=state.step, losses=losses, device_augments=spy["augments"],
            loader_item_ms=ph["phase/loader_item_ms"],
            loader_wait_median_ms=ph["phase/load_median_ms"],
            h2d_host_median_ms=ph["phase/h2d_median_ms"],
            ms_per_iteration_median=ph["phase/iteration_median_ms"],
            num_workers=run.cfg.num_workers)
        if not (state.step == LOOP_STEPS and len(losses) == LOOP_STEPS
                and all(math.isfinite(v) for v in losses)
                and spy["augments"] == 0):
            failures.append(f"validate: host_augment {res['host_augment']}")
        del state, run
        res["step5_s"] = time.time() - t0

        # 6. the prefetcher against inline transfers, one loader worker;
        # inline twice, for the step's own spread between runs
        t0 = time.time()
        pf = {}
        for name, depth in (("prefetch2", 2), ("inline", 0),
                            ("inline_again", 0)):
            run = cli.build_run(args + ["--all_train", "--num_workers", "1",
                                        "--unique_name", name])
            with _loop_spy() as spy:
                loop.train(dataclasses.replace(run.cfg,
                                               device_prefetch=depth),
                           run.model, run.dataset, max_steps=LOOP_STEPS,
                           device=dev)
            ph = [r for r in _metrics_log(exp / name)
                  if "phase/step_ms" in r][-1]
            pf[name] = dict(
                losses=[float(v) for v in spy["losses"]],
                sums=torch.stack(spy["sums"]).cpu(),
                sums_after=torch.stack(spy["sums_after"]).cpu(),
                ms_per_iteration_median=ph["phase/iteration_median_ms"],
                loop_wait_median_ms=ph["phase/load_median_ms"],
                feeder_load_median_ms=ph.get("phase/feeder_load_median_ms"),
                ms_per_iteration_mean=ph["phase/iteration_ms"],
                loader_item_ms=ph["phase/loader_item_ms"],
                augments=spy["augments"])
            del run
        ref = pf["inline"]

        def rel(a, b):  # the largest relative difference after step 1
            return max(abs(x - y) / abs(y) for x, y in zip(a[1:], b[1:]))

        out = {n: {k: v for k, v in r.items()
                   if k not in ("sums", "sums_after")}
               for n, r in pf.items()}
        out["equal_batches"] = all(torch.equal(r["sums"], ref["sums"])
                                   for r in pf.values())
        out["batches_intact_after_step"] = all(
            torch.equal(r["sums_after"], r["sums"]) for r in pf.values())
        out["equal_first_loss"] = len({r["losses"][0]
                                       for r in pf.values()}) == 1
        out["later_loss_rel_diff"] = rel(pf["prefetch2"]["losses"],
                                         ref["losses"])
        out["inline_later_loss_rel_diff"] = rel(pf["inline_again"]["losses"],
                                                ref["losses"])
        res["prefetch"] = out
        if not (out["equal_batches"] and out["equal_first_loss"]
                and out["batches_intact_after_step"]
                and all(len(r["losses"]) == LOOP_STEPS
                        and all(math.isfinite(v) for v in r["losses"])
                        for r in pf.values())
                and out["later_loss_rel_diff"] <= LOSS_SPREAD_TOL
                and out["inline_later_loss_rel_diff"] <= LOSS_SPREAD_TOL):
            failures.append(f"validate: prefetch {out}")
        res["step6_s"] = time.time() - t0
    torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"validate": res}))
    return failures


# ------------------------------------------------------------------- zoo
ZOO_PRESET = "abdomenatlas/resunet_3d"
ZOO_STEPS, ZOO_RESUME_STEPS = 4, 2
ZOO_EDGE = 144  # the predict phantom: 8 windows of the CLI's 128³
ZOO_ARCHS = ("unet", "attention_unet", "unetpp", "vnet", "unetr",
             "swin_unetr", "nnformer", "vtunet")
ZOO_SIZE = {"swin_unetr": 128, "nnformer": 128}  # else 96: the deepest stage
# of these two is 1/16 of the input and must be a multiple of the window 4
ZOO_CPU_SIZE = {"unetr": 96}  # else 64: the card against the CPU in float32
ZOO_F32_TOL = 1e-3  # max|Δ| ≤ tol·(1+max|ref|): cuDNN against the CPU's
# convs, float32 both, through up to ~40 instance norms


@contextmanager
def _last_step_batch():
    """Inside the block, keep a copy of the last batch the training loop's
    step took with a live report slot (a tumour volume > 0, which the Ball
    Loss isolates), and the lesion map and loss configuration the step was
    built with."""
    import torch

    from rsuper_tpu_torch.train import loop

    seen, build = {}, loop.build_train_step

    def recording_build(lmap, cfg, *args, **kwargs):
        step = build(lmap, cfg, *args, **kwargs)
        seen.update(lmap=lmap, cfg=cfg)

        def recorded(state, batch):
            if bool((batch["volumes"] > 0).any()):
                seen["batch"] = {k: v.clone() if isinstance(v, torch.Tensor)
                                 else v for k, v in batch.items()}
            return step(state, batch)

        return recorded

    loop.build_train_step = recording_build
    try:
        yield seen
    finally:
        loop.build_train_step = build


def _zoo_arch(dev, arch: str):
    """One arch at the JAX registry's defaults: a bf16 forward and backward
    on the card (ms after a warm-up, peak memory), and its float32 logits
    on the card against the CPU's on the same input and weights."""
    import torch

    from rsuper_tpu_torch.models import get_model, init_params

    n = len(CLASSES)
    res, size = {}, ZOO_SIZE.get(arch, 96)
    model = init_params(get_model(arch, n, {}, dtype=torch.bfloat16),
                        seed=0).to(dev)
    x = torch.randn((1, size, size, size, 1), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)

    def step():
        model.zero_grad(set_to_none=True)
        seg = model(x)["segmentation"]
        heads = seg if isinstance(seg, (list, tuple)) else [seg]
        sum(h.float().square().mean() for h in heads).backward()
        return heads

    heads = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res.update(size=size, params_m=sum(p.numel() for p in
                                       model.parameters()) / 1e6,
               heads=len(heads), logits=list(heads[0].shape),
               fwd_bwd_ms=time_ms(step, reps=2, warmup=0),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               finite=all(bool(torch.isfinite(h).all()) for h in heads)
               and all(bool(torch.isfinite(p.grad).all())
                       for p in model.parameters() if p.grad is not None))
    del heads
    model.zero_grad(set_to_none=True)
    cpu_size = ZOO_CPU_SIZE.get(arch, 64)
    xc = torch.randn((1, cpu_size, cpu_size, cpu_size, 1),
                     generator=torch.Generator().manual_seed(2))
    m32 = get_model(arch, n, {}, dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = m32(xc)["segmentation"]
        got = m32.to(dev)(xc.to(dev))["segmentation"]
    ref = ref[0] if isinstance(ref, (list, tuple)) else ref
    got = (got[0] if isinstance(got, (list, tuple)) else got).cpu()
    mx = float(ref.abs().max())
    res.update(cpu_size=cpu_size, f32_max_abs_err=float(
        (got - ref).abs().max()), f32_ref_max=mx,
        f32_rel_l2=float((got - ref).norm() / ref.norm()))
    res["ok"] = (res["finite"] and tuple(res["logits"]) == (
        1, size, size, size, n) and res["f32_max_abs_err"]
        <= ZOO_F32_TOL * (1 + mx))
    del model, m32
    torch.cuda.empty_cache()
    return res


def phase_zoo(dev):
    """The 3D model zoo on the card: (a) the ``abdomenatlas/resunet_3d``
    preset through the training CLI (ResUNet at 128³ × 2, bf16,
    ``ball_dice_last``; fold 0 of ``--k_fold 2``, so the run validates its
    held-out case): ZOO_STEPS steps with the last profiled and the launch
    counts set to 0 just before and read just after, then ``--resume`` for
    ZOO_RESUME_STEPS; (b) the Ball Loss of the last step's own batch
    through the top-N kernel against its plain version; (c) ``predict
    --arch resunet --checkpoint`` of the run on a ZOO_EDGE³ phantom, and the
    windows' device time; (d) every other 3D arch (``_zoo_arch``)."""
    import numpy as np
    import torch

    from rsuper_tpu_torch import predict as cli
    from rsuper_tpu_torch.config import DEFAULT_CONFIGS
    from rsuper_tpu_torch.data.nifti import write_nifti
    from rsuper_tpu_torch.data.preprocess import clip_and_normalize
    from rsuper_tpu_torch.inference.sliding_window import \
        sliding_window_probs_device
    from rsuper_tpu_torch.models import get_model
    from rsuper_tpu_torch.train import validation
    from rsuper_tpu_torch.train.__main__ import main as train_main
    from rsuper_tpu_torch.train.checkpoint import load_params
    from rsuper_tpu_torch.utils.device import card_line

    t_phase = time.time()
    model_args = DEFAULT_CONFIGS[ZOO_PRESET]["model_args"]
    failures, res = [], {"card": card_line(), "preset": ZOO_PRESET,
                         "model_args": model_args, "crop": list(AUG_CROP),
                         "batch": 2}
    counted = wrappers()
    topn = "topn_threshold_multi_batched"
    validated, run_validation = [], validation.run_validation

    def timed_validation(*args, **kwargs):
        t0 = time.time()
        out = run_validation(*args, **kwargs)
        torch.cuda.synchronize()
        validated.append(dict(cases=int(max(out["cases_per_class"])),
                              seconds=time.time() - t0,
                              dice=[float(v) for v in out["dice"]]))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        masks, reports, csv = write_cli_cases(root)
        args = ["--preset", ZOO_PRESET, "--data_root", str(masks),
                "--report_root", str(reports), "--reports", str(csv),
                "--cp_path", str(root / "exp"), "--unique_name", "zoo",
                "--iter_per_epoch", "3", "--epochs", "4", "--k_fold", "2",
                "--fold", "0"]
        exp = root / "exp" / "zoo_fold0"

        # (a) the preset through the CLI
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for w in counted.values():
            w.launches = 0
        validation.run_validation = timed_validation
        try:
            with _last_step_batch() as last:
                t0 = time.time()
                state = train_main(args + ["--max_steps", str(ZOO_STEPS),
                                           "--profile_steps", "1"])
                torch.cuda.synchronize()
                res["run_s"] = time.time() - t0
            launches = {k: w.launches for k, w in counted.items()}
            res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            recs = _metrics_log(exp)
            phases = [r for r in recs if "phase/step_ms" in r][-1]
            losses = {r["step"]: r["train/overall"] for r in recs
                      if "train/overall" in r}
            names, busy_ms = _trace_kernels(exp / "trace" / "trace.json")
            res.update(
                profiled_step_top=_trace_top(exp / "trace" / "trace.json"),
                steps=state.step, logged_losses=losses,
                ms_per_iteration=phases["phase/iteration_median_ms"],
                step_call_ms=phases["phase/step_median_ms"],
                loader_wait_ms=phases["phase/load_median_ms"],
                loader_item_ms=phases["phase/loader_item_ms"],
                profiled_step_device_ops=len(names),
                profiled_step_busy_ms=busy_ms,
                device_busy_share_of_iteration=busy_ms
                / phases["phase/iteration_median_ms"],
                topn_in_profiled_step=sum("multisect_kernel" in k
                                          for k in names),
                launches_per_step={k: n / ZOO_STEPS
                                   for k, n in launches.items() if n},
                validation=list(validated))
            if state.step != ZOO_STEPS:
                failures.append(f"zoo: step {state.step} after the run")
            if not losses or not all(math.isfinite(v)
                                     for v in losses.values()):
                failures.append(f"zoo: logged losses {losses}")
            if launches[topn] <= 0 or res["topn_in_profiled_step"] <= 0:
                failures.append("zoo: the batched top-N kernel was not "
                                "launched in the ResUNet step")
            if (not validated or validated[0]["cases"] < 1
                    or not (exp / "fold_results.json").exists()):
                failures.append(f"zoo: the fold was not validated: "
                                f"{validated}")

            # (b) row 8 against its plain version on a step's batch
            if "batch" not in last:
                raise RuntimeError("zoo: no step had a live report slot")
            agree = _ball_loss_on_identical_logits(
                state, last["batch"], last["lmap"], last["cfg"])
            res["ball_loss_on_identical_logits"] = {
                k: agree[k] for k in ("losses", "mask_voxels_that_differ",
                                      "ok")}
            if not agree["ok"]:
                failures.append(f"zoo: the Ball Loss through the top-N "
                                f"kernel differs from its plain version: "
                                f"{agree}")
            del state, last
            torch.cuda.empty_cache()

            state = train_main(args + ["--max_steps",
                                       str(ZOO_RESUME_STEPS), "--resume"])
        finally:
            validation.run_validation = run_validation
        total = ZOO_STEPS + ZOO_RESUME_STEPS
        saved = torch.load(exp / "latest", weights_only=True)
        res["resumed"] = dict(step=state.step, saved_step=saved["step"])
        if not state.step == saved["step"] == total:
            failures.append(f"zoo: the resumed run: {res['resumed']}")
        del state, saved
        torch.cuda.empty_cache()

        # (c) the predict CLI serves what the run wrote
        (root / "in").mkdir()
        ct = phantom_ct(ZOO_EDGE, seed=5)
        write_nifti(str(root / "in" / "zoo_case.nii"), ct, np.eye(4))
        t0 = time.time()
        done = cli.main([
            "--input_dir", str(root / "in"), "--output_dir",
            str(root / "out"), "--checkpoint", str(exp), "--tag", "latest",
            "--classes_json", str(masks / "classes.json"), "--arch",
            "resunet", "--model_args_json", json.dumps(model_args)])
        torch.cuda.synchronize()
        res["predict_s_per_volume"] = time.time() - t0
        if done != ["zoo_case"] or (root / "out" /
                                    "prediction_errors.txt").exists():
            failures.append(f"zoo: predict --arch resunet gave {done}")
        n = len(json.loads((masks / "classes.json").read_text()))
        model = get_model("resunet", n, model_args, dtype=torch.bfloat16)
        model.load_state_dict(load_params(str(exp), "latest"))
        model = model.to(dev).eval()
        vol = clip_and_normalize(ct)

        def windows():
            with torch.inference_mode():
                sliding_window_probs_device(
                    lambda x: model(x)["segmentation"], vol, n,
                    window=(128,) * 3, batch=8, device=dev)

        prof = _profile(windows, top=5)
        res["predict_windows"] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_busy_share", "device_ops",
            "top")}
        del model
        torch.cuda.empty_cache()

    # (d) every other 3D arch at the JAX registry's defaults
    res["archs"] = {}
    for arch in ZOO_ARCHS:
        res["archs"][arch] = r = _zoo_arch(dev, arch)
        if not r["ok"]:
            failures.append(f"zoo {arch}: {r}")
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"zoo": res}))
    return failures


DIM2_PRESET = "slices/resunet_2d"
DIM2_STEPS, DIM2_RESUME_STEPS = 4, 2
DIM2_ARCHS = ("unet_2d", "resunet_2d", "attention_unet_2d",
              "dual_attention_unet_2d", "transunet_2d", "swin_unet_2d",
              "unetpp_2d", "medformer_2d")
DIM2_SIZE, DIM2_BATCH = 256, 8  # the preset's slices, a window batch of 8
# the two MedFormer variants at the default widths, 96³ × 1
MF_VARIANTS = {
    "mf_aniso": dict(scale=((1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))),
    "mf_mbconv": dict(conv_block="MBConv", conv_num=(2, 1, 1, 1, 1, 1, 2, 2),
                      proj_type="linear", act="gelu"),
}
CONV_ROWS = ("conv3x3x3_cf", "in_relu_conv3x3x3_cf", "conv3x3x3_cf_dgrad",
             "conv3x3x3_cf_wgrad", "in_relu_conv3x3x3_cf_wgrad")
DW_ROWS = ("depthwise_conv3x3x3", "depthwise_conv3x3x3_bwd")
MF_LAUNCHED = {"mf_aniso": CONV_ROWS + DW_ROWS, "mf_mbconv": DW_ROWS}


def phase_dim2(dev):
    """The 2D pathway on the card: (a) ``main`` with ``--preset
    slices/resunet_2d`` (UNet2D base 32, 256² slices × 2, ``dice``, EMA) on
    CT-Mask cases alone (fold 0 of ``--k_fold 2``, so the run validates
    the held-out 152 × 172 × 170 case slice by slice with
    ``validate_cases_2d``): DIM2_STEPS steps, then DIM2_RESUME_STEPS on
    ``--resume``; ms an iteration, the loop's wait for the loader, worker
    ms an item, the validation's seconds. (b) every 2D arch at the JAX
    registry's defaults: a bf16 forward and backward at 256² × 8 (ms, peak
    memory) and its float32 logits on the card against the CPU's at 256²
    × 1, within max(ZOO_F32_TOL, 4ρ)·(1 + max|ref|), ρ the move of the
    CPU's logits under one float32 rounding of the input (the seeded 2D
    MedFormer is chaotic: ρ ≈ 1e-3 there, ≤ 2e-5 in the others), failing
    above RHO_MAX."""
    import torch

    from rsuper_tpu_torch.models import get_model, init_params
    from rsuper_tpu_torch.train import validation
    from rsuper_tpu_torch.train.__main__ import main as train_main
    from rsuper_tpu_torch.utils.device import card_line

    t_phase = time.time()
    failures, res = [], {"card": card_line(), "preset": DIM2_PRESET}
    validated, run_validation = [], validation.run_validation

    def timed_validation(*args, **kwargs):
        t0 = time.time()
        out = run_validation(*args, **kwargs)
        torch.cuda.synchronize()
        validated.append(dict(cases=int(max(out["cases_per_class"])),
                              seconds=time.time() - t0,
                              dice=[float(v) for v in out["dice"]]))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        masks, _, _ = write_cli_cases(root)
        args = ["--preset", DIM2_PRESET, "--data_root", str(masks),
                "--cp_path", str(root / "exp"), "--unique_name", "dim2",
                "--iter_per_epoch", "3", "--epochs", "4", "--k_fold", "2",
                "--fold", "0"]
        exp = root / "exp" / "dim2_fold0"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        validation.run_validation = timed_validation
        try:
            t0 = time.time()
            state = train_main(args + ["--max_steps", str(DIM2_STEPS)])
            torch.cuda.synchronize()
            res["run_s"] = time.time() - t0
            res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            recs = _metrics_log(exp)
            phases = [r for r in recs if "phase/step_ms" in r][-1]
            losses = {r["step"]: r["train/overall"] for r in recs
                      if "train/overall" in r}
            res.update(steps=state.step, logged_losses=losses,
                       ms_per_iteration=phases["phase/iteration_median_ms"],
                       step_call_ms=phases["phase/step_median_ms"],
                       loader_wait_ms=phases["phase/load_median_ms"],
                       loader_item_ms=phases["phase/loader_item_ms"])
            if state.step != DIM2_STEPS or not losses or not all(
                    math.isfinite(v) for v in losses.values()):
                failures.append(f"dim2: step {state.step}, losses {losses}")
            del state
            state = train_main(args + ["--max_steps",
                                       str(DIM2_RESUME_STEPS), "--resume"])
            saved = torch.load(exp / "latest", weights_only=True)
            res["resumed"] = dict(step=state.step, saved_step=saved["step"])
            if not state.step == saved["step"] == DIM2_STEPS \
                    + DIM2_RESUME_STEPS:
                failures.append(f"dim2: the resumed run: {res['resumed']}")
            del state, saved
        finally:
            validation.run_validation = run_validation
        res["validation"] = list(validated)
        if (len(validated) != 2 or validated[0]["cases"] < 1
                or not (exp / "fold_results.json").exists()):
            failures.append(f"dim2: the fold was not validated: {validated}")
    torch.cuda.empty_cache()

    res["archs"] = {}
    n = len(CLASSES)
    img = {"img_size": (DIM2_SIZE, DIM2_SIZE)}
    for arch in DIM2_ARCHS:
        r = res["archs"][arch] = {}
        model = init_params(get_model(arch, n, img, dtype=torch.bfloat16),
                            seed=0).to(dev)
        x = torch.randn((DIM2_BATCH, DIM2_SIZE, DIM2_SIZE, 1),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)

        def step():
            model.zero_grad(set_to_none=True)
            seg = model(x)["segmentation"]
            heads = seg if isinstance(seg, (list, tuple)) else [seg]
            sum(h.float().square().mean() for h in heads).backward()
            return heads

        heads = step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r.update(params_m=sum(p.numel() for p in model.parameters()) / 1e6,
                 logits=list(heads[0].shape),
                 fwd_bwd_ms=time_ms(step, reps=2, warmup=0),
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 finite=all(bool(torch.isfinite(h).all()) for h in heads))
        del heads
        model.zero_grad(set_to_none=True)
        cpu = torch.Generator().manual_seed(2)
        xc = torch.randn((1, DIM2_SIZE, DIM2_SIZE, 1), generator=cpu)
        # one float32 rounding of the input, at random signs: how far the
        # seeded model alone moves its logits (ρ, as the train phase)
        xp = xc + (torch.randint(0, 2, xc.shape, generator=cpu) * 2 - 1) \
            * xc.abs() * 2.0 ** -24
        m32 = get_model(arch, n, img, dtype=torch.float32)
        m32.load_state_dict(model.state_dict())

        def head(out):
            seg = out["segmentation"]
            return seg[0] if isinstance(seg, (list, tuple)) else seg

        with torch.no_grad():
            ref, moved = head(m32(xc)), head(m32(xp))
            got = head(m32.to(dev)(xc.to(dev))).cpu()
        mx = float(ref.abs().max())
        rho = float((moved - ref).abs().max()) / (1 + mx)
        r.update(f32_max_abs_err=float((got - ref).abs().max()),
                 f32_ref_max=mx, f32_rho=rho,
                 f32_tol=max(ZOO_F32_TOL, 4 * rho) * (1 + mx))
        r["ok"] = (r["finite"] and tuple(r["logits"]) == (
            DIM2_BATCH, DIM2_SIZE, DIM2_SIZE, n) and rho <= RHO_MAX
            and r["f32_max_abs_err"] <= r["f32_tol"])
        if not r["ok"]:
            failures.append(f"dim2 {arch}: {r}")
        del model, m32
        torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"dim2": res}))
    return failures


@contextmanager
def _launch_shapes():
    """Inside the block, the shapes at which rows 1–6 launch their kernels
    (name → {(shape, dtype)}), recorded at the launch functions of
    ``ops/conv_cf.py`` and ``ops/dwconv.py``: (B, D, C_in, H, W, C_out) of
    the conv kernels as they stage them (for the dgrad, C_in is dy's
    channels), (B, D, H, W, C) of the depthwise ones."""
    from rsuper_tpu_torch.ops import conv_cf, dwconv

    seen = {k: set() for k in CONV_ROWS + DW_ROWS}
    saved = (conv_cf._launch, conv_cf._launch_wgrad, dwconv._launch,
             dwconv._launch_bwd)

    def dtype(x):
        return str(x.dtype).split(".")[-1]

    def launch(x, w, stats):
        # the dgrad wrapper runs the forward kernel on flipped weights, on
        # dy's layout; its caller tells it from the forward
        if sys._getframe(1).f_code.co_name == "conv3x3x3_cf_dgrad":
            name = "conv3x3x3_cf_dgrad"
        else:
            name = "conv3x3x3_cf" if stats is None else "in_relu_conv3x3x3_cf"
        seen[name].add((tuple(x.shape) + (w.shape[4],), dtype(x)))
        return saved[0](x, w, stats)

    def launch_wgrad(x, dy, stats):
        name = ("conv3x3x3_cf_wgrad" if stats is None
                else "in_relu_conv3x3x3_cf_wgrad")
        seen[name].add((tuple(x.shape) + (dy.shape[2],), dtype(x)))
        return saved[1](x, dy, stats)

    def dw_launch(x, w):
        seen["depthwise_conv3x3x3"].add((tuple(x.shape), dtype(x)))
        return saved[2](x, w)

    def dw_launch_bwd(x, w, dy, round_dw=False):
        seen["depthwise_conv3x3x3_bwd"].add((tuple(x.shape), dtype(x)))
        return saved[3](x, w, dy, round_dw)

    (conv_cf._launch, conv_cf._launch_wgrad, dwconv._launch,
     dwconv._launch_bwd) = (launch, launch_wgrad, dw_launch, dw_launch_bwd)
    try:
        yield seen
    finally:
        (conv_cf._launch, conv_cf._launch_wgrad, dwconv._launch,
         dwconv._launch_bwd) = saved


def _row_at_shape(name, shape, dtype, gen, dev):
    """One kernel of rows 1–6 against its plain version at `shape` on
    seeded inputs: max|Δ| and the kernels phase's bound."""
    import torch

    from rsuper_tpu_torch.ops import conv_cf, dwconv
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    dt = getattr(torch, dtype)

    def rand(*s):
        return torch.randn(s, generator=gen, device=dev)

    if name in DW_ROWS:
        x = rand(*shape).to(dt)
        w = rand(3, 3, 3, 1, shape[-1]) / 27
        args = (x, w) if name == "depthwise_conv3x3x3" else \
            (x, w, rand(*shape).to(dt))
    else:
        B, D, Ci, H, W, Co = shape
        if name == "conv3x3x3_cf_dgrad":  # dy (B, D, Ci, H, W), w (…, Co, Ci)
            args = (rand(B, D, Ci, H, W).to(dt),
                    rand(3, 3, 3, Co, Ci) / math.sqrt(27 * Co))
        elif name.endswith("wgrad"):
            x = rand(B, D, Ci, H, W).to(dt)
            args = (x, rand(B, D, Co, H, W).to(dt))
            if name.startswith("in_relu"):
                args += (conv_cf._in_stats_cf(x, 1e-4),)
        else:
            args = (rand(B, D, Ci, H, W).to(dt),
                    rand(3, 3, 3, Ci, Co) / math.sqrt(27 * Ci))
    fn = getattr(dwconv if name in DW_ROWS else conv_cf, name)
    got = fn(*args)
    with plain_on_device():
        ref = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err, tol = 0.0, 0.0
    ok = True
    for g, r in zip(got, ref):
        e, mx = _err(g, r)
        t = TOL[str(g.dtype).split(".")[-1]] * (1.0 + mx)
        ok = ok and e <= t
        err, tol = max(err, e), max(tol, t)
    return dict(name=name, shape=list(shape), dtype=dtype, max_abs_err=err,
                tol=tol, ok=ok)


def phase_mf_variants(dev):
    """Two MedFormer configurations beside the default, at its widths, on
    one 96³ volume: ``mf_aniso`` (the default blocks on an anisotropic
    scale, (1, 2, 2) first: its channel-first stages run rows 1–6 on planes
    whose depth is twice their edge) and ``mf_mbconv`` (MBConv stages, conv
    blocks beside attention, linear projections, GELU: channels-last, so
    rows 1–4 launch no time and rows 5–6 run the MBConv's 4×-expanded
    depthwise convs). Each: a bf16 forward and backward with the launch
    counts set to 0 just before and read just after (ms after a warm-up,
    peak memory), the shapes every row launched at, each row held against
    its plain version at each of them (the kernels phase's tolerances),
    and the float32 model through the kernels against the
    plain versions at MODEL32_TOL."""
    import torch

    from rsuper_tpu_torch.models import init_params
    from rsuper_tpu_torch.models.medformer import MedFormer
    from rsuper_tpu_torch.ops.dispatch import plain_on_device
    from rsuper_tpu_torch.utils.device import card_line

    t_phase = time.time()
    failures, res = [], {"card": card_line()}
    counted = wrappers()
    n = len(CLASSES)
    gen = torch.Generator(device=dev).manual_seed(3)
    for variant, extra in MF_VARIANTS.items():
        r = res[variant] = {"model_args": extra}
        # MedFormer itself: the registry keeps the default scale, as the
        # JAX registry does
        model = init_params(MedFormer(n, dtype=torch.bfloat16, **extra),
                            seed=0).to(dev)
        x = torch.randn((1, WINDOW, WINDOW, WINDOW, 1), generator=gen,
                        device=dev)

        def step():
            model.zero_grad(set_to_none=True)
            seg = model(x)["segmentation"]
            sum(h.float().square().mean() for h in seg).backward()
            return seg

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in counted.values():
            w.launches = 0
        with _launch_shapes() as shapes:
            seg = step()
            torch.cuda.synchronize()
        launches = {k: counted[k].launches for k in CONV_ROWS + DW_ROWS}
        r.update(launches=launches,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 finite=all(bool(torch.isfinite(h).all()) for h in seg),
                 fwd_bwd_ms=time_ms(step, reps=2, warmup=0),
                 stem_cf=model.stem_cf)
        del seg
        for k in CONV_ROWS + DW_ROWS:
            want = k in MF_LAUNCHED[variant]
            if (launches[k] > 0) != want:
                failures.append(f"{variant}: {k} launched {launches[k]} "
                                f"times, {'expected' if want else 'none'} "
                                "expected")
        r["shapes"] = {k: sorted(list(s) + [d] for s, d in v)
                       for k, v in shapes.items() if v}
        cases = []
        for k, v in shapes.items():
            for s, d in sorted(v):
                c = _row_at_shape(k, s, d, gen, dev)
                cases.append(c)
                if not c["ok"]:
                    failures.append(f"{variant}: {c}")
        r["rows_vs_plain"] = cases
        torch.cuda.empty_cache()
        model32 = MedFormer(n, dtype=torch.float32, **extra)
        model32.load_state_dict(model.state_dict())
        del model
        model32 = model32.to(dev).eval()
        with torch.inference_mode():
            got = model32(x)["segmentation"]
            with plain_on_device():
                ref = model32(x)["segmentation"]
        f32 = _dist(got[0], ref[0])
        f32["tol"] = MODEL32_TOL * (1 + f32["max_abs_ref"])
        r["float32_vs_plain"] = f32
        if not (r["finite"] and f32["finite"]
                and f32["max_abs_err"] <= f32["tol"]
                and tuple(got[0].shape) == (1, WINDOW, WINDOW, WINDOW, n)):
            failures.append(f"{variant}: {r['float32_vs_plain']}")
        del model32, got, ref
        torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"mf_variants": res}))
    return failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    if not (ROOT / "rsuper_tpu_torch" / "csrc").is_dir():
        log("chip_smoke: the rsuper_tpu_torch package is not beside this "
            "script; run it from a checkout of the repository")
        return 2
    sys.path.insert(0, str(ROOT))
    from rsuper_tpu_torch.ops import _build
    from rsuper_tpu_torch.utils.device import card_line

    log(card_line())
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": torch.cuda.get_device_name(0)}))
    t0 = time.time()
    reports = _build.build_all()
    log(json.dumps({"build": sorted(reports), "seconds": time.time() - t0}))
    for name in ("conv_cf", "conv_cf_wgrad", "dwconv", "dwconv_bwd", "topn"):
        log(json.dumps({"ptxas": {"source": f"rsuper_tpu_torch/csrc/{name}.cu",
                                  "kernels": ptxas_summary(reports[name])}}))
    dev = torch.device("cuda")
    # the plain float32 versions are the yardstick: no TF32 in them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, failures = phase_kernels(dev, REPS)
    model, model32 = _build_models(dev)
    failures += phase_model(model, model32, dev, REPS)
    fails, launches = phase_predict(model, model32, dev, VOLUME)
    failures += fails
    del model, model32
    torch.cuda.empty_cache()
    failures += phase_serve(dev)
    torch.cuda.empty_cache()
    fails, train_launches = phase_train(dev, TRAIN_STEPS)
    failures += fails
    torch.cuda.empty_cache()
    failures += phase_augment(dev)
    fails, full_step_ops = phase_train_cli(dev)
    failures += fails
    failures += phase_clip(dev, full_step_ops)
    failures += phase_validate(dev)
    torch.cuda.empty_cache()
    failures += phase_zoo(dev)
    torch.cuda.empty_cache()
    failures += phase_dim2(dev)
    failures += phase_mf_variants(dev)
    # each kernel's count comes from the path it was written for: the
    # forward kernels from the predict phase, the backward ones from the
    # training steps (which launch the forward kernels too)
    launches.update({k: n for k, n in train_launches.items()
                     if k not in SERVING_KERNELS})
    for k in KERNELS:
        if launches.get(k, 0) <= 0:
            failures.append(f"kernel {k} was not launched on its main path")
    log(json.dumps(kernels_line(rows, launches)))
    if failures:
        for f in failures:
            log("FAIL", f)
        return 1
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    log(json.dumps({"ok": True, "device": dev_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
