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
8. loop   — the training loop's throughput (``rsuper_tpu_torch.bench_loop``:
             loader, transfer, device augmentation and the ``ball_dice_last``
             step of the default MedFormer at 96³, batch 1) at 1, 2, 4 and 8
             loader threads, 4 + 12 steps each, the launch counts set to 0
             just before and read just after each run (rows 1–6 launched,
             the top-N rows not: mask cases); rows 1–6 against their plain
             versions at every shape the runs launched them at;
             ``profile_loader``'s stages on the same cases and the host's
             CPU count; a checkpoint of the default model exported to the
             reference's ``.pth`` and converted back (bit-equal parameters
             and logits on the card);
9. train_cli — ``python -m rsuper_tpu_torch.train``'s ``main`` with
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
10. validate — on the same synthetic cases: ``validate_cases`` at 128³
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
11. clip   — CLIP pretraining and the classification branch on the same
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
12. zoo    — the 3D model zoo: ``main`` with ``--preset
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
13. dim2   — the 2D pathway: ``main`` with ``--preset slices/resunet_2d``
             (UNet2D base 32, 256² slices × 2, ``dice``, EMA) on the
             CT-Mask cases alone, fold 0 of ``--k_fold 2``: 4 steps, the
             fold's slice-wise validation (``validate_cases_2d``), 2 on
             ``--resume`` (ms an iteration, the loop's wait, worker ms an
             item, the validation's seconds); every 2D arch at the JAX
             registry's defaults: a bf16 forward and backward at 256² × 8
             (ms, peak memory), float32 logits on the card against the
             CPU's within max(1e-3, 4ρ)·(1 + max|ref|).
14. mf_variants — two MedFormer configurations at the default widths on a
             96³ volume: ``mf_aniso`` (scale (1, 2, 2) first) and
             ``mf_mbconv`` (MBConv stages beside attention, linear
             projections, GELU): a bf16 forward and backward with the launch
             counts set to 0 just before and read just after (rows 1–6 for
             the first, rows 5–6 and no launch of rows 1–4 for the second),
             every shape they launch rows 1–6 at, each row against its plain
             version at each of those shapes, float32 through the kernels
             against the plain versions.
15. genesis — the Model-Genesis mode and the baselines on the train_cli
             cases: ``loop.train`` of the preset with
             ``model_genesis_pretrain`` and a single-head model
             (``aux_loss=False``) for 4 steps, the last profiled, launch
             counts set to 0 just before and read just after (rows 1-6
             launched, the top-N rows not), each step's loss against the
             MSE of its logits and labels recounted in float64; one genesis
             step in float32 through the kernels against the plain versions
             at two cut depths (the train phase's bound); the preset's own
             model (auxiliary heads) refused; ``refine_with_report`` on the
             lesion
             probabilities ``predict_masks_volume`` serves; one round of the
             augmentation daemon read back through
             ``AugmentedRecordDataset``.
16. phantom — the phantom accuracy study
             (``rsuper_tpu_torch.phantom_benchmark``) at its default data
             with 60 steps an arm: both arms trained (float32 ResUNet base
             8, 32³ crops × 4) with the top-N launch counts set to 0 just
             before and read just after (row 8 in the report arm, no top-N
             launch in the mask-only arm), evaluated (metrics finite in
             [0, 1]); row 8 against its plain version at every shape the
             report arm launched it at; the same bits twice from one
             phantom step, one float32 step of the ResUNet preset at 128³ ×
             2, the 3D conv's backward at four shapes and one float32
             ``dice`` step of UNETR, SwinUNETR and VNet (their transposed
             convs' backward).
17. host_pipelines — no device: report extraction with a stub LLM client
             over 50 seeded reports for every step, the same reports as a
             written ``.xlsx`` read back against the ``.csv``, the
             organ-mask maintenance tools on synthetic NIfTIs, the sub-organ
             predictor's discovery and sharding, one sanity dump; a
             ``.feather`` that pandas wrote with ZSTD bodies and categorical
             columns (``tests/data``) read and timed, its cells against
             pandas' digest of them; pandas never imported.
18. ddp    — data parallelism on the one card: the training CLI as a
             one-rank NCCL job (``--dist_*``, ``--zero_opt``, ``--zero_ema``)
             at the preset's sizes for 3 steps against three plain runs of
             the same seed (first-step losses bit-equal; then parameters,
             EMA and losses within 4× the plain runs' own spread of one of
             them: the upsampling's backward adds with atomics); NCCL's refusal of two ranks on one
             device, written down; two gloo ranks on card 0 (the workers
             ``chip_smoke.py --ddp-worker ...`` that it launches) at the
             train phase's batch of 2, one item a rank: float32 losses and
             averaged gradients against one process at batch 2 (the train
             phase's ρ rule, per parameter), 3 bf16 steps replicated and 3
             with ZeRO-1 (ms a step, all-reduce ms and bytes, peak memory
             and optimizer-state bytes a rank, launches a rank a step), one
             CLIP step; every logged loss bit-equal on the two ranks.
19. spatial — spatial sharding on the one card: two gloo ranks in a 1 × 2
             grid split every volume's depth: the MedFormer and ResUNet
             presets and the mf_variants phase's ``mf_mbconv`` at 128³ × 2
             (ms a step a rank beside one process, collectives, peak
             memory, launches
             of rows 1–6 and 8, rows 1–6 at every halo-slab shape), float32
             against one process at 96³ × 2, and one float32 step of every
             other 3D arch at 64³ × 2 against one process (the ρ rule;
             rows 1–6 at every shape those steps launched them at).

The kernels phase also holds rows 1–6 against their plain versions at every
kernel signature the reference traces from its training step at 96³ and
128³ (``rsuper_tpu_torch/ops/reference_shapes.py``).

It prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. It imports nothing of JAX or of
``rsuper_tpu``, and exits non-zero without CUDA or without the
``rsuper_tpu_torch`` package beside it.
"""

from __future__ import annotations

import datetime as _dt
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
    failures += reference_signature_cases(dev)
    return rows, failures


def reference_signature_cases(dev):
    """Rows 1–6 against their plain versions at every kernel signature of
    the reference's training step (``ops/reference_shapes.py``: the JAX
    package's ``production_signatures``, the default MedFormer at 96³ and
    128³, batch 1, bf16), on seeded inputs at the kernels phase's
    tolerances (``_row_at_shape``). One ``{"reference_signatures": ...}``
    line; a case over its bound fails the run."""
    import torch

    from rsuper_tpu_torch.ops.reference_shapes import rows

    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for name, shape, dtype in rows():
        cases.append(_row_at_shape(name, shape, dtype, gen, dev))
    torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    worst = {}
    for c in cases:
        worst[c["name"]] = max(worst.get(c["name"], 0.0),
                               c["max_abs_err"] / c["tol"])
    log(json.dumps({"reference_signatures": dict(
        count=len(cases), failed=len(bad), worst_err_over_tol=worst,
        seconds=time.time() - t0, cases=cases)}))
    return [f"reference signature: {c}" for c in bad]


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

    gen = torch.Generator(device=dev).manual_seed(7)
    for i, (B, V, K) in enumerate(TOPN_SHAPES):
        topn_row(rows, failures, dev, gen, "topn_threshold_multi_batched",
                 B, V, K, i == 0)
    for i, (V, K) in enumerate(TOPN_SINGLE_SHAPES):
        topn_row(rows, failures, dev, gen, "topn_threshold_multi", 1, V, K,
                 i == 0)


def _topn_inputs(gen, dev, B, V, K):
    """``topn_cases``' five inputs at (B, V, K): a ball, a dense normal
    volume, an all-zero last item, a target above the positive count,
    ties."""
    import torch

    from rsuper_tpu_torch.ops.balls import insert_ball

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


def topn_row(rows, failures, dev, gen, name, B, V, K, on_path, path=None):
    """One top-N kernel (`name`: ``topn_threshold_multi`` takes one volume,
    B = 1) at (B, V, K) against the plain bisection on ``_topn_inputs``,
    timed as ``topn_cases`` says; the row (tagged with `path` if given)
    goes to `rows`, a mismatch to `failures`."""
    import torch

    from rsuper_tpu_torch.ops import selection, topn
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    single = name == "topn_threshold_multi"
    fn = getattr(topn, name)
    mask_fn = (selection.topn_masks_multi if single
               else selection.topn_masks_multi_batched)
    worst, mismatches = 0.0, 0
    cases = _topn_inputs(gen, dev, B, V, K)
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
    if path is not None:
        row["path"] = path
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


def _train_losses_and_grads(state, batch, lmap, cfg, clip_only=False,
                            model_genesis=False):
    """One forward and backward from `state` (no update): every loss term as
    a float, the gradient of every parameter the loss reaches, and the Ball
    Loss's trace."""
    from rsuper_tpu_torch.train import loss_fn

    state.model.zero_grad(set_to_none=True)
    with _ball_trace() as trace:
        overall, losses = loss_fn(state.model, batch, lmap, cfg,
                                  model_genesis=model_genesis,
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

    nudged = run(state32, {**batch, "image": _nudge(image, 3, 2.0 ** -22)},
                 plain=True)
    del state32
    state = bench_train.build_state(dev, False, margs)
    got16, ref16 = run(state, batch), run(state, batch, plain=True)
    # the witnesses: the plain bf16 run again, one bf16 rounding of the
    # input away (x·(1 ± 2^-8) moves about half the voxels by one ulp), for
    # three draws of the signs
    nudged16 = []
    for seed in (3, 4, 5):
        b = {**batch,
             "image": _nudge(image, seed, 2.0 ** -8).to(batch["image"].dtype)}
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
    agree["float32"], f32_fails = _float32_grads_vs_plain(
        got32[1], ref32[1], nudged[1])
    fails += f32_fails
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


def _nudge(image, seed: int, step: float):
    """x·(1 ± step), the signs drawn from `seed` on the image's device."""
    import torch

    sign = (torch.rand(image.shape, device=image.device,
                       generator=torch.Generator(device=image.device)
                       .manual_seed(seed)) > 0.5).float() * 2 - 1
    return image * (1 + step * sign)


def _float32_grads_vs_plain(got, ref, nudged, per_parameter=False):
    """The float32 gradients through the kernels (`got`) against the plain
    versions' (`ref`): per parameter ‖Δg‖ ≤ max(TRAIN32_TOL, 4ρ)·(‖g‖ +
    TRAIN_FLOOR·max‖g‖), ρ the move of all the plain gradients under one
    float32 rounding of the input (`nudged`), held under RHO_MAX. With
    `per_parameter`, ρ is the larger of that and the move of the
    parameter's own gradient under the same rounding, up to RHO_MAX: the
    full-resolution convs' weight gradients move several times more than
    the whole.
    Returns the record and the failures."""
    rho = _grad_rel_l2(nudged, ref)
    tol32 = max(TRAIN32_TOL, 4.0 * rho)
    top = max(g.norm().item() for g in ref.values())
    ratios, moves, bad, fails = {}, {}, [], []
    for k, r in ref.items():
        err = (got[k] - r).norm().item()
        moves[k] = ((nudged[k] - r).norm() / r.norm()).item()
        tol = (max(tol32, 4.0 * min(moves[k], RHO_MAX)) if per_parameter
               else tol32)
        bound = tol * (r.norm().item() + TRAIN_FLOOR * top)
        ratios[k] = err / bound
        if not (math.isfinite(err) and err <= bound):
            bad.append(k)
    # the parameters nearest their bound: the kernels' relative distance
    # and the move of the same gradient under the input's rounding
    nearest = [dict(name=k, err_over_bound=ratios[k],
                    rel_err=((got[k] - ref[k]).norm()
                             / ref[k].norm()).item(),
                    rel_move_one_rounding=moves[k])
               for k in sorted(ratios, key=ratios.get)[-5:]]
    rec = dict(parameters=len(ref), tol=tol32, per_parameter=per_parameter,
               largest_parameter_move=max(moves.values()),
               one_rounding_of_the_input_rel_l2=rho, rho_max=RHO_MAX,
               floor=TRAIN_FLOOR, worst_err_over_bound=max(ratios.values()),
               rel_l2_all=_grad_rel_l2(got, ref), failed=bad[:10],
               nearest_bound=nearest)
    if not rho <= RHO_MAX:
        fails.append(f"float32 gradients: one rounding of the input moves "
                     f"them by {rho} > {RHO_MAX}; the bound means nothing")
    if bad:
        fails.append(f"float32 gradients: {len(bad)} parameters over the "
                     f"bound, e.g. {bad[:5]}")
    return rec, fails


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


_CASES: dict = {}  # seed → a directory holding the written cases


def write_cli_cases(root: Path, seed: int = 0):
    """Two CT-Mask and two CT-Report cases through the port's own
    ``preprocess_case``: CT phantoms in HU of 152 × 172 × 136 voxels of
    1 × 1 × 1.25 mm (resampled to 1 mm³: 152 × 172 × 170, no smaller than
    the 148 × 168 × 168 load size), a NIfTI a labelled organ, the sorted
    class lists, and the per-tumour report CSV (the columns of
    ``tests/test_data.py:_report_rows``): a head tumour, a body/tail one and
    a left-kidney one. The files depend on `seed` alone: they are written
    once a run and copied into `root` for every later phase."""
    import atexit
    import shutil

    if seed not in _CASES:
        _CASES[seed] = Path(tempfile.mkdtemp(prefix="cli_cases_"))
        atexit.register(shutil.rmtree, _CASES[seed], True)
        _write_cli_cases(_CASES[seed], seed)
    shutil.copytree(_CASES[seed], root, dirs_exist_ok=True)
    return root / "masks", root / "reports", root / "reports.csv"


def _write_cli_cases(root: Path, seed: int):
    """``write_cli_cases``' files, written into `root`."""
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
# the 2D preset's decoder resizes at 256² × 2 (UNet2D, base 32): 16² → 32²
# (320 channels) up to 128² → 256² (64): (layout, input shape, output size)
# (h): the depths at which an arch's float32 gradients are held: the
# seeded 2D MedFormer at the registry's moves its float32 gradients by
# 4.1e-2 under one rounding of the input on the card, over RHO_MAX; every
# attention stage keeps one block, as (b) cuts the 3D MedFormer
DIM2_CUT = {"medformer_2d": CUT_DEPTH}
DIM2_RESIZES = (("cl", (2, 16, 16, 320), (32, 32)),
                ("cl", (2, 32, 32, 256), (64, 64)),
                ("cl", (2, 64, 64, 128), (128, 128)),
                ("cl", (2, 128, 128, 64), (256, 256)))

# the 2D preset's 3×3 convs at 256² × 2 (UNet2D, base 32): (input (B, H, W,
# C_in), C_out, stride)
DIM2_CONVS = (((2, 256, 256, 32), 32, 1), ((2, 256, 256, 32), 64, 2),
              ((2, 128, 128, 64), 64, 1), ((2, 64, 64, 128), 128, 1),
              ((2, 32, 32, 256), 256, 1), ((2, 16, 16, 320), 320, 1))


def _conv_backward_twice(dev, convs, dtype=None) -> list:
    """The dense conv's backward (``layers.Conv``: ``convolution_backward``
    with cuDNN held to its deterministic algorithms) at `convs` ((input
    (B, *spatial, C_in), C_out, stride); 2 or 3 spatial axes), in `dtype`
    (float32 unless given), on one seeded input, weight and cotangent: its
    two passes bit-equal; the same conv through ``F.pad`` and
    ``F.conv2d``/``F.conv3d``'s own backward (cuDNN's default algorithms):
    whether its two passes gave the same bits, its largest distance to the
    port's, and the ms of both backwards."""
    import torch
    import torch.nn.functional as F

    from rsuper_tpu_torch.models import layers

    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(6)
    out = []
    for shape, c_out, stride in convs:
        nd = len(shape) - 2
        lib = F.conv2d if nd == 2 else F.conv3d
        conv = layers.Conv(shape[-1], c_out, 3, stride, False, dtype=dtype,
                           nd=nd).to(dev)
        with torch.no_grad():
            conv.weight.copy_(0.05 * torch.randn(conv.weight.shape,
                                                 generator=gen, device=dev))
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        x.requires_grad_()
        y = conv(x)
        gy = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
        xb = x.detach().clone().requires_grad_()
        wb = conv.weight.detach().clone().requires_grad_()
        pads = [p for n in shape[-2:0:-1] for p in layers.same_pads(n, 3,
                                                                    stride)]
        yb = lib(F.pad(xb.movedim(-1, 1), pads), wb.to(dtype), None,
                 stride).movedim(1, -1)
        port = lambda: torch.autograd.grad(  # noqa: E731
            y, (x, conv.weight), gy, retain_graph=True)
        library = lambda: torch.autograd.grad(  # noqa: E731
            yb, (xb, wb), gy, retain_graph=True)
        p1, p2 = port(), port()
        l1, l2 = library(), library()
        out.append(dict(
            shape=list(shape), features=c_out, stride=stride,
            dtype=str(dtype).split(".")[-1],
            port_bit_equal=all(torch.equal(a, b) for a, b in zip(p1, p2)),
            library_bit_equal=all(torch.equal(a, b) for a, b in zip(l1, l2)),
            port_vs_library_max_rel=max(
                float((a - b).float().abs().max() / b.float().abs().max())
                for a, b in zip(p1, l1)),
            port_ms=time_ms(port, 5), library_ms=time_ms(library, 5)))
        del conv, x, y, gy, xb, wb, yb, p1, p2, l1, l2
    torch.cuda.empty_cache()
    return out


def _slice_batch(size: int, batch: int, dev, seed: int = 0):
    """A 2D batch as the training loop feeds the step (float32, channels
    last): noise slices, a liver on the first and a pancreas with its
    lesion from the second on, and the zeros of unk / segment_mask /
    volumes / diameters that ``SliceDataset`` gives every record."""
    import numpy as np
    import torch

    from rsuper_tpu_torch import bench_train

    names = bench_train.CLASSES
    rng = np.random.default_rng(seed)
    lab = np.zeros((batch, size, size, len(names)), np.float32)
    a, b = size // 5, size * 3 // 5
    lab[0, a:b, a:b, names.index("liver")] = 1.0
    if batch > 1:
        lab[1:, a:b, b - a:b, names.index("pancreas")] = 1.0
        lab[1:, a + 8:a + 24, b - a + 8:b - a + 24,
            names.index("pancreatic_lesion")] = 1.0
    arrays = dict(image=rng.normal(size=(batch, size, size, 1)),
                  label=lab, unk=np.zeros_like(lab),
                  segment_mask=np.zeros_like(lab),
                  volumes=np.zeros((batch, 10)),
                  diameters=np.zeros((batch, 10, 3)))
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in arrays.items()}


def _dim2_model(arch: str, dev, dtype, cut: bool = False):
    """`arch` at the JAX registry's default widths (``resunet_2d`` with the
    preset's own model arguments), built for DIM2_SIZE² slices, seeded;
    with `cut` at the depths of DIM2_CUT."""
    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.models import get_model, init_params

    args = {"img_size": (DIM2_SIZE, DIM2_SIZE)}
    if arch == "resunet_2d":
        args = dict(load_config(DIM2_PRESET).model_args)
    if cut:
        args.update(DIM2_CUT.get(arch, {}))
    return init_params(get_model(arch, len(bench_train.CLASSES), args,
                                 dtype=dtype), seed=0).to(dev)


def _dim2_step(arch: str, dev, group=None, nudge=False, dtype=None,
               cut: bool = False):
    """One ``dice`` step of `arch` (``_dim2_model``, float32 unless
    `dtype`, with `cut` at DIM2_CUT's depths) on ``_slice_batch(DIM2_SIZE,
    2)`` (with `nudge` its image moved by one float32 rounding): the loss
    terms and every parameter's gradient; with `group` on the rank's rows,
    reduced over the grid."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.train import step as tstep

    model = _dim2_model(arch, dev, dtype or torch.float32, cut)
    batch = _slice_batch(DIM2_SIZE, 2, dev)
    if nudge:
        batch["image"] = _nudge(batch["image"], 3, 2.0 ** -22)
    losses = tstep.gradients(
        model, batch, LesionChannelMap.from_classes(bench_train.CLASSES),
        LossConfig(loss="dice"), group=group)
    return ({k: float(v) for k, v in losses.items()},
            {k: p.grad.detach().clone() for k, p in model.named_parameters()})


def _grads_twice(run) -> dict:
    """`run()` (→ (losses, gradients)) twice: whether the losses and every
    gradient are the same bits, the parameters whose gradients differ (the
    backward's end first) and the largest difference."""
    import torch

    (l1, g1), (l2, g2) = run(), run()
    names = list(g1)[::-1]
    differ = [k for k in names if not torch.equal(g1[k], g2[k])]
    return dict(parameters=len(names), losses_bit_equal=l1 == l2,
                differing=len(differ), first_differing=differ[:8],
                max_abs_diff=max([float((g1[k].float() - g2[k].float())
                                        .abs().max()) for k in differ],
                                 default=0.0))


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
    above RHO_MAX. (c) Determinism: the resize's backward twice at the
    preset's decoder shapes (DIM2_RESIZES, bf16; its ms beside
    ``F.interpolate``'s), the 2D conv's backward twice at the preset's conv
    shapes (DIM2_CONVS, float32; its ms beside ``F.conv2d``'s own), the
    preset's bf16 ``dice`` step at 256² × 2
    twice, and each arch's float32 ``dice`` step at 256² × 2
    (``_dim2_step``) twice: every gradient the same bits."""
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
        r["float32_step_twice"] = _grads_twice(lambda: _dim2_step(arch, dev))
        if r["float32_step_twice"]["differing"]:
            failures.append(f"dim2 {arch}: the float32 step gave other "
                            f"bits twice: {r['float32_step_twice']}")
        torch.cuda.empty_cache()

    # (c) the same bits twice: the resize's backward and the preset's step
    res["resize_backward_twice"] = _resize_backward_twice(dev, DIM2_RESIZES)
    if not all(r["port_bit_equal"] and r["port_within_a_rounding_of_dense"]
               for r in res["resize_backward_twice"]):
        failures.append(f"dim2: the resize's backward gave other bits on a "
                        f"second pass or left the dense contraction: "
                        f"{res['resize_backward_twice']}")
    res["conv2d_backward_twice"] = _conv_backward_twice(dev, DIM2_CONVS)
    if not all(r["port_bit_equal"] and r["port_vs_library_max_rel"] < 1e-4
               for r in res["conv2d_backward_twice"]):
        failures.append(f"dim2: the 2D conv's backward gave other bits on a "
                        f"second pass or left F.conv2d's: "
                        f"{res['conv2d_backward_twice']}")
    res["preset_step_twice"] = _grads_twice(lambda: _dim2_step(
        "resunet_2d", dev, dtype=torch.bfloat16))
    if res["preset_step_twice"]["differing"]:
        failures.append(f"dim2: the preset's bf16 step gave other bits "
                        f"twice: {res['preset_step_twice']}")
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


# ----------------------------------------------- the loop bench, the export
BENCH_WORKERS = (1, 2, 4, 8)  # loader threads of the loop bench's runs
BENCH_WARMUP, BENCH_STEPS = 4, 12


def _export_round_trip(dev, root: Path) -> dict:
    """The default MedFormer's seeded parameters from the card, saved as a
    port checkpoint, exported (``export_checkpoint``, ``.pth``) and
    converted back (``convert_checkpoint``): the parameters bit-equal, and
    a model of the converted parameters on the card gives the original's
    bf16 logits bit for bit on one 96³ window; seconds of each stage."""
    import torch

    from rsuper_tpu_torch import (bench_train, convert_checkpoint,
                                  export_checkpoint)
    from rsuper_tpu_torch.models import get_model
    from rsuper_tpu_torch.train.checkpoint import load_params, save_params

    res = {}
    model = bench_train.build_state(dev).model.eval()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    t0 = time.time()
    save_params(str(root / "ckpt"), params)
    export_checkpoint.main([str(root / "ckpt"), "best",
                            str(root / "model.pth")])
    res["export_s"] = time.time() - t0
    t0 = time.time()
    convert_checkpoint.main([str(root / "model.pth"), str(root / "back")])
    res["convert_s"] = time.time() - t0
    back = load_params(str(root / "back"))
    res["tensors"] = len(back)
    res["params_bit_equal"] = sorted(back) == sorted(params) and all(
        torch.equal(back[k], v.cpu()) for k, v in params.items())
    served = get_model("medformer", len(bench_train.CLASSES), {},
                       dtype=torch.bfloat16)
    served.load_state_dict(back)
    served = served.to(dev).eval()
    x = torch.randn((1, WINDOW, WINDOW, WINDOW, 1), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    with torch.inference_mode():
        a, b = model(x)["segmentation"], served(x)["segmentation"]
    res["logits_bit_equal"] = all(torch.equal(u, v) for u, v in zip(a, b))
    del model, served, params, back, a, b
    torch.cuda.empty_cache()
    return res


def phase_loop(dev):
    """The training loop's throughput (``rsuper_tpu_torch.bench_loop``: the
    loader, the transfer, the device augmentation and the
    ``ball_dice_last`` step of the default MedFormer at 96³, batch 1) with
    BENCH_WARMUP + BENCH_STEPS steps at each of BENCH_WORKERS loader
    threads, the launch counts set to 0 just before each run and read just
    after (rows 1–6 launched, 7–8 not: the cases are mask cases); rows 1–6
    held against their plain versions at every shape the runs launched
    them at; ``profile_loader``'s stages on the runs' cases and the host's
    CPU count; the export round trip (``_export_round_trip``). One
    ``{"loop": ...}`` line; each run prints its own JSON line first."""
    import torch

    from rsuper_tpu_torch import bench_loop, profile_loader
    from rsuper_tpu_torch.utils.device import card_line

    t_phase = time.time()
    failures = []
    res = {"card": card_line(), "host_cpus": os.cpu_count(), "runs": []}
    counted = wrappers()
    gen = torch.Generator(device=dev).manual_seed(5)
    seen = {}
    with tempfile.TemporaryDirectory(prefix="loop_") as tmp:
        for workers in BENCH_WORKERS:
            for w in counted.values():
                w.launches = 0
            with _launch_shapes() as shapes:
                line = bench_loop.main([
                    "--size", str(WINDOW), "--batch", "1", "--warmup",
                    str(BENCH_WARMUP), "--steps", str(BENCH_STEPS),
                    "--workers", str(workers), "--case_dir", tmp])
            torch.cuda.synchronize()
            line["launches"] = {k: counted[k].launches for k in KERNELS}
            res["runs"].append(line)
            for k, v in shapes.items():
                seen.setdefault(k, set()).update(v)
            bad = [k for k in PATH_ROWS if line["launches"][k] <= 0] + [
                k for k in TOPN_KERNELS if line["launches"][k]]
            if bad or not (line["value"] > 0
                           and math.isfinite(line["loss"])):
                failures.append(f"loop: {workers} workers: {line} (rows "
                                f"{bad} launched wrongly)")
        t0 = time.time()
        cases = [_row_at_shape(k, s, d, gen, dev)
                 for k, v in seen.items() for s, d in sorted(v)]
        failures += [f"loop: {c}" for c in cases if not c["ok"]]
        res["rows_vs_plain"] = dict(
            shapes=len(cases), s=time.time() - t0,
            worst=max(cases, key=lambda c: c["max_abs_err"] / c["tol"]))
        size = WINDOW + bench_loop.MARGIN
        res["profile_loader"] = profile_loader.main(
            [str(size)] * 3 + ["--case_dir", tmp])
        res["export"] = _export_round_trip(dev, Path(tmp))
        if not (res["export"]["params_bit_equal"]
                and res["export"]["logits_bit_equal"]):
            failures.append(f"loop: export round trip {res['export']}")
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"loop": res}))
    return failures


# ------------------------------------- Model Genesis and the host pipelines
GENESIS_STEPS = 4
# lesions a report gives each organ, for the report-guided pseudo-labels of
# the served probabilities; each organ's lesion channel and its mask classes
GENESIS_REPORT = {"pancreas": 2, "liver": 1, "kidney": 0}
GENESIS_LESION = {"pancreas": "pancreatic_lesion", "liver": "liver_lesion",
                  "kidney": "kidney_lesion"}
GENESIS_ORGAN = {"pancreas": ("pancreas",), "liver": ("liver",),
                 "kidney": ("kidney_left", "kidney_right")}
GENESIS_MSE_TOL = 1e-5  # a step's float32 MSE against a float64 recount
PATH_ROWS = CONV_ROWS + DW_ROWS  # the kernels of MedFormer's step: rows 1-6


def _genesis_vs_plain(dev, margs, batch, lmap):
    """One Model-Genesis forward and backward in float32 through the kernels
    against the plain versions, from one seeded single-head state: the loss
    within 1e-4 relative, each parameter's gradient within the train
    phase's float32 bound taken per parameter
    (``_float32_grads_vs_plain(per_parameter=True)``)."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LossConfig
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    def run(b, plain=False):
        with plain_on_device() if plain else nullcontext():
            return _train_losses_and_grads(state, b, lmap, LossConfig(),
                                           model_genesis=True)

    state = bench_train.build_state(dev, False, margs, dtype=torch.float32)
    got, ref = run(batch), run(batch, plain=True)
    nudged = run({**batch, "image": _nudge(batch["image"].float(), 3,
                                           2.0 ** -22)}, plain=True)
    del state
    rec, fails = _float32_grads_vs_plain(got[1], ref[1], nudged[1],
                                         per_parameter=True)
    loss, loss_ref = got[0]["genesis_loss"], ref[0]["genesis_loss"]
    rec.update(genesis_loss=loss, genesis_loss_plain=loss_ref,
               loss_tol=1e-4 * abs(loss_ref))
    if not (math.isfinite(loss) and abs(loss - loss_ref) <= rec["loss_tol"]):
        fails.append(f"genesis loss {loss} against plain {loss_ref}")
    torch.cuda.empty_cache()
    return rec, fails


def phase_genesis(dev):
    """The Model-Genesis mode and the baselines at the preset's sizes, on
    the ``train_cli`` phase's synthetic cases:

    * ``loop.train`` of the preset with ``model_genesis_pretrain`` and a
      single-head model (``aux_loss=False``; default widths, 128³ × 2,
      bf16) for GENESIS_STEPS steps, the last profiled, the launch counts
      set to 0 just before and read just after: rows 1-6 launched, the
      top-N rows not (no Ball Loss); each step's ``genesis_loss`` against
      the MSE of that step's logits and labels recounted in float64
      (GENESIS_MSE_TOL); ms an iteration, the step call, the loop's wait,
      busy share, peak memory, launches a step;
    * one genesis step's loss and gradients in float32 through the kernels
      against the plain versions (``_genesis_vs_plain``) at the train
      phase's mid and cut depths, where one float32 rounding of the input
      moves the plain gradients by less than RHO_MAX; each parameter held
      at 4 times the larger of that move and its own gradient's;
    * the preset's own model (auxiliary heads) refuses the mode;
    * ``refine_with_report`` on the lesion probabilities that
      ``predict_masks_volume`` serves for a CT-Mask case with the seeded
      model's head made confident (``_confident_heads``): at most the
      reported number of lesions an organ, inside the organ, timed;
    * ``run_daemon`` for one round over the cases, then
      ``AugmentedRecordDataset.sample`` equal to the records it saved;
      seconds a case."""
    import numpy as np
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.baselines import (extract_lesion_candidates,
                                            refine_with_report)
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.data import augment_daemon
    from rsuper_tpu_torch.data.preprocess import load_case
    from rsuper_tpu_torch.inference.predict import predict_masks_volume
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.losses import dispatcher
    from rsuper_tpu_torch.models import get_model, init_params
    from rsuper_tpu_torch.train import __main__ as cli
    from rsuper_tpu_torch.train import build_train_step, loop
    from rsuper_tpu_torch.train.validation import head_fn
    from rsuper_tpu_torch.utils.device import card_line

    t_phase = time.time()
    failures, res = [], {"card": card_line(), "crop": list(AUG_CROP),
                         "batch": 2, "steps": GENESIS_STEPS}
    counted = wrappers()
    margs = dict(load_config(PRESET).model_args)
    single = {**margs, "aux_loss": False}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        masks, reports, csv = write_cli_cases(root)
        args = ["--preset", PRESET, "--data_root", str(masks),
                "--report_root", str(reports), "--reports", str(csv),
                "--cp_path", str(root / "exp"), "--unique_name", "genesis",
                "--iter_per_epoch", str(GENESIS_STEPS), "--epochs", "2",
                "--device", dev.type]
        with _preset(model_genesis_pretrain=True, model_args=single):
            run = cli.build_run(args)
        recorded, inner = [], dispatcher.model_genesis_loss

        def recording(restored, target):  # keeps the step's tensors alive
            out = inner(restored, target)
            recorded.append((restored.detach(), target.detach(),
                             out["genesis_loss"].detach()))
            return out

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for w in counted.values():
            w.launches = 0
        dispatcher.model_genesis_loss = recording
        try:
            t0 = time.time()
            state = loop.train(run.cfg, run.model, run.dataset,
                               max_steps=GENESIS_STEPS, profile_steps=1,
                               device=dev)
            torch.cuda.synchronize()
            res["run_s"] = time.time() - t0
        finally:
            dispatcher.model_genesis_loss = inner
        launches = {k: w.launches for k, w in counted.items()}
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        exp = root / "exp" / "genesis"
        phases = [r for r in _metrics_log(exp) if "phase/step_ms" in r][-1]
        names, busy_ms = _trace_kernels(exp / "trace" / "trace.json")
        mse = []
        for restored, target, loss in recorded:
            want = ((restored.double() - target.double()) ** 2).mean().item()
            mse.append(dict(genesis_loss=loss.item(), float64=want,
                            rel=abs(loss.item() - want) / want,
                            logits=list(restored.shape),
                            labels=list(target.shape)))
        del recorded
        res.update(
            ms_per_step=phases["phase/iteration_median_ms"],
            step_call_ms=phases["phase/step_median_ms"],
            loader_wait_ms=phases["phase/load_median_ms"],
            loader_item_ms=phases["phase/loader_item_ms"],
            device_busy_ms=busy_ms, device_ops=len(names),
            device_busy_share_of_step=busy_ms / phases[
                "phase/iteration_median_ms"],
            launches_per_step={k: n / GENESIS_STEPS
                               for k, n in launches.items()},
            steps_mse=mse, mse_tol=GENESIS_MSE_TOL)
        if state.step != GENESIS_STEPS or len(mse) != GENESIS_STEPS:
            failures.append(f"genesis: {state.step} steps, {len(mse)} "
                            f"losses, expected {GENESIS_STEPS}")
        for m in mse:
            if not (math.isfinite(m["genesis_loss"])
                    and m["rel"] <= GENESIS_MSE_TOL
                    and m["logits"] == m["labels"]
                    == [2, *AUG_CROP, len(run.classes)]):
                failures.append(f"genesis: a step's loss {m}")
        for k in KERNELS:
            want = k in PATH_ROWS
            if (launches[k] > 0) != want:
                failures.append(f"genesis: {k} launched {launches[k]} times,"
                                f" {'expected' if want else 'none'} expected")
        del state
        torch.cuda.empty_cache()

        # the kernels against the plain versions on one genesis batch, at
        # the train phase's cut depths: at full depth the seeded single-head
        # model moves its float32 gradients by more than RHO_MAX under one
        # rounding of this batch's input, and no bound holds there
        lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
        batch = bench_train.synthetic_batch(AUG_CROP[0], 2, device=dev)
        for key, depth in (("mid_depth", MID_DEPTH), ("cut_depth", CUT_DEPTH)):
            res[f"kernels_vs_plain_{key}"], fails = _genesis_vs_plain(
                dev, {**single, **depth}, batch, lmap)
            failures += [f"genesis {key}: {f}" for f in fails]
        # the preset's model has auxiliary heads: the mode refuses it, as
        # the JAX package fails on it
        aux = bench_train.build_state(dev, False, margs)
        small = {k: v[:, :32, :32, :32] for k, v in batch.items()
                 if v.dim() == 5}
        try:
            build_train_step(lmap, LossConfig(), model_genesis=True)(aux,
                                                                     small)
            res["aux_heads_refused"] = None
            failures.append("genesis: the preset's aux heads were accepted")
        except ValueError as e:
            res["aux_heads_refused"] = str(e)
            if "single-head model (aux_loss=False)" not in str(e):
                failures.append(f"genesis: aux heads refused with {e}")
        del aux, batch, small
        torch.cuda.empty_cache()

        # report-guided pseudo-labels on served probabilities
        classes = json.loads((masks / "classes.json").read_text())
        image, labels = load_case(str(masks / "BDMAP_M0.npz"),
                                  num_classes=len(classes))
        model = init_params(get_model("medformer", len(classes), margs,
                                      dtype=torch.bfloat16), seed=0)
        model = model.to(dev).eval()
        _confident_heads(model, model, [(image, labels)])
        chans = [classes.index(GENESIS_LESION[o]) for o in GENESIS_REPORT]
        t0 = time.time()
        _, probs = predict_masks_volume(
            [head_fn(model)], image, classes, window=VAL_WINDOW,
            batch=VAL_BATCH, prob_channels=chans, prob_wire="f16",
            device=dev)
        res["predict_s"] = time.time() - t0
        del model
        torch.cuda.empty_cache()
        prob_maps = {o: probs[..., i].astype(np.float32)
                     for i, o in enumerate(GENESIS_REPORT)}
        organ_masks = {o: np.any([labels[classes.index(c)] for c in cs], 0)
                       for o, cs in GENESIS_ORGAN.items()}
        t0 = time.time()
        refined = refine_with_report(prob_maps, GENESIS_REPORT, organ_masks)
        res["refine_s"] = time.time() - t0
        pseudo = {}
        for o, n in GENESIS_REPORT.items():
            mask, kept = extract_lesion_candidates(
                prob_maps[o] * organ_masks[o], n) if n else (refined[o], 0)
            pseudo[o] = dict(reported=n, kept=kept,
                             voxels=int(refined[o].sum()),
                             max_prob=float(prob_maps[o].max()))
            if not (kept <= n and np.array_equal(mask, refined[o])
                    and not (refined[o] & ~organ_masks[o]).any()
                    and refined[o].shape == image.shape):
                failures.append(f"genesis: pseudo-labels of {o}: "
                                f"{pseudo[o]}")
        res["pseudo_labels"] = pseudo

        # the augmentation daemon over the cases
        saved, sample = [], run.dataset.sample

        def keep(i, rng=None):
            rec = sample(i, rng)
            saved.append((i, rec))
            return rec

        run.dataset.sample = keep
        dest = str(root / "crops")
        t0 = time.time()
        augment_daemon.run_daemon(run.dataset, dest, seed=0, max_rounds=1)
        res["daemon_s_per_case"] = (time.time() - t0) / len(run.dataset)
        run.dataset.sample = sample
        reader = augment_daemon.AugmentedRecordDataset(run.dataset, dest)
        same = []
        for i, rec in saved:
            back = reader.sample(i)
            same.append(all(np.array_equal(np.asarray(rec[k]), back[k])
                            for k in back))
        res["daemon_cases"], res["daemon_records_equal"] = len(saved), same
        if len(saved) != len(run.dataset) or not all(same):
            failures.append(f"genesis: the daemon's records {same}")
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"genesis": res}))
    return failures


PHANTOM_DATA = dict(n_mask=4, n_report=20, n_test=12)  # the tool's defaults
PHANTOM_CROP = 32
PHANTOM_STEPS = 60  # steps of each arm (the study's default is 240)
PHANTOM_METRICS = ("lesion_dice", "lesion_nsd", "sensitivity", "specificity",
                   "f1")
# two of the ResUNet preset's convs at 128³ × 2 (base 32): (input (B, D, H,
# W, C_in), C_out, stride)
RESUNET_CONVS = (((2, 128, 128, 128, 32), 32, 1),
                 ((2, 32, 32, 32, 128), 128, 1))
# the phantom model's last decoder stage at 32³ × 4 (base 8): its first conv
# on the skip's concatenation, then one inside its block
PHANTOM_CONVS = (((4, 32, 32, 32, 16), 8, 1), ((4, 32, 32, 32, 8), 8, 1))


def _losses_and_grads(model, batch, lmap, cfg):
    """One step's loss terms (floats) and every parameter's gradient."""
    from rsuper_tpu_torch.train import step as tstep

    losses = tstep.gradients(model, batch, lmap, cfg)
    return ({k: float(v) for k, v in losses.items()},
            {k: p.grad.detach().clone() for k, p in model.named_parameters()})


def _phantom_grads_twice(dev, seen) -> dict:
    """The phantom study's model (``resunet``, base 8, ``BasicBlock``,
    ``in``, float32, seeded as ``train_variant`` seeds it) through one step
    of `seen`'s batch, lesion map and loss configuration (a
    ``_last_step_batch`` of the report arm: ``ball_dice_last`` with a live
    report slot) twice: ``_grads_twice``."""
    import torch

    from rsuper_tpu_torch import phantom_benchmark as pb
    from rsuper_tpu_torch.models import get_model, init_params

    args = pb.variant_config(".", True, 1).model_args
    model = init_params(get_model("resunet", len(pb.MASK_CLASSES), args,
                                  dtype=torch.float32), 0).to(dev).train()
    out = _grads_twice(lambda: _losses_and_grads(
        model, seen["batch"], seen["lmap"], seen["cfg"]))
    del model
    torch.cuda.empty_cache()
    return out


def _preset_float32_grads_twice(dev) -> dict:
    """One float32 ``ball_dice_last`` step of the ``abdomenatlas/resunet_3d``
    preset's model (base 32, seeded) on ``bench.py``'s batch at the
    preset's 128³ × 2, twice: ``_grads_twice``."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.models import get_model, init_params

    model = init_params(get_model("resunet", len(bench_train.CLASSES),
                                  RESUNET_ARGS, dtype=torch.float32),
                        0).to(dev).train()
    batch = {k: v.float() for k, v in bench_train.synthetic_batch(
        SPATIAL_SIZE, 2, device=dev).items()}
    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    out = _grads_twice(lambda: _losses_and_grads(model, batch, lmap,
                                                 LossConfig()))
    del model, batch
    torch.cuda.empty_cache()
    return out


# the archs with a transposed conv (``layers.ConvTranspose``), float32 at
# the registry's defaults, and the edge of their one-item batch
CONVT_ARCHS = {"unetr": 96, "swin_unetr": 64, "vnet": 64}


def _conv_transpose_twice(dev) -> dict:
    """One float32 ``dice`` step of each of CONVT_ARCHS (seeded, on
    ``bench.py``'s batch at the arch's edge) twice from the same
    parameters: by arch, ``_grads_twice``'s counts plus the transposed
    convs' gradients (``F.conv_transpose3d``'s own backward) among those
    that differ."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.models import get_model, init_params, layers

    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    out = {}
    for arch, size in CONVT_ARCHS.items():
        model = init_params(get_model(arch, len(bench_train.CLASSES), {},
                                      dtype=torch.float32), 0).to(dev).train()
        batch = {k: v.float() for k, v in
                 bench_train.synthetic_batch(size, 1, device=dev).items()}
        convt = {f"{m}.{n}" for m, mod in model.named_modules()
                 if isinstance(mod, layers.ConvTranspose)
                 for n, _ in mod.named_parameters()}
        grads = []

        def run():
            losses, g = _losses_and_grads(model, batch, lmap,
                                          LossConfig(loss="dice"))
            grads.append(g)
            return losses, g

        r = _grads_twice(run)
        r.update(size=size, conv_transpose_parameters=len(convt),
                 conv_transpose_differing=sum(
                     not torch.equal(grads[0][k], grads[1][k])
                     for k in convt))
        out[arch] = r
        del model, batch, grads
        torch.cuda.empty_cache()
    return out


@contextmanager
def _topn_shapes():
    """Inside the block, the (B, V, K) of every top-N launch, by wrapper."""
    from rsuper_tpu_torch.ops import topn

    seen = {n: set() for n in TOPN_KERNELS}
    saved = topn._launch

    def launch(x, ns, iters, batched):
        name = TOPN_KERNELS[1] if batched else TOPN_KERNELS[0]
        seen[name].add((x.shape[0], x.shape[1], ns.shape[1]))
        return saved(x, ns, iters, batched)

    topn._launch = launch
    try:
        yield seen
    finally:
        topn._launch = saved


def phase_phantom(dev):
    """The phantom accuracy study (``rsuper_tpu_torch.phantom_benchmark``)
    at its default data (4 CT-Mask, 20 CT-Report and 12 test phantoms of
    64³, seed 0) with PHANTOM_STEPS steps an arm: both arms through
    ``train_variant`` (float32 ResUNet base 8, 32³ crops × 4) with the top-N
    launch counts set to 0 just before each and read just after (the report
    arm must launch row 8, the mask-only arm neither top-N row), then
    ``evaluate`` (metrics finite and in [0, 1]); row 8 held bit-equal to
    its plain version at every shape the report arm launched it at (rows
    tagged ``"path": "phantom"``, returned for the kernels line); the same
    bits twice: the report arm's captured step at the phantom model, one
    float32 step of the ResUNet preset at 128³ × 2, and the 3D conv's
    backward at two preset shapes and two of the phantom model's
    (RESUNET_CONVS, PHANTOM_CONVS; ``F.conv3d``'s own backward beside it),
    one float32 ``dice`` step of each arch with a transposed conv
    (CONVT_ARCHS: UNETR, SwinUNETR, VNet), each failing the run if a bit
    differs; one ``{"phantom": ...}`` line with ms a step an arm and
    seconds a stage."""
    import torch

    from rsuper_tpu_torch import phantom_benchmark as pb
    from rsuper_tpu_torch.ops import topn

    t_phase = time.time()
    failures, rows, res, stages = [], [], {}, {}
    with tempfile.TemporaryDirectory(prefix="phantom_") as tmp:
        root = str(Path(tmp))
        t0 = time.time()
        pb.generate(root, **PHANTOM_DATA, seed=0)
        stages["generate_s"] = time.time() - t0
        arms, captured = {}, None
        for with_reports in (False, True):
            name = "report" if with_reports else "mask_only"
            for k in TOPN_KERNELS:
                getattr(topn, k).launches = 0
            t0 = time.time()
            with _last_step_batch() as seen, _topn_shapes() as shapes:
                model, params = pb.train_variant(
                    root, with_reports, PHANTOM_STEPS, crop=PHANTOM_CROP,
                    device=dev)
            torch.cuda.synchronize()
            train_s = time.time() - t0
            launches = {k: getattr(topn, k).launches for k in TOPN_KERNELS}
            t0 = time.time()
            metrics = pb.evaluate(model, params, root, crop=PHANTOM_CROP,
                                  device=dev)
            arms[name] = dict(metrics=metrics, launches=launches,
                              launch_shapes={k: sorted(v)
                                             for k, v in shapes.items()},
                              train_s=train_s, eval_s=time.time() - t0,
                              **pb._step_ms(root, name))
            bad = [k for k in PHANTOM_METRICS
                   if not 0.0 <= metrics[k] <= 1.0]  # NaN fails too
            if bad:
                failures.append(f"phantom {name}: metrics {bad} not finite "
                                f"in [0, 1]: {metrics}")
            if with_reports:
                captured = seen
            del model, params
            torch.cuda.empty_cache()
        res["arms"] = arms
        rep, mask = arms["report"]["launches"], arms["mask_only"]["launches"]
        if rep[TOPN_KERNELS[1]] <= 0 or any(mask.values()):
            failures.append(f"phantom: top-N launches report arm {rep}, "
                            f"mask-only arm {mask} (row 8 must launch in "
                            "the first, neither row in the second)")

        # row 8 against its plain version at every shape it launched at
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(8)
        for name, shapes in arms["report"]["launch_shapes"].items():
            for B, V, K in shapes:
                topn_row(rows, failures, dev, gen, name, B, V, K, False,
                         path="phantom")
        stages["topn_rows_s"] = time.time() - t0

        # the same bits twice
        t0 = time.time()
        if captured is None or "batch" not in captured:
            failures.append("phantom: the report arm took no batch with a "
                            "live report slot")
        else:
            res["step_twice"] = _phantom_grads_twice(dev, captured)
        res["preset_float32_step_twice"] = _preset_float32_grads_twice(dev)
        res["conv3d_backward_twice"] = _conv_backward_twice(
            dev, RESUNET_CONVS + PHANTOM_CONVS)
        res["conv_transpose_step_twice"] = _conv_transpose_twice(dev)
        stages["determinism_s"] = time.time() - t0
        for arch, r in res["conv_transpose_step_twice"].items():
            if r["differing"] or not r["losses_bit_equal"]:
                failures.append(f"phantom: a float32 dice step of {arch} "
                                f"gave other bits: {r}")
        for k in ("step_twice", "preset_float32_step_twice"):
            if k in res and (res[k]["differing"]
                             or not res[k]["losses_bit_equal"]):
                failures.append(f"phantom: {k} gave other bits: {res[k]}")
        if not all(r["port_bit_equal"] and r["port_vs_library_max_rel"] < 1e-4
                   for r in res["conv3d_backward_twice"]):
            failures.append(f"phantom: the 3D conv's backward gave other bits "
                            f"on a second pass or left F.conv3d's: "
                            f"{res['conv3d_backward_twice']}")
    res["topn_rows"] = [{k: r[k] for k in ("name", "shape", "max_abs_err",
                                           "mask_mismatches", "ms",
                                           "plain_ms")} for r in rows]
    res["stages"] = stages
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"phantom": res}))
    return failures, rows


HOST_ANSWERS = (  # a stub LLM's answers, one grammar of each step family
    "lesion 1: type = PDAC; certainty = high; size = 2.3 x 1.8 cm; "
    "organ = pancreas; location = head; attenuation = hypo;\nlesion 2: "
    "type = cyst; certainty = high; size = u; organ = kidney; "
    "location = left; attenuation = u;",
    "No lesions mentioned.",
    "liver tumor presence = yes; kidney tumor presence = no; "
    "pancreas tumor presence = u;",
    "malignant tumor in liver = yes; liver malignant tumor size = 22 mm;",
    "liver tumor 1: type = HCC; certainty = high; size = 3.2 cm; "
    "location = segment 8; arterial enhancement = yes; washout = yes; "
    "capsule = no; threshold growth = u; LI-RADS = LR-5;",
    "abnormalities = ['pancreatic duct dilation', 'liver cyst']; "
    "synonyms = {'PDAC': ['pancreatic adenocarcinoma']}",
    "first diagnosis report = 3;\npre-diagnosis reports = 1, 2;\n"
    "tumor types: PDAC;\n- decision: exclude\nsame report = yes;",
    "very likely malignancy in liver in the first exam = yes;",
)
HOST_REPORTS = 50


class _StubLLM:
    """An LLM client that answers from HOST_ANSWERS by a hash of the
    prompt: no endpoint is contacted."""

    def chat_batch(self, system, users):
        import zlib

        return [HOST_ANSWERS[zlib.crc32((system + u).encode())
                             % len(HOST_ANSWERS)] for u in users]


def _write_xlsx(path: Path, header, rows):
    """A one-sheet ``.xlsx`` written with ``zipfile`` (no openpyxl on the
    card's machine): text as inline strings, numbers, datetimes as serial
    day numbers in Excel's built-in date format 14, None as no cell."""
    import zipfile
    from xml.sax.saxutils import escape

    main = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    rel = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
    pkg = "http://schemas.openxmlformats.org/package/2006/relationships"

    def cell(ref, v):
        if v is None:
            return ""
        if isinstance(v, str):
            return (f'<c r="{ref}" t="inlineStr"><is><t xml:space='
                    f'"preserve">{escape(v)}</t></is></c>')
        if isinstance(v, _dt.datetime):
            days = (v - _dt.datetime(1899, 12, 30)).total_seconds() / 86400
            return f'<c r="{ref}" s="1"><v>{days!r}</v></c>'
        return f'<c r="{ref}"><v>{v!r}</v></c>'

    def col(j):
        return chr(65 + j) if j < 26 else chr(64 + j // 26) + chr(65 + j % 26)

    body = "".join(
        f'<row r="{i}">' + "".join(cell(f"{col(j)}{i}", v)
                                   for j, v in enumerate(r)) + "</row>"
        for i, r in enumerate([list(header)] + list(rows), 1))
    files = {
        "[Content_Types].xml": '<Types xmlns="http://schemas.openxmlformats'
                               '.org/package/2006/content-types"/>',
        "_rels/.rels": f'<Relationships xmlns="{pkg}"><Relationship Id="r1" '
                       f'Type="{rel}/officeDocument" Target="xl/workbook.xml"'
                       '/></Relationships>',
        "xl/workbook.xml": f'<workbook xmlns="{main}" xmlns:r="{rel}"><sheets>'
                           '<sheet name="Reports" sheetId="1" r:id="r1"/>'
                           "</sheets></workbook>",
        "xl/_rels/workbook.xml.rels":
            f'<Relationships xmlns="{pkg}"><Relationship Id="r1" '
            f'Type="{rel}/worksheet" Target="worksheets/sheet1.xml"/>'
            f'<Relationship Id="r2" Type="{rel}/styles" Target="styles.xml"/>'
            "</Relationships>",
        "xl/styles.xml": f'<styleSheet xmlns="{main}"><cellXfs count="2">'
                         '<xf numFmtId="0"/><xf numFmtId="14"/></cellXfs>'
                         "</styleSheet>",
        "xl/worksheets/sheet1.xml": f'<worksheet xmlns="{main}"><sheetData>'
                                    f"{body}</sheetData></worksheet>",
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, text in files.items():
            zf.writestr(name, text)


# a report table pandas wrote with ZSTD bodies, categorical columns and
# several record batches (``tests/test_torch_report_extraction.py``'s
# ``fixture_frame``), and the digest of its cells as pandas reads them
FEATHER_FIXTURE = ROOT / "tests" / "data" / "reports_zstd_categorical.feather"
FEATHER_DIGEST = ("35c891be268c3a09c308667c6af851b0"
                  "ac5afbc5b6efb813f274a680fb9d68f7")
FEATHER_READS = 3  # timed reads of the fixture


def table_digest(table) -> str:
    """sha256 of a ``data/table.py`` Table's names, kinds and cells (as
    text; a missing cell as the empty string)."""
    import hashlib

    from rsuper_tpu_torch.data.table import isna

    cells = [[name, table[name].kind,
              ["" if isna(v) else str(v) for v in table[name].values]]
             for name in table.columns]
    return hashlib.sha256(json.dumps(cells).encode()).hexdigest()


def phase_host_pipelines():
    """The host pipelines, no device: ``report_extraction.run`` with a stub
    client over a seeded CSV of HOST_REPORTS reports for every step of
    ``STEPS``, each postprocessed to its CSV; ``organ_masks.maintenance``
    on synthetic NIfTIs and packed cases (bladder repair of a tree and of
    the stacks, the nnU-Net staging copy, the debug dump);
    ``predict_suborgans``' discovery, resume and sharding; one
    ``SanityDumper`` round. Fails unless every stage writes what it must
    and pandas was never imported. Prints seconds a stage."""
    import numpy as np

    from rsuper_tpu_torch.data.nifti import read_nifti, write_nifti
    from rsuper_tpu_torch.data.table import Table, isna
    from rsuper_tpu_torch.organ_masks import maintenance, predict_suborgans
    from rsuper_tpu_torch.report_extraction import run as extraction
    from rsuper_tpu_torch.utils.debug_dumps import SanityDumper

    t_phase = time.time()
    failures, res = [], {"reports": HOST_REPORTS, "steps": {}}
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        words = ["liver", "mass", "2 cm,", "pancreatic", "\"cyst\"", "\n",
                 "kidney", "normal", "segment 7", "head", "lesion"]
        rows = ["BDMAP_ID,Report Text,Assigned Number,Exam Started Date,"
                "pancreatic cancer timeline"]
        for i in range(HOST_REPORTS):
            text = " ".join(rng.choice(words, int(rng.integers(3, 9))))
            timeline = ("pre-diagnosis", "first positive", "")[i % 3]
            rows.append(f"BDMAP_{i:05d},\"{text.replace(chr(34), 2 * chr(34))}"
                        f"\",{i // 3},20{18 + i % 5}-01-01,{timeline}")
        csv = root / "reports.csv"
        csv.write_text("\n".join(rows) + "\n")
        for step in sorted(extraction.STEPS):
            out = root / "extraction" / step
            t0 = time.time()
            extraction.run_extraction(str(csv), str(out), _StubLLM(),
                                      parts=2, part=0, step=step)
            extraction.run_extraction(str(csv), str(out), _StubLLM(),
                                      parts=2, part=1, step=step)
            extraction.postprocess_answers(str(out), step=step)
            tables = sorted(p.name for p in out.glob("*.csv"))
            answered = sum(1 for p in out.glob("raw_answers_part*.jsonl")
                           for _ in p.open())
            res["steps"][step] = dict(s=time.time() - t0, answered=answered,
                                      csv={t: len(Table.read_csv(
                                          str(out / t))) for t in tables})
            expect = HOST_REPORTS // 3 if step == "time_machine" \
                else HOST_REPORTS
            if answered < expect * 0.9 or not tables:
                failures.append(f"host_pipelines: step {step}: "
                                f"{res['steps'][step]}")
        # the same reports as an .xlsx (dates as date-formatted serial
        # numbers) read back against the .csv
        t0 = time.time()
        table = Table.read_csv(str(csv))
        _write_xlsx(root / "reports.xlsx", list(table.columns),
                    [[None if isna(v) else _dt.datetime.fromisoformat(v)
                      if k == "Exam Started Date" else v
                      for k, v in row.items()] for row in table.rows()])
        got = extraction.read_reports(str(root / "reports.xlsx"),
                                      "Report Text")
        want = extraction.read_reports(str(csv), "Report Text")
        same = list(got.columns) == list(want.columns) and all(
            (isna(a) and isna(b)) or (f"{a:%Y-%m-%d}" if k ==
                                      "Exam Started Date" else a) == b
            for k in want.columns
            for a, b in zip(got[k].values, want[k].values))
        res["xlsx"] = dict(rows=len(got), same_as_csv=same,
                           date_kind=got["Exam Started Date"].kind,
                           s=time.time() - t0)
        if not same or len(got) != len(want) or \
                res["xlsx"]["date_kind"] != "datetime":
            failures.append(f"host_pipelines: the .xlsx reads otherwise "
                            f"than its .csv: {res['xlsx']}")
        # a .feather pandas wrote with ZSTD bodies and categoricals
        ms = []
        for _ in range(FEATHER_READS):
            t0 = time.perf_counter()
            got = extraction.read_reports(str(FEATHER_FIXTURE),
                                          "Report Text")
            ms.append((time.perf_counter() - t0) * 1e3)
        res["feather_zstd_categorical"] = dict(
            rows=len(got), bytes=FEATHER_FIXTURE.stat().st_size,
            read_ms=ms, digest_equal=table_digest(got) == FEATHER_DIGEST,
            kinds={k: got[k].kind for k in got.columns})
        if not res["feather_zstd_categorical"]["digest_equal"]:
            failures.append("host_pipelines: the ZSTD + categorical .feather "
                            "reads otherwise than pandas: "
                            f"{res['feather_zstd_categorical']}")

        # a case with lesions or the no-lesion sentinel has a per-CT row
        answers = extraction._collect_answers(str(root / "extraction" /
                                                  "type_and_size"))
        cases = sum(1 for a in answers.values()
                    if extraction.parse_lesion_answer(a))
        per_ct = res["steps"]["type_and_size"]["csv"]
        if per_ct != {"per_ct.csv": cases, "per_tumor.csv": per_ct.get(
                "per_tumor.csv", 0)} or not 0 < cases < HOST_REPORTS:
            failures.append(f"host_pipelines: type_and_size wrote {per_ct} "
                            f"for {cases} cases")

        # organ-mask maintenance on synthetic NIfTIs and packed cases
        t0 = time.time()
        blob = np.zeros((48, 48, 48), np.uint8)
        blob[8:30, 8:30, 8:30] = 1
        blob[40:44, 40:44, 40:44] = 1  # a detached fragment
        gall = np.zeros_like(blob)
        gall[20:30, 20:30, 20:30] = 1
        ids = []
        for k in range(4):
            seg = root / "tree" / f"BDMAP_{k}" / "segmentations"
            seg.mkdir(parents=True)
            write_nifti(str(seg / "bladder.nii.gz"), blob)
            write_nifti(str(seg / "gall_bladder.nii.gz"), gall)
            write_nifti(str(root / "tree" / f"BDMAP_{k}" / "ct.nii.gz"),
                        rng.normal(size=blob.shape).astype(np.float32))
            write_nifti(str(root / "tree" / f"BDMAP_{k}" /
                            "combined_labels.nii.gz"), blob)
            ids.append(f"BDMAP_{k}")
        (root / "ids.csv").write_text("BDMAP ID\n" + "\n".join(ids) + "\n")
        tree = maintenance.fix_bladder_tree(
            str(root / "tree"), maintenance._read_id_list(
                str(root / "ids.csv")))
        fixed = read_nifti(str(root / "tree" / "BDMAP_0" / "segmentations" /
                                "bladder.nii.gz")).data
        want = blob.astype(bool) & ~gall.astype(bool)
        want[40:44, 40:44, 40:44] = False
        classes = ["background", "bladder", "gall_bladder"]
        (root / "packed").mkdir()
        for k in range(2):
            np.savez_compressed(root / "packed" / f"BDMAP_{k}.npz",
                                image=rng.normal(size=blob.shape)
                                .astype(np.float32),
                                labels=np.packbits(np.stack(
                                    [np.zeros_like(blob), blob, gall]), 0),
                                num_classes=np.int64(3))
        packed = maintenance.fix_bladder_npz(
            sorted(str(p) for p in (root / "packed").glob("*.npz")), classes)
        staged = maintenance.copy_dataset(ids + ["BDMAP_X"],
                                          str(root / "tree"),
                                          str(root / "tree"),
                                          str(root / "nnraw"), workers=4)
        debug = maintenance.npz_to_debug_niis(
            str(root / "packed"), classes, num=2,
            out_root=str(root / "debug"))
        res["maintenance_s"] = time.time() - t0
        res["maintenance"] = dict(
            tree=[s for _, s in tree], packed=[s for _, s in packed],
            staged=staged, debug_files=len(debug))
        if not (all(s == "ok" for _, s in tree + packed) and len(tree) == 4
                and np.array_equal(fixed.astype(bool), want)
                and sum(m.startswith("Copied") for m in staged) == 4
                and len(debug) == 6):
            failures.append(f"host_pipelines: maintenance "
                            f"{res['maintenance']}")

        t0 = time.time()
        src = root / "cts"
        src.mkdir()
        for k in range(10):
            (src / f"BDMAP_{k}.nii.gz").write_bytes(b"x")
        (root / "preds").mkdir()
        (root / "preds" / "BDMAP_3.nii.gz").write_bytes(b"y")
        fi, fo = predict_suborgans.filter_existing_outputs(
            *predict_suborgans.collect_cases(str(src), str(root / "preds")))
        shards = [predict_suborgans.split_files(fi, fo, 4, p)[0]
                  for p in range(4)]
        res["suborgans_s"] = time.time() - t0
        res["suborgan_shards"] = [len(s) for s in shards]
        if sum(shards, []) != fi or len(fi) != 9:
            failures.append(f"host_pipelines: suborgan shards {shards}")

        t0 = time.time()
        dumper = SanityDumper(str(root / "sanity"), limit=1)
        lab = np.zeros((2, 32, 32, 32, 3), np.float32)
        lab[0, 4:9, 4:9, 4:9, 1] = 1
        for _ in range(2):
            dumper.dump({"label": lab, "unk": lab[..., 0]},
                        class_names=["bg", "organ", "lesion"])
        dumped = sorted(p.name for p in (root / "sanity").rglob("*.nii.gz"))
        res["sanity_s"] = time.time() - t0
        res["sanity_files"] = dumped
        if dumped != ["label_organ.nii.gz", "unk_bg.nii.gz"]:
            failures.append(f"host_pipelines: sanity dumps {dumped}")
    res["pandas_imported"] = "pandas" in sys.modules
    if res["pandas_imported"]:
        failures.append("host_pipelines: pandas was imported")
    res["phase_s"] = time.time() - t_phase
    log(json.dumps({"host_pipelines": res}))
    return failures


# ------------------------------------------------------ data parallelism
DDP_STEPS = 3  # steps of each data-parallel training run
DDP_SIZE = 96  # the two-rank runs: the train phase's crops at global batch 2
DDP_TIMEOUT = 420  # seconds a launched rank may take
# (a): the NCCL run within this many times the plain runs' own spread
# (the train phase's 4× rule on a measured noise; `_ddp_cli_world1`)
DDP_NOISE_FACTOR = 4.0
# the float32 check at full width and MID_DEPTH: at full depth one rounding
# of the input moved the seeded model's gradients by ρ = 1.72e-2 on an
# H100, near RHO_MAX
DDP_F32_ARGS = {**MODEL_ARGS, **MID_DEPTH}
DDP_PROBE_TIMEOUT = 90  # seconds the NCCL probe's ranks may take
# a data-parallel step launches rows 1-6 on every rank, and row 8 on the
# rank whose item holds the reported tumours (rank 0: bench.py's item 0)
DDP_TOPN = "topn_threshold_multi_batched"


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextmanager
def _recording_steps():
    """Inside the block, every training step built by ``train/loop.py``
    appends its losses (floats) to the list it yields."""
    from rsuper_tpu_torch.train import loop

    seen, build = [], loop.build_train_step

    def wrapped(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, batch):
            state, losses = step(state, batch)
            seen.append({k: float(v) for k, v in losses.items()})
            return state, losses

        return recorded

    loop.build_train_step = wrapped
    try:
        yield seen
    finally:
        loop.build_train_step = build


def _max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _ddp_cli_world1(root: Path, res: dict, failures: list) -> None:
    """(a) The training CLI as a one-rank NCCL job with ZeRO-1 of the
    optimizer and the EMA copy, against three plain CLI runs of the same
    seed. The first step's losses must be equal, bit for bit (the same
    parameters and batch). Where the three plain runs are bit-equal (the
    resize's backward is a contraction, no atomics), the NCCL run must be
    too; where an op still adds with atomics, later steps differ between
    plain runs in the last bits of the parameters, which bf16 amplifies in
    the losses, and the parameters, the EMA copy and every step's losses of
    the NCCL run must lie within DDP_NOISE_FACTOR times the largest
    distance between two plain runs of the nearest plain run."""
    import torch

    from rsuper_tpu_torch.train.__main__ import main as train_main

    masks, reports, csv = write_cli_cases(root)
    base = ["--preset", PRESET, "--data_root", str(masks), "--report_root",
            str(reports), "--reports", str(csv), "--cp_path",
            str(root / "exp"), "--iter_per_epoch", str(DDP_STEPS),
            "--epochs", "1", "--num_workers", "1",
            "--max_steps", str(DDP_STEPS)]
    job = ["--dist_coordinator", f"127.0.0.1:{_free_port()}",
           "--dist_num_processes", "1", "--dist_process_id", "0",
           "--local_device_ids", "0", "--zero_opt", "--zero_ema"]
    runs = {}
    for name, extra in (("plain", []), ("nccl_zero", job), ("plain2", []),
                        ("plain3", [])):
        t0 = time.time()
        with _recording_steps() as seen:
            state = train_main(base + ["--unique_name", name, *extra])
        torch.cuda.synchronize()
        saved = torch.load(root / "exp" / name / "latest",
                           weights_only=True, map_location="cpu")
        runs[name] = dict(losses=[s["overall"] for s in seen],
                          params=saved["params"], ema=saved["ema_params"],
                          opt=saved["opt_state"], step=state.step,
                          seconds=time.time() - t0,
                          files=sorted(os.listdir(root / "exp" / name)))
        del state
        torch.cuda.empty_cache()

    def apart(a, b):
        return dict(params=_max_abs(a["params"], b["params"]),
                    ema=_max_abs(a["ema"], b["ema"]),
                    losses=max(abs(x - y) for x, y in zip(a["losses"],
                                                          b["losses"])))

    plains = ("plain", "plain2", "plain3")
    pairs = {f"{a}_{b}": apart(runs[a], runs[b])
             for i, a in enumerate(plains) for b in plains[i + 1:]}
    nccl = {p: apart(runs["nccl_zero"], runs[p]) for p in plains}
    spread = {k: max(d[k] for d in pairs.values()) for k in nccl["plain"]}
    nearest = {k: min(d[k] for d in nccl.values()) for k in spread}
    a, b = runs["plain"], runs["nccl_zero"]
    moments = sorted(a["opt"]["state"]) == sorted(b["opt"]["state"]) and all(
        a["opt"]["state"][i][n].shape == v.shape
        for i, st in b["opt"]["state"].items() for n, v in st.items())
    first = {k: v["losses"][0] for k, v in runs.items()}
    plains_equal = all(v == 0 for d in pairs.values() for v in d.values())
    res["nccl_world1"] = dict(
        plain_runs_bit_equal=plains_equal,
        flags=job, steps=DDP_STEPS, crop=list(AUG_CROP), batch=2,
        losses={k: v["losses"] for k, v in runs.items()},
        nccl_vs_plain=nccl, plain_vs_plain=pairs, nearest=nearest,
        spread=spread, noise_factor=DDP_NOISE_FACTOR, bit_equal_to_a_plain_run=any(
            all(v == 0 for v in d.values()) for d in nccl.values()),
        checkpoint_layout_as_plain=moments,
        seconds={k: v["seconds"] for k, v in runs.items()},
        files=b["files"])
    if len(set(first.values())) != 1:
        failures.append(f"ddp (a): first-step losses differ: {first}")
    if plains_equal and not all(v == 0 for v in nccl["plain"].values()):
        failures.append(f"ddp (a): the plain runs are bit-equal, the "
                        f"one-rank NCCL run lies {nccl['plain']} from them")
    for k in () if plains_equal else spread:
        if not nearest[k] <= DDP_NOISE_FACTOR * spread[k]:
            failures.append(f"ddp (a): the one-rank NCCL run's {k} lie "
                            f"{nearest[k]} from the nearest plain run, the "
                            f"plain runs at most {spread[k]} apart")
    if not (b["step"] == a["step"] == DDP_STEPS and moments
            and "metrics.jsonl" in b["files"]):
        failures.append(f"ddp (a): steps {b['step']}, checkpoint layout "
                        f"{moments}, files {b['files']}")


# the decoder's resizes at the preset's 128³ × 2: UpBlockMF_0/1 and _2
# (channels-last, half-pixel), UpBlockMF_3 (channel-first) and the aux
# head (32³ → 128³, 16 classes): (layout, input shape, output size)
DECODER_RESIZES = (("cl", (2, 8, 8, 8, 320), (16, 16, 16)),
                   ("cl", (2, 16, 16, 16, 256), (32, 32, 32)),
                   ("cl", (2, 32, 32, 32, 128), (64, 64, 64)),
                   ("cf", (2, 64, 64, 64, 64), (128, 128, 128)),
                   ("cl", (2, 32, 32, 32, 16), (128, 128, 128)))


def _resize_vjp_dense(g, shape, align_corners: bool):
    """The resize's backward as one float32 matmul an axis with the whole
    (n_out × n_in) ``interp_matrix``: the same transpose as the port's
    taps, for their check and their clock; `g` (B, C, *spatial)."""
    import torch

    from rsuper_tpu_torch.models import layers

    t = g.float()
    for axis, n_in in enumerate(shape, start=2):
        m = layers.interp_matrix(t.shape[axis], n_in, align_corners,
                                 torch.float32, g.device)
        t = (t.movedim(axis, -1) @ m).movedim(-1, axis)
    return t.to(g.dtype)


def _resize_backward_twice(dev, cases=DECODER_RESIZES) -> dict:
    """The port's resize backward (``layers._Resize``: taps, float32
    accumulation) at each of the decoder's shapes (`cases`: the MedFormer
    preset's trilinear ones, or the 2D preset's bilinear ones), in bf16, on
    one seeded input and cotangent: two passes bit-equal; within one bf16
    rounding of the dense contraction (``_resize_vjp_dense``); its ms and
    peak extra memory beside the dense form's and ``F.interpolate``'s own
    backward (atomics: whether it gave the same bits twice is
    recorded)."""
    import torch
    import torch.nn.functional as F

    from rsuper_tpu_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(4)
    out = []

    def clock(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        return dict(ms=time_ms(fn, 5), peak_extra_mib=peak)

    for layout, shape, size in cases:
        nd = len(size)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        if layout == "cf":  # (B, D, C, H, W)
            x = x.permute(0, 1, 4, 2, 3).contiguous()
        fn = (layers.resize_trilinear_cf if layout == "cf"
              else layers.resize_linear)
        perm = ((0, 2, 1, 3, 4) if layout == "cf"
                else (0, nd + 1, *range(1, nd + 1)))
        xa = x.clone().requires_grad_()
        y = fn(xa, size)
        gy = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
        xb = x.clone().requires_grad_()
        yb = F.interpolate(xb.permute(*perm), size=size,
                           mode="trilinear" if nd == 3 else "bilinear",
                           align_corners=False)
        gyb = gy.permute(*perm)
        port = lambda: torch.autograd.grad(  # noqa: E731
            y, xa, gy, retain_graph=True)[0]
        library = lambda: torch.autograd.grad(  # noqa: E731
            yb, xb, gyb, retain_graph=True)[0]
        dense = lambda: _resize_vjp_dense(  # noqa: E731
            gyb, xb.permute(*perm).shape[2:], False)
        p1, p2 = port(), port()
        l1, l2 = library(), library()
        want = dense().permute(*[perm.index(i) for i in range(nd + 2)])
        err = (p1.float() - want.float()).abs()
        bound = 2.0 ** -7 * want.float().abs() + 1e-5 * float(
            want.float().abs().max())
        out.append(dict(
            layout=layout, shape=list(shape), size=list(size),
            port_bit_equal=bool(torch.equal(p1, p2)),
            interpolate_bit_equal=bool(torch.equal(l1, l2)),
            port_vs_dense_max_abs=float(err.max()),
            port_within_a_rounding_of_dense=bool((err <= bound).all()),
            port=clock(port), dense=clock(dense), interpolate=clock(library)))
        del xa, y, xb, yb, p1, p2, l1, l2, want, err, bound
    torch.cuda.empty_cache()
    return out


def _step_determinism(dev) -> dict:
    """One plain bf16 step of the preset's model (128³ × 2, ``remat``)
    twice from the same parameters and batch: the parameters whose
    gradients differ, in the backward's order (the first names the op
    nearest the loss that adds in no fixed order)."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.train import step as tstep

    batch = bench_train.synthetic_batch(SPATIAL_SIZE, 2, device=dev)
    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    grads = []
    for _ in range(2):
        st = bench_train.build_state(dev, True, MODEL_ARGS)
        tstep.gradients(st.model, batch, lmap, LossConfig())
        grads.append({k: p.grad.detach().clone()
                      for k, p in st.model.named_parameters()})
        del st
    torch.cuda.empty_cache()
    names = list(grads[0])[::-1]  # the decoder's end first
    differ = [k for k in names if not torch.equal(grads[0][k], grads[1][k])]
    return dict(parameters=len(names), differing=len(differ),
                first_differing=differ[:8])


def _launch_ranks(role: str, out: Path, timeout: float):
    """Two ``chip_smoke.py --ddp-worker`` processes of `role` on card 0;
    returns each one's exit code (None if it was killed at the timeout)
    and output tail."""
    import subprocess

    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker", role,
         str(r), port, str(out)], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    t_end = time.time() + timeout
    codes, tails = [], []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(1.0, t_end - time.time()))
            codes.append(p.returncode)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            codes.append(None)
        tails.append(text[-3000:])
    return codes, tails


def _ddp_nccl_probe(rank: int, port: str, out: Path) -> int:
    """Two NCCL ranks on card 0: NCCL refuses a communicator with two ranks
    on one device; the error is written down."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    rec = {"rank": rank}
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        rec.update(refused=False, value=t.item())
    except Exception as e:  # the refusal is the expected outcome
        rec.update(refused=True, error=f"{type(e).__name__}: "
                   f"{' '.join(str(e).split())[:400]}")
    (out / f"nccl_probe{rank}.json").write_text(json.dumps(rec))
    sys.stdout.flush()
    os._exit(0)  # a refused communicator is not torn down cleanly


def _clip_batch(size: int, batch: int, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(11)
    return {"image": torch.randn((batch, size, size, size, 1), generator=g,
                                 device=dev).to(torch.bfloat16),
            "report_embedding": torch.randn((batch, CLIP_FEATS), generator=g,
                                            device=dev)}


def _opt_bytes(opt) -> int:
    return sum(v.numel() * v.element_size() for st in opt.opt.state.values()
               for v in st.values() if hasattr(v, "numel") and v.dim())


def _ddp_gloo_rank(rank: int, port: str, out: Path) -> int:
    """One of two gloo ranks on card 0 (CUDA tensors, gloo stages them
    through the host): the float32 step's global losses and averaged
    gradients at the train phase's batch of 2 (this rank's item), then
    DDP_STEPS bf16 steps replicated and DDP_STEPS with ZeRO-1 of the
    optimizer and the EMA copy (ms a step, all-reduce ms and bytes, peak
    memory, optimizer-state bytes, launches), then one CLIP step."""
    import torch
    import torch.distributed as dist

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.parallel import mesh
    from rsuper_tpu_torch.train import optim, state as tstate, step as tstep

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dp = mesh.DataParallel(rank=rank, world=2)
    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    cfg = LossConfig()
    full = bench_train.synthetic_batch(DDP_SIZE, 2, device=dev)
    mine = {k: v[rank:rank + 1] for k, v in full.items()}
    rec = {"rank": rank}

    # float32: the global losses and the averaged gradients
    s32 = bench_train.build_state(dev, False, DDP_F32_ARGS,
                                  dtype=torch.float32)
    mine32 = {**mine, "image": mine["image"].float()}
    losses = tstep.gradients(s32.model, mine32, lmap, cfg, group=dp)
    grads = {k: p.grad.detach() for k, p in s32.model.named_parameters()}
    rec["float32_losses"] = {k: float(v) for k, v in losses.items()}
    rec["float32_grad_sum"] = float(sum(g.double().sum() for g in
                                        grads.values()))
    if rank == 0:
        torch.save({k: g.cpu() for k, g in grads.items()},
                   out / "grads32.pt")
    del s32, grads
    torch.cuda.empty_cache()

    # bf16: the timed steps, replicated then ZeRO-1
    timed = {"ms": 0.0, "bytes": 0, "calls": 0}
    reduce = tstep.all_reduce_mean_

    def timed_reduce(tensors, group, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = reduce(tensors, group, *a, **kw)
        torch.cuda.synchronize()
        timed["ms"] += 1e3 * (time.perf_counter() - t0)
        timed["bytes"] += n
        timed["calls"] += 1
        return n

    tstep.all_reduce_mean_ = timed_reduce
    counted = wrappers()
    for zero in (False, True):
        st = bench_train.build_state(dev, False, MODEL_ARGS)
        if zero:
            axes = mesh.zero_partition(dict(st.model.named_parameters()), 2)
            st = tstate.create_train_state(
                st.model, optim.ZeroOptimizer(st.optimizer,
                                              list(axes.values()), dp),
                dp=dp, zero_ema=True)
        step = tstep.build_train_step(lmap, cfg, group=dp)
        st, _ = step(st, mine)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in counted.values():
            w.launches = 0
        timed.update(ms=0.0, bytes=0, calls=0)
        history, t0 = [], time.perf_counter()
        for _ in range(DDP_STEPS):
            st, ls = step(st, mine)
            history.append({k: float(v) for k, v in ls.items()})
        torch.cuda.synchronize()
        key = "zero" if zero else "replicated"
        rec[key] = dict(
            ms_per_step=1e3 * (time.perf_counter() - t0) / DDP_STEPS,
            all_reduce_ms_per_step=timed["ms"] / DDP_STEPS,
            all_reduce_bytes_per_step=timed["bytes"] / DDP_STEPS,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            optimizer_state_bytes=_opt_bytes(st.optimizer),
            ema_bytes=sum(v.numel() * v.element_size()
                          for v in st.ema_params.values()),
            losses=history,
            launches_per_step={k: w.launches / DDP_STEPS
                               for k, w in counted.items()})
        del st, step
        torch.cuda.empty_cache()
    tstep.all_reduce_mean_ = reduce

    # one CLIP step of the model with its CLIP head
    sc = bench_train.build_state(dev, False, {**MODEL_ARGS, "clip_branch": True,
                                              "clip_feats": CLIP_FEATS})
    cb = _clip_batch(DDP_SIZE, 2, dev)
    step = tstep.build_train_step(lmap, cfg, clip_only=True, group=dp)
    sc, ls = step(sc, {k: v[rank:rank + 1] for k, v in cb.items()})
    rec["clip_losses"] = {k: float(v) for k, v in ls.items()}
    del sc
    dist.barrier()
    dist.destroy_process_group()
    (out / f"gloo{rank}.json").write_text(json.dumps(rec))
    return 0


def _ddp_worker(argv) -> int:
    """``chip_smoke.py --ddp-worker ROLE RANK PORT OUT``: one rank that the
    ddp phase launches."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    role, rank, port, out = argv[0], int(argv[1]), argv[2], Path(argv[3])
    sys.path.insert(0, str(ROOT))
    if role == "nccl_probe":
        return _ddp_nccl_probe(rank, port, out)
    if role == "spatial":
        return _spatial_rank(rank, port, out)
    if role == "spatial_2d":
        return _spatial_2d_rank(rank, port, out)
    return _ddp_gloo_rank(rank, port, out)


def phase_ddp(dev):
    """Data parallelism on the one card: (a) the training CLI as a one-rank
    NCCL job (``--dist_*``, ``--zero_opt``, ``--zero_ema``) at the preset's
    sizes for DDP_STEPS steps against three plain runs of the same seed
    (``_ddp_cli_world1``: the first step's losses bit-equal, then within
    DDP_NOISE_FACTOR times the plain runs' own spread); (b) two ranks on card 0: NCCL's refusal of two ranks on
    one device, written down; two gloo ranks (CUDA tensors, staged through
    the host by gloo) of the train phase's step at global batch 2, one item
    a rank: in float32 (full width, MID_DEPTH) their global losses and
    averaged gradients against one process at batch 2 (losses 1e-4 relative, the Ball Loss's terms at
    the witness's spread where the nudged run moves them; gradients by the
    train phase's per-parameter ρ rule), then DDP_STEPS bf16 steps
    replicated and DDP_STEPS with ZeRO-1 (ms a step, all-reduce ms and
    bytes a step, peak memory and optimizer-state bytes a rank, launches of
    rows 1-6 a rank a step, and of row 8 on rank 0, whose item holds the
    reported tumours; rank 1's has none and skips the Ball Loss's search)
    and one CLIP step; every logged loss equal, bit for bit, on the two
    ranks. gloo's times are not NCCL's. Before (a): the resize's backward
    twice at the decoder's shapes (bit-equal, within a rounding of the dense
    contraction, timed beside it and ``F.interpolate``'s own) and one plain
    step twice (the parameters whose
    gradients differ)."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.train import step as tstep
    from rsuper_tpu_torch.utils.device import card_line

    failures, res = [], {"card": card_line()}
    t_phase = time.time()
    res["resize_backward_twice"] = _resize_backward_twice(dev)
    if not all(r["port_bit_equal"] and r["port_within_a_rounding_of_dense"]
               for r in res["resize_backward_twice"]):
        failures.append(f"ddp: the resize's backward gave other bits on a "
                        f"second pass or left the dense contraction: "
                        f"{res['resize_backward_twice']}")
    res["step_determinism"] = _step_determinism(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _ddp_cli_world1(root / "cli", res, failures)

        out = root / "ranks"
        out.mkdir()
        codes, tails = _launch_ranks("nccl_probe", out, DDP_PROBE_TIMEOUT)
        probe = [json.loads((out / f"nccl_probe{r}.json").read_text())
                 if (out / f"nccl_probe{r}.json").exists()
                 else {"rank": r, "exit": codes[r], "tail": tails[r][-400:]}
                 for r in range(2)]
        res["nccl_two_ranks_one_card"] = probe
        log(json.dumps({"ddp_nccl_probe": probe}))

        t0 = time.time()
        codes, tails = _launch_ranks("gloo", out, DDP_TIMEOUT)
        res["gloo_ranks_s"] = time.time() - t0
        if codes != [0, 0]:
            failures.append(f"ddp (b): the gloo ranks exited {codes}: "
                            + " | ".join(t[-1500:] for t in tails))
            log(json.dumps({"ddp": res}))
            return failures
        ranks = [json.loads((out / f"gloo{r}.json").read_text())
                 for r in range(2)]
        g32 = {k: v.to(dev) for k, v in
               torch.load(out / "grads32.pt", weights_only=True).items()}

    # the one-process reference at batch 2, and one rounding of its input
    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    cfg = LossConfig()
    full = bench_train.synthetic_batch(DDP_SIZE, 2, device=dev)
    full = {**full, "image": full["image"].float()}
    ref = {}
    for key, image in (("ref", full["image"]),
                       ("nudged", _nudge(full["image"], 3, 2.0 ** -22))):
        s32 = bench_train.build_state(dev, False, DDP_F32_ARGS,
                                      dtype=torch.float32)
        losses = tstep.gradients(s32.model, {**full, "image": image}, lmap,
                                 cfg)
        ref[key] = ({k: float(v) for k, v in losses.items()},
                    {k: p.grad.detach().clone()
                     for k, p in s32.model.named_parameters()})
        del s32
    torch.cuda.empty_cache()
    agree, fails = _float32_grads_vs_plain(g32, ref["ref"][1],
                                           ref["nudged"][1],
                                           per_parameter=True)
    failures += [f"ddp (b) float32: {f}" for f in fails]
    got = ranks[0]["float32_losses"]
    terms = {}
    for k, r in ref["ref"][0].items():
        tol = 1e-4 * abs(r)
        moved = abs(ref["nudged"][0][k] - r)
        if k.startswith("ball_loss") and moved > 0:
            tol = max(tol, BF16_NOISE_FACTOR * moved)
        terms[k] = dict(two_ranks=got[k], one_process=r, tol=tol)
        if not abs(got[k] - r) <= tol:
            failures.append(f"ddp (b) float32 loss {k}: {terms[k]}")
    res["float32_vs_one_process"] = dict(size=DDP_SIZE, batch=2,
                                         model_args=DDP_F32_ARGS,
                                         losses=terms, gradients=agree)
    # the ranks' reports: the same bits on both
    same = (ranks[0]["float32_losses"] == ranks[1]["float32_losses"]
            and ranks[0]["float32_grad_sum"] == ranks[1]["float32_grad_sum"]
            and ranks[0]["clip_losses"] == ranks[1]["clip_losses"]
            and all(ranks[0][k]["losses"] == ranks[1][k]["losses"]
                    for k in ("replicated", "zero")))
    if not same:
        failures.append("ddp (b): the two ranks logged different losses")
    for r in ranks:
        for key in ("replicated", "zero"):
            rows = PATH_ROWS + ((DDP_TOPN,) if r["rank"] == 0 else ())
            lost = [k for k in rows
                    if r[key]["launches_per_step"].get(k, 0) <= 0]
            if lost:
                failures.append(f"ddp (b) rank {r['rank']} {key}: {lost} "
                                "not launched")
            if not all(math.isfinite(v) for h in r[key]["losses"]
                       for v in h.values()):
                failures.append(f"ddp (b) rank {r['rank']} {key}: losses "
                                f"{r[key]['losses']}")
        if not math.isfinite(r["clip_losses"]["contrastive_loss"]):
            failures.append(f"ddp (b): CLIP losses {r['clip_losses']}")
    res["gloo_two_ranks"] = dict(
        size=DDP_SIZE, global_batch=2, local_batch=1,
        losses_bit_equal_across_ranks=same,
        ranks=[{k: v for k, v in r.items() if k != "float32_grad_sum"}
               for r in ranks])
    res["seconds"] = time.time() - t_phase
    log(json.dumps({"ddp": res}))
    return failures


SPATIAL_STEPS = 3  # timed steps of the sharded MedFormer, after a warm-up
SPATIAL_RES_STEPS = 2  # timed steps of the sharded ResUNet
SPATIAL_SIZE = 128  # the presets' crops
SPATIAL_TIMEOUT = 420  # seconds a launched rank may take
RESUNET_ARGS = {"base_chan": 32, "block": "BasicBlock", "norm": "in"}
SPATIAL_MBCONV_STEPS = 2  # (e): timed steps of the sharded mf_mbconv
# (f): one float32 step of each other sharded 3D arch at the JAX registry's
# widths, at 64³ × 2: the deepest map (1/16) keeps 2 planes a shard at S = 2
SPATIAL_ZOO_SIZE = 64
SPATIAL_ZOO = {
    "vnet": ("vnet", {}),
    "attention_unet": ("attention_unet", {}),
    "unetpp": ("unetpp", {}),
    "unetr": ("unetr", {"img_size": (SPATIAL_ZOO_SIZE,) * 3}),
    "swin_unetr": ("swin_unetr", {}),
    "nnformer": ("nnformer", {}),
    "vtunet": ("vtunet", {}),
    "unet_mbconv": ("unet", {"block": "MBConv"}),
    # attention in UpBlockMF_2 (gathered, run whole, sharded again) beside
    # the channel-first stem and UpBlockMF_3 on halo slabs, at MID_DEPTH's
    # depths; UpBlockMF_2 takes the 128-wide map of UpBlockMF_1
    "mf_attention_up2": ("medformer", {
        "trans_num": (0, 1, 2, 3, 2, 1, 1, 0), "fusion_depth": 1,
        "chan_num": (64, 128, 256, 320, 256, 128, 128, 32), "remat": False}),
}
# (f): the rows each arch must launch on its rank's planes (> 0 times),
# besides rows 1-6 held against their plain versions at every shape (f)
# launched them at: the MedFormer's channel-first stem and UpBlockMF_3 run
# rows 1-4 and its attention blocks' depthwise projections rows 5-6, the
# MBConv UNet's blocks rows 5-6
SPATIAL_ZOO_ROWS = {"mf_attention_up2": CONV_ROWS + DW_ROWS,
                    "unet_mbconv": DW_ROWS}
# (g): steps of the 2D preset through the CLI on the two ranks, then timed
# steps of its state (after a warm-up)
SPATIAL_2D_CLI_STEPS = 4
SPATIAL_2D_STEPS = 3


def _zoo_step(name, dev, group=None, nudge=False):
    """One float32 ``dice`` step of SPATIAL_ZOO's `name` (seeded weights)
    on ``bench.py``'s batch at SPATIAL_ZOO_SIZE³ × 2 (with `nudge` its
    image moved by one float32 rounding): the loss terms and every
    parameter's gradient; with `group` on the rank's planes, reduced over
    the grid."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.models import get_model, init_params
    from rsuper_tpu_torch.train import step as tstep

    arch, args = SPATIAL_ZOO[name]
    model = init_params(get_model(arch, len(bench_train.CLASSES), args,
                                  dtype=torch.float32), seed=0).to(dev)
    batch = bench_train.synthetic_batch(SPATIAL_ZOO_SIZE, 2, device=dev)
    image = batch["image"].float()
    batch = {**batch, "image": _nudge(image, 3, 2.0 ** -22) if nudge
             else image}
    losses = tstep.gradients(
        model, batch, LesionChannelMap.from_classes(bench_train.CLASSES),
        LossConfig(loss="dice"), group=group)
    return ({k: float(v) for k, v in losses.items()},
            {k: p.grad.detach().clone() for k, p in model.named_parameters()})


def _resunet_state(dev):
    """The ``abdomenatlas/resunet_3d`` preset's model (bf16, seeded) with
    ``bench.py``'s optimizer."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.models import get_model, init_params
    from rsuper_tpu_torch.train import create_train_state, make_optimizer

    model = get_model("resunet", len(bench_train.CLASSES), RESUNET_ARGS,
                      dtype=torch.bfloat16)
    model = init_params(model, seed=0).to(dev).train()
    opt = make_optimizer(model.parameters(), base_lr=6e-4, warmup_epochs=0,
                         max_epochs=100, steps_per_epoch=1000)
    return create_train_state(model, opt)


def _timed_steps(st, steps: int, batch, lmap, cfg, dp, counted) -> dict:
    """`steps` timed steps of a rank of `dp` after a warm-up, then one more
    step with every collective timed between two synchronisations (its ms
    by kind; the timed steps run without those synchronisations): ms a
    step, the collectives by kind, peak memory, launches a step of the
    `counted` wrappers, the losses."""
    import torch

    from rsuper_tpu_torch.parallel import spatial
    from rsuper_tpu_torch.train import step as tstep

    step = tstep.build_train_step(lmap, cfg, group=dp)
    st, _ = step(st, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in counted.values():
        w.launches = 0
    spatial.reset_traffic()
    history, t0 = [], time.perf_counter()
    for _ in range(steps):
        st, ls = step(st, batch)
        history.append({k: float(v) for k, v in ls.items()})
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    traffic = {k: dict(calls=v["calls"] / steps, bytes=v["bytes"] / steps)
               for k, v in spatial.TRAFFIC.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: w.launches / steps for k, w in counted.items()}
    spatial.reset_traffic()
    spatial.TIMED = True
    try:
        t1 = time.perf_counter()
        st, _ = step(st, batch)
        torch.cuda.synchronize()
        clocked = 1e3 * (time.perf_counter() - t1)
    finally:
        spatial.TIMED = False
    for k, v in spatial.TRAFFIC.items():
        traffic[k]["ms_clocked_step"] = v["ms"]
    return dict(steps=steps, ms_per_step=ms, ms_clocked_step=clocked,
                collectives_per_step=traffic, peak_mem_gib=peak,
                launches_per_step=launches, losses=history)


def _spatial_rank(rank: int, port: str, out: Path) -> int:
    """One of two gloo ranks on card 0, a 1 × 2 grid (one data rank, the
    depth split over two): (a) the default MedFormer in bf16 with ``remat``
    at the preset's 128³ crops, global batch 2 (``bench.py``'s batch),
    SPATIAL_STEPS steps after a warm-up: ms a step, the collectives by kind,
    peak memory, launches, the shapes at which rows 1-6 launched; (c) the
    ResUNet preset likewise, SPATIAL_RES_STEPS steps; (b) the float32 step
    at ``MID_DEPTH``, 96³ × 2: the global losses and reduced gradients;
    (e) ``mf_mbconv`` as (a), SPATIAL_MBCONV_STEPS steps; (f) one float32
    step of each arch of SPATIAL_ZOO (``_zoo_step``): its losses, launches
    of rows 1-6, and rank 0's reduced gradients, and the shapes at which
    rows 1-6 launched in (f)."""
    import torch
    import torch.distributed as dist

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.parallel import mesh
    from rsuper_tpu_torch.train import step as tstep

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dp = mesh.grid(2)
    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    cfg = LossConfig()
    rec = {"rank": rank, "place": [dp.rank, dp.world, dp.spatial.rank,
                                   dp.spatial.size]}
    counted = wrappers()
    batch = bench_train.synthetic_batch(SPATIAL_SIZE, 2, device=dev)

    def timed_steps(key, st, steps):
        rec[key] = _timed_steps(st, steps, batch, lmap, cfg, dp, counted)

    with _launch_shapes() as shapes:
        timed_steps("medformer", bench_train.build_state(
            dev, True, MODEL_ARGS), SPATIAL_STEPS)
    rec["shapes"] = {k: sorted(v) for k, v in shapes.items()}
    torch.cuda.empty_cache()
    timed_steps("resunet", _resunet_state(dev), SPATIAL_RES_STEPS)
    torch.cuda.empty_cache()

    s32 = bench_train.build_state(dev, False, DDP_F32_ARGS,
                                  dtype=torch.float32)
    b32 = bench_train.synthetic_batch(DDP_SIZE, 2, device=dev)
    b32 = {**b32, "image": b32["image"].float()}
    losses = tstep.gradients(s32.model, b32, lmap, cfg, group=dp)
    grads = {k: p.grad.detach() for k, p in s32.model.named_parameters()}
    rec["float32_losses"] = {k: float(v) for k, v in losses.items()}
    rec["float32_grad_sum"] = float(sum(g.double().sum()
                                        for g in grads.values()))
    if rank == 0:
        torch.save({k: g.cpu() for k, g in grads.items()},
                   out / "spatial_grads32.pt")
    del s32, b32, grads
    torch.cuda.empty_cache()

    with _launch_shapes() as shapes:
        timed_steps("mf_mbconv", bench_train.build_state(
            dev, True, MF_VARIANTS["mf_mbconv"]), SPATIAL_MBCONV_STEPS)
    rec["mf_mbconv_shapes"] = {k: sorted(v) for k, v in shapes.items()}
    torch.cuda.empty_cache()

    rec["zoo"] = {}
    zoo_shapes = {}
    for name in SPATIAL_ZOO:
        for w in counted.values():
            w.launches = 0
        with _launch_shapes() as shapes:
            losses, grads = _zoo_step(name, dev, group=dp)
        for k, v in shapes.items():
            zoo_shapes.setdefault(k, set()).update(v)
        rec["zoo"][name] = dict(
            losses=losses, launches={k: w.launches
                                     for k, w in counted.items()},
            grad_sum=float(sum(g.double().sum() for g in grads.values())))
        if rank == 0:
            torch.save({k: g.cpu() for k, g in grads.items()},
                       out / f"zoo_{name}.pt")
        del grads
        torch.cuda.empty_cache()
    rec["zoo_shapes"] = {k: sorted(v) for k, v in zoo_shapes.items()}
    dist.barrier()
    mesh.forget_grids()
    dist.destroy_process_group()
    (out / f"spatial{rank}.json").write_text(json.dumps(rec))
    return 0


def _dim2_preset_state(dev):
    """The ``slices/resunet_2d`` preset's model (bf16, seeded) with the
    preset's AdamW and EMA, as the loop builds them."""
    import torch

    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.train import create_train_state, make_optimizer

    cfg = load_config(DIM2_PRESET)
    model = _dim2_model("resunet_2d", dev, torch.bfloat16).train()
    opt = make_optimizer(
        model.parameters(), cfg.optimizer, cfg.base_lr, cfg.warmup_epochs,
        cfg.epochs, cfg.iter_per_epoch, cfg.weight_decay, cfg.betas,
        clip_norm=cfg.clip_norm)
    return create_train_state(model, opt, ema=cfg.ema)


def _spatial_2d_rank(rank: int, port: str, out: Path) -> int:
    """(g) and (h) on one of two gloo ranks of card 0, a 1 × 2 grid that
    splits the rows of every slice: (g) the ``slices/resunet_2d`` preset
    through the training CLI (``main``, which joins this rank's job) with
    ``--spatial_shard 2`` at its 256² × 2 for SPATIAL_2D_CLI_STEPS steps
    on ``write_cli_cases``' CT-Mask cases (OUT/cli): its logged losses, its
    phase times and the collectives a step; then SPATIAL_2D_STEPS timed
    steps of the preset's state on ``_slice_batch`` (``_timed_steps``);
    (h) one float32 ``dice`` step of each 2D arch (``_dim2_step``, the
    depths of DIM2_CUT): its losses and rank 0's reduced gradients."""
    import torch
    import torch.distributed as dist

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.config import load_config
    from rsuper_tpu_torch.losses import LesionChannelMap
    from rsuper_tpu_torch.parallel import mesh, spatial
    from rsuper_tpu_torch.train.__main__ import main as train_main

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dp = mesh.grid(2)
    rec = {"rank": rank, "place": [dp.rank, dp.world, dp.spatial.rank,
                                   dp.spatial.size]}
    n = SPATIAL_2D_CLI_STEPS
    spatial.reset_traffic()
    t0 = time.time()
    state = train_main([
        "--preset", DIM2_PRESET, "--data_root", str(out / "cli" / "masks"),
        "--cp_path", str(out / "exp"), "--unique_name", "dim2_sp",
        "--spatial_shard", "2", "--all_train", "--iter_per_epoch", str(n),
        "--epochs", "1", "--max_steps", str(n)])
    torch.cuda.synchronize()
    recs = [json.loads(line) for line in (
        out / "exp" / "dim2_sp" / f"metrics.rank{rank}.jsonl").open()]
    phases = [r for r in recs if "phase/step_ms" in r][-1]
    rec["cli"] = dict(
        steps=state.step, seconds=time.time() - t0,
        losses=[{k: v for k, v in r.items() if k.startswith("train/")}
                for r in recs if "train/overall" in r],
        ms_per_iteration=phases["phase/iteration_median_ms"],
        step_call_ms=phases["phase/step_median_ms"],
        loader_wait_ms=phases["phase/load_median_ms"],
        collectives_per_step={k: dict(calls=v["calls"] / n,
                                      bytes=v["bytes"] / n)
                              for k, v in spatial.TRAFFIC.items()})
    del state
    torch.cuda.empty_cache()
    rec["preset"] = _timed_steps(
        _dim2_preset_state(dev), SPATIAL_2D_STEPS,
        _slice_batch(DIM2_SIZE, 2, dev),
        LesionChannelMap.from_classes(bench_train.CLASSES),
        load_config(DIM2_PRESET).loss_config(), dp, wrappers())
    torch.cuda.empty_cache()
    rec["archs"] = {}
    for arch in DIM2_ARCHS:
        losses, grads = _dim2_step(arch, dev, group=dp, cut=True)
        rec["archs"][arch] = dict(
            losses=losses,
            grad_sum=float(sum(g.double().sum() for g in grads.values())))
        if rank == 0:
            torch.save({k: g.cpu() for k, g in grads.items()},
                       out / f"dim2_{arch}.pt")
        del grads
        torch.cuda.empty_cache()
    dist.barrier()
    mesh.forget_grids()
    dist.destroy_process_group()
    (out / f"spatial_2d{rank}.json").write_text(json.dumps(rec))
    return 0


def _spatial_2d_vs_one_process(dev, ranks, grads, failures) -> dict:
    """(g) and (h) held: the CLI's steps taken and every logged loss finite
    and bit-equal on the two ranks; the timed steps' losses bit-equal, and
    one process's ms a step and peak memory at the same batch beside a
    rank's; each arch's two-rank float32 step against one process (losses
    1e-4 relative, gradients by (b)'s ρ rule)."""
    import torch

    from rsuper_tpu_torch.config import load_config

    for r in ranks:
        cli = r["cli"]
        if cli["steps"] != SPATIAL_2D_CLI_STEPS or not cli["losses"] or not \
                all(math.isfinite(v) for h in cli["losses"] + r["preset"][
                    "losses"] for v in h.values()):
            failures.append(f"spatial (g) rank {r['rank']}: steps "
                            f"{cli['steps']}, losses {cli['losses']}, "
                            f"{r['preset']['losses']}")
    same = all(ranks[0][k]["losses"] == ranks[1][k]["losses"]
               for k in ("cli", "preset")) and all(
        ranks[0]["archs"][a] == ranks[1]["archs"][a] for a in DIM2_ARCHS)
    if not same:
        failures.append("spatial (g), (h): the two ranks logged different "
                        "losses")
    one = _one_process_step(dev, _dim2_preset_state(dev), SPATIAL_2D_STEPS,
                            _slice_batch(DIM2_SIZE, 2, dev),
                            load_config(DIM2_PRESET).loss_config())
    torch.cuda.empty_cache()
    preset = dict(
        size=DIM2_SIZE, global_batch=2, grid="1x2",
        losses_bit_equal_across_ranks=same,
        ranks=[dict(rank=r["rank"], place=r["place"], cli=r["cli"],
                    **r["preset"]) for r in ranks],
        one_process=one,
        peak_mem_rank_over_one_process=[
            r["preset"]["peak_mem_gib"] / one["peak_mem_gib"]
            for r in ranks])
    archs = {}
    for arch in DIM2_ARCHS:
        got = {k: v.to(dev) for k, v in grads.pop(arch).items()}
        ref_losses, ref = _dim2_step(arch, dev, cut=True)
        _, moved = _dim2_step(arch, dev, nudge=True, cut=True)
        agree, fails = _float32_grads_vs_plain(got, ref, moved,
                                               per_parameter=True)
        failures += [f"spatial (h) {arch}: {f}" for f in fails]
        terms = {}
        for k, v in ref_losses.items():
            g = ranks[0]["archs"][arch]["losses"][k]
            terms[k] = dict(two_ranks=g, one_process=v, tol=1e-4 * abs(v))
            if not abs(g - v) <= 1e-4 * abs(v):
                failures.append(f"spatial (h) {arch} loss {k}: {terms[k]}")
        archs[arch] = dict(depths=DIM2_CUT.get(arch), losses=terms,
                           gradients=agree)
        del got, ref, moved
        torch.cuda.empty_cache()
    return dict(dim2_preset=preset, dim2_archs_vs_one_process=dict(
        size=DIM2_SIZE, batch=2, loss="dice", archs=archs))


def _one_process_step(dev, state, steps: int = 1, batch=None, cfg=None):
    """ms a step and peak memory of one process at the phase's batch (or
    `batch`, with the loss `cfg`)."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.train import step as tstep

    if batch is None:
        batch = bench_train.synthetic_batch(SPATIAL_SIZE, 2, device=dev)
    step = tstep.build_train_step(
        LesionChannelMap.from_classes(bench_train.CLASSES),
        cfg or LossConfig())
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return dict(ms_per_step=1e3 * (time.perf_counter() - t0) / steps,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_spatial(dev):
    """Spatial sharding on the one card: two gloo ranks (CUDA tensors,
    staged through the host; NCCL refuses two ranks on one card, see the
    ddp phase) in a 1 × 2 grid split every volume's depth
    (``_spatial_rank``): (a) the default MedFormer, bf16, ``remat``, 128³ ×
    2: ms a step a rank, collective ms and bytes a step by kind, peak
    memory a rank against one process at the same batch, launches of rows
    1-6 and 8 a rank a step (each > 0); (b) float32 at ``MID_DEPTH``, 96³
    × 2: the global losses (1e-4 relative, the Ball Loss's terms at the
    witness's spread where the nudged run moves them) and gradients against
    one process by the per-parameter ρ rule; (c) the ResUNet preset at
    128³ × 2 with the same lines (row 8 > 0); (d) rows 1-6 against their
    plain versions at every halo-slab shape (a) launched them at; (e)
    ``mf_mbconv`` (``MF_VARIANTS``) at the default widths, bf16, ``remat``,
    128³ × 2, with (a)'s lines (rows 5-6 and 8 > 0) and rows 5-6 against
    their plain versions at every shape it launched them at; (f) one float32
    ``dice`` step of every arch of SPATIAL_ZOO at 64³ × 2 against one
    process (losses 1e-4 relative, gradients by (b)'s ρ rule), the rows
    of SPATIAL_ZOO_ROWS launched on both ranks and rows 1-6 against their
    plain versions at every shape (f) launched them at; (g) the 2D pathway
    (``_spatial_2d_rank``, the rows split over the two ranks): the
    ``slices/resunet_2d`` preset through the training CLI with
    ``--spatial_shard 2`` at 256² × 2, then timed: ms a step a rank, the
    collectives' ms and bytes a step by kind, peak memory a rank against
    one process at the same batch, the launches of rows 1-8 (none on this
    path); (h) one float32 ``dice`` step of every 2D arch at the registry's
    widths (the 2D MedFormer's depth cut, DIM2_CUT) at 256² × 2 against
    one process (losses 1e-4 relative, gradients by (b)'s ρ rule). Every logged loss bit-equal on the two
    ranks. gloo's times are not NCCL's."""
    import torch

    from rsuper_tpu_torch import bench_train
    from rsuper_tpu_torch.losses import LesionChannelMap, LossConfig
    from rsuper_tpu_torch.train import step as tstep
    from rsuper_tpu_torch.utils.device import card_line

    failures, res = [], {"card": card_line()}
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        t0 = time.time()
        codes, tails = _launch_ranks("spatial", out, SPATIAL_TIMEOUT)
        res["ranks_s"] = time.time() - t0
        if codes != [0, 0]:
            failures.append(f"spatial: the gloo ranks exited {codes}: "
                            + " | ".join(t[-1500:] for t in tails))
            log(json.dumps({"spatial": res}))
            return failures
        ranks = [json.loads((out / f"spatial{r}.json").read_text())
                 for r in range(2)]
        g32 = {k: v.to(dev) for k, v in torch.load(
            out / "spatial_grads32.pt", weights_only=True).items()}
        zoo_grads = {name: torch.load(out / f"zoo_{name}.pt",
                                      weights_only=True)
                     for name in SPATIAL_ZOO}

    # (b) the one-process float32 reference at batch 2, and one rounding
    lmap = LesionChannelMap.from_classes(bench_train.CLASSES)
    cfg = LossConfig()
    full = bench_train.synthetic_batch(DDP_SIZE, 2, device=dev)
    full = {**full, "image": full["image"].float()}
    ref = {}
    for key, image in (("ref", full["image"]),
                       ("nudged", _nudge(full["image"], 3, 2.0 ** -22))):
        s32 = bench_train.build_state(dev, False, DDP_F32_ARGS,
                                      dtype=torch.float32)
        losses = tstep.gradients(s32.model, {**full, "image": image}, lmap,
                                 cfg)
        ref[key] = ({k: float(v) for k, v in losses.items()},
                    {k: p.grad.detach().clone()
                     for k, p in s32.model.named_parameters()})
        del s32
    torch.cuda.empty_cache()
    agree, fails = _float32_grads_vs_plain(g32, ref["ref"][1],
                                           ref["nudged"][1],
                                           per_parameter=True)
    failures += [f"spatial (b) float32: {f}" for f in fails]
    terms = {}
    for k, r in ref["ref"][0].items():
        tol = 1e-4 * abs(r)
        moved = abs(ref["nudged"][0][k] - r)
        if k.startswith("ball_loss") and moved > 0:
            tol = max(tol, BF16_NOISE_FACTOR * moved)
        got = ranks[0]["float32_losses"][k]
        terms[k] = dict(two_ranks=got, one_process=r, tol=tol)
        if not abs(got - r) <= tol:
            failures.append(f"spatial (b) float32 loss {k}: {terms[k]}")
    res["float32_vs_one_process"] = dict(size=DDP_SIZE, batch=2,
                                         model_args=DDP_F32_ARGS,
                                         losses=terms, gradients=agree)
    del g32, ref

    # one process at the same batch: ms a step and peak memory
    res["one_process"] = {
        "medformer": _one_process_step(dev, bench_train.build_state(
            dev, True, MODEL_ARGS)),
        "resunet": _one_process_step(dev, _resunet_state(dev)),
        "mf_mbconv": _one_process_step(dev, bench_train.build_state(
            dev, True, MF_VARIANTS["mf_mbconv"]))}
    torch.cuda.empty_cache()

    # (d), (e) rows 1-6 at the halo-slab shapes the sharded steps launched
    gen = torch.Generator(device=dev).manual_seed(5)
    slab_rows = {}
    for part, key, want in (("d", "shapes", PATH_ROWS),
                            ("e", "mf_mbconv_shapes", DW_ROWS),
                            ("f", "zoo_shapes", PATH_ROWS)):
        shapes = {}
        for r in ranks:
            for name, seen in r[key].items():
                shapes.setdefault(name, set()).update(
                    (tuple(s), dt) for s, dt in seen)
        slab_rows[part] = [
            _row_at_shape(name, shape, dt, gen, dev)
            for name in PATH_ROWS for shape, dt in sorted(shapes.get(name,
                                                                     ()))]
        torch.cuda.empty_cache()
        missing = [n for n in want if not shapes.get(n)]
        if missing:
            failures.append(f"spatial ({part}): {missing} launched at no "
                            "shape")
        for row in slab_rows[part]:
            if not row["ok"]:
                failures.append(f"spatial ({part}): {row}")

    # (f) every other sharded arch against one process, float32
    zoo = {}
    for name in SPATIAL_ZOO:
        got = {k: v.to(dev) for k, v in zoo_grads.pop(name).items()}
        ref_losses, ref = _zoo_step(name, dev)
        _, moved = _zoo_step(name, dev, nudge=True)
        agree, fails = _float32_grads_vs_plain(got, ref, moved,
                                               per_parameter=True)
        failures += [f"spatial (f) {name}: {f}" for f in fails]
        terms = {}
        for k, r in ref_losses.items():
            v = ranks[0]["zoo"][name]["losses"][k]
            terms[k] = dict(two_ranks=v, one_process=r, tol=1e-4 * abs(r))
            if not abs(v - r) <= 1e-4 * abs(r):
                failures.append(f"spatial (f) {name} loss {k}: {terms[k]}")
        zoo[name] = dict(arch=SPATIAL_ZOO[name][0], losses=terms,
                         gradients=agree,
                         launches=ranks[0]["zoo"][name]["launches"])
        for r in ranks:
            lost = [k for k in SPATIAL_ZOO_ROWS.get(name, ())
                    if r["zoo"][name]["launches"].get(k, 0) <= 0]
            if lost:
                failures.append(f"spatial (f) {name} rank {r['rank']}: "
                                f"{lost} not launched")
        del got, ref, moved
        torch.cuda.empty_cache()
    res["zoo_vs_one_process"] = dict(size=SPATIAL_ZOO_SIZE, batch=2,
                                     loss="dice", archs=zoo)

    same = (ranks[0]["float32_losses"] == ranks[1]["float32_losses"]
            and ranks[0]["float32_grad_sum"] == ranks[1]["float32_grad_sum"]
            and all(ranks[0][k]["losses"] == ranks[1][k]["losses"]
                    for k in ("medformer", "resunet", "mf_mbconv"))
            and all(ranks[0]["zoo"][n]["losses"] == ranks[1]["zoo"][n][
                "losses"] and ranks[0]["zoo"][n]["grad_sum"] == ranks[1][
                    "zoo"][n]["grad_sum"] for n in SPATIAL_ZOO))
    if not same:
        failures.append("spatial: the two ranks logged different losses")
    for r in ranks:
        for key, part, rows_yes in (
                ("medformer", "a", PATH_ROWS + (DDP_TOPN,)),
                ("resunet", "c", (DDP_TOPN,)),
                ("mf_mbconv", "e", DW_ROWS + (DDP_TOPN,))):
            lost = [k for k in rows_yes
                    if r[key]["launches_per_step"].get(k, 0) <= 0]
            if lost:
                failures.append(f"spatial ({part}) rank {r['rank']}: {lost} "
                                "not launched")
            if not all(math.isfinite(v) for h in r[key]["losses"]
                       for v in h.values()):
                failures.append(f"spatial rank {r['rank']} {key}: losses "
                                f"{r[key]['losses']}")
    # (g), (h) the 2D pathway, its rows over the two ranks
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        write_cli_cases(out / "cli")
        t0 = time.time()
        codes, tails = _launch_ranks("spatial_2d", out, SPATIAL_TIMEOUT)
        res["ranks_2d_s"] = time.time() - t0
        if codes != [0, 0]:
            failures.append(f"spatial (g): the gloo ranks exited {codes}: "
                            + " | ".join(t[-1500:] for t in tails))
        else:
            ranks2d = [json.loads((out / f"spatial_2d{r}.json").read_text())
                       for r in range(2)]
            grads2d = {a: torch.load(out / f"dim2_{a}.pt",
                                     weights_only=True) for a in DIM2_ARCHS}
    if codes == [0, 0]:
        res.update(_spatial_2d_vs_one_process(dev, ranks2d, grads2d,
                                              failures))
    res.update(
        size=SPATIAL_SIZE, global_batch=2, grid="1x2",
        losses_bit_equal_across_ranks=same,
        ranks=[{k: v for k, v in r.items()
                if k not in ("shapes", "mf_mbconv_shapes", "zoo_shapes",
                             "float32_grad_sum", "zoo")} for r in ranks],
        halo_slab_rows=slab_rows["d"], mf_mbconv_halo_slab_rows=slab_rows["e"],
        zoo_halo_slab_rows=slab_rows["f"],
        seconds=time.time() - t_phase)
    log(json.dumps({"spatial": res}))
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
    failures += phase_loop(dev)
    torch.cuda.empty_cache()
    fails, full_step_ops = phase_train_cli(dev)
    failures += fails
    failures += phase_clip(dev, full_step_ops)
    failures += phase_validate(dev)
    torch.cuda.empty_cache()
    failures += phase_zoo(dev)
    torch.cuda.empty_cache()
    failures += phase_dim2(dev)
    failures += phase_mf_variants(dev)
    torch.cuda.empty_cache()
    failures += phase_genesis(dev)
    torch.cuda.empty_cache()
    fails, phantom_rows = phase_phantom(dev)
    failures += fails
    rows += phantom_rows
    failures += phase_host_pipelines()
    torch.cuda.empty_cache()
    failures += phase_ddp(dev)
    torch.cuda.empty_cache()
    failures += phase_spatial(dev)
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
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(_ddp_worker(sys.argv[2:]))
    sys.exit(main())
