#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, one card

Phases, in order (any failure exits non-zero):

1. build   — nvcc builds every kernel of ``rsuper_tpu_torch/csrc`` for
             sm_90a, one process per source, all at once; what
             ``-Xptxas -v`` reports for the conv and depthwise kernels
             (registers, spills, static shared memory) is printed, one line
             a source;
2. kernels — each kernel against its plain PyTorch version at the shapes the
             serving path (forward, window batches of 8) and the training
             step (backward, batch 1) give it, in bf16 and float32, with the
             stated tolerance; times of the kernel, the plain version and
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
             backward also through the autograd Function). The two top-N bisection kernels at the Ball Loss's
             shapes: thresholds and masks equal to the plain version's;
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
5. train   — training steps of the default MedFormer on ``bench.py``'s
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
             ``loss="dice"`` step beside it.

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
from contextlib import contextmanager
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
# batched kernel, the first being the training step's shape; (V, K) for the
# single volume
TOPN_SHAPES = [(1, 96 ** 3, 3), (2, 96 ** 3, 3), (1, 128 ** 3, 3),
               (2, 4099, 2)]
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
             function=None):
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
        for name, shapes in CONV_SHAPES.items():
            fn = getattr(conv_cf, name)
            for (B, D, Ci, H, W, Co) in shapes:
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
                     no_prologue=alone, device=Ci == 1)
                del x, w
        for (B, D, H, W, C) in DW_FWD_SHAPES:
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
                 device=True)
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
    volume (negatives), the ball volume with its last item all zero, and the
    ball volume with a target above the positive count. The bound is the larger of the volume read
    once and iters·K + 1 compares a value. ``library_ms`` times one
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
                ("n_above_the_positive_count", x, above)]

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
    for (B, D, H, W, C) in DW_BWD_SHAPES:
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
             (B, D, H, W, C), device=True, function=(function, forward))
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
    shapes in the path's type (the timed rows: bf16, float32 for top-N); its
    times are those of its heaviest production shape, for top-N those of the
    training step's shape."""
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["name"] == name and "ms" in r]
        top = max([r for r in mine if r.get("on_path")] or mine,
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
    is exact on one in-order stream."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def _train_losses_and_grads(state, batch, lmap, cfg):
    """One forward and backward from `state` (no update): every loss term as
    a float, every parameter's gradient, and the Ball Loss's trace."""
    from rsuper_tpu_torch.train import loss_fn

    state.model.zero_grad(set_to_none=True)
    with _ball_trace() as trace:
        overall, losses = loss_fn(state.model, batch, lmap, cfg)
    overall.backward()
    grads = {k: p.grad.detach().clone()
             for k, p in state.model.named_parameters()}
    state.model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads, trace


def _kernels_vs_plain(dev, margs, batch, lmap, cfg):
    """Losses and gradients of one forward and backward through the kernels
    against the plain versions, from the same seeded state.

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
        if not plain:
            return _train_losses_and_grads(state, b, lmap, cfg)
        with plain_on_device():
            return _train_losses_and_grads(state, b, lmap, cfg)

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
    """The Ball Loss of the same logits through the top-N kernel and through
    its plain version: nothing else differs, so ball centres, pseudo-masks
    and loss values must be equal (losses to 1e-6 relative: the same
    operations on the same masks)."""
    import torch

    from rsuper_tpu_torch.losses import ball_loss
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    with torch.no_grad():
        logits = state.model(batch["image"])["segmentation"][0]

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
    for name in ("conv_cf", "conv_cf_wgrad", "dwconv", "dwconv_bwd"):
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
    fails, train_launches = phase_train(dev, TRAIN_STEPS)
    failures += fails
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
