#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, one card

Phases, in order (any failure exits non-zero):

1. build   — nvcc builds every kernel of ``rsuper_tpu_torch/csrc`` for
             sm_90a, one process per source, all at once;
2. kernels — each kernel against its plain PyTorch version at the shapes the
             serving path gives it, in bf16 and float32, with the stated
             tolerance; times of the kernel, the plain version and the
             library call, and the kernel's bound;
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
             plain versions.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. It imports nothing of JAX or of
``rsuper_tpu``, and exits non-zero without CUDA or without the
``rsuper_tpu_torch`` package beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CLASSES = [  # the 16 classes of bench.py
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
MODEL_ARGS: dict = {}  # MedFormer's default configuration


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


# ------------------------------------------------------------ kernel cases
# (name, route source, TPU kernel it replaces, shapes at 96³ windows, batch 8)
CONV_SHAPES = {  # (B, D, Ci, H, W, Co)
    "conv3x3x3_cf": [(8, 96, 1, 96, 96, 32)],
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
}


def _err(got, ref):
    import torch

    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        return math.inf, 0.0
    return (g - r).abs().max().item(), r.abs().max().item()


def phase_kernels(reps: int):
    import torch
    import torch.nn.functional as F

    from rsuper_tpu_torch.ops import conv_cf, dwconv
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, failures = [], []

    def case(name, fn, args, ref_args, flops, nbytes, library, dtype, shape):
        got = fn(*args)
        with plain_on_device():
            ref = fn(*ref_args)
        torch.cuda.synchronize()
        err, mx = _err(got, ref)
        tol = TOL[dtype] * (1.0 + mx)
        ok = err <= tol
        row = dict(name=name, dtype=dtype, shape=list(shape),
                   max_abs_err=err, tol=tol, ok=ok)
        if dtype == "bfloat16":  # timings in the serving path's type
            row["ms"] = time_ms(lambda: fn(*args), reps)
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
                if name == "in_relu_conv3x3x3_cf":
                    # no library call fuses the norm: F.conv3d times the
                    # conv alone, a yardstick kept out of library_ms
                    lib = ("F.conv3d (cuDNN) of the conv alone, no norm",
                           lib[1])
                    flops += 3.0 * x.numel()
                case(name, fn, (x, w), (x, w), flops, nbytes, lib, dname,
                     (B, D, Ci, H, W, Co))
                del x, w
        for (B, D, H, W, C) in DW_SHAPES:
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
                 (x, w), flops, nbytes, lib, dname, (B, D, H, W, C))
            del x, w
    return rows, failures


def kernels_line(rows, launches):
    """One entry per kernel: its error is the largest over the production
    shapes in bf16; its times are those of its heaviest production shape."""
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["name"] == name
                and r["dtype"] == "bfloat16"]
        top = max(mine, key=lambda r: r["bound_ms"])
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"],
            library_ms=(None if name == "in_relu_conv3x3x3_cf"
                        else top["library_ms"]),
            shape=top["shape"]))
    return {"kernels": out}


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


def _profile(fn, top: int = 25):
    """Device time of one call by operator (torch.profiler), the busy share
    of the call's wall time, and the `top` operators by device time."""
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
        if ev.device_type == DeviceType.CPU:
            continue  # an operator's device time is its kernels' rows too
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms if wall_ms else None,
                top=[dict(ms=ms, calls=n, name=k[:90])
                     for ms, n, k in rows[:top]])


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
    predict_folder asks for them) and through the plain versions; blended float32 probabilities against the plain
    versions."""
    import numpy as np
    import torch

    from rsuper_tpu_torch.data.nifti import read_nifti, write_nifti
    from rsuper_tpu_torch.data.preprocess import clip_and_normalize
    from rsuper_tpu_torch.inference.predict import (predict_folder,
                                                    predict_masks_volume,
                                                    preprocess_volume)
    from rsuper_tpu_torch.inference.sliding_window import (
        _grid, sliding_window_probs_device)
    from rsuper_tpu_torch.ops import conv_cf, dwconv
    from rsuper_tpu_torch.ops.dispatch import plain_on_device

    ct = phantom_ct(edge)
    fn = _model_fn(model)
    wrappers = {"conv3x3x3_cf": conv_cf.conv3x3x3_cf,
                "in_relu_conv3x3x3_cf": conv_cf.in_relu_conv3x3x3_cf,
                "depthwise_conv3x3x3": dwconv.depthwise_conv3x3x3}
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
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        done = predict_folder([fn], src, dst, CLASSES, window=win,
                              batch=8, save_probabilities=True, device=dev)
        torch.cuda.synchronize()
        res["predict_folder_s"] = time.time() - t0
        res["launches"] = {k: w.launches for k, w in wrappers.items()}
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

    log(card_line())
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": torch.cuda.get_device_name(0)}))
    t0 = time.time()
    names = _build.build_all()
    log(json.dumps({"build": names, "seconds": time.time() - t0}))
    rows, failures = phase_kernels(REPS)
    dev = torch.device("cuda")
    model, model32 = _build_models(dev)
    failures += phase_model(model, model32, dev, REPS)
    fails, launches = phase_predict(model, model32, dev, VOLUME)
    failures += fails
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
