#!/usr/bin/env python
"""Device-trace attribution of whole-volume prediction: the counterpart of
the JAX package's ``tools/profile_infer.py``.

    python -m rsuper_tpu_torch.profile_infer [--edge 256] [--window 96]
        [--batch 4] [--model_args_json JSON] [--out DIR] [--device cpu]

Default MedFormer (``bench_train.CLASSES``' 16 classes, bf16 compute,
``init_params(..., 0)``) on a seeded N(0, 1) volume of edge³ voxels,
window³ windows with half overlap in batches of `batch`, through
``sliding_window_inference``. After one warm call (the kernels' build
included), one more prediction runs under ``torch.profiler``; the profiler
starts one call early and drops it, because the first device records after
it starts can be lost. Forward pre- and post-hooks on the model and on each
of its named children open and close ``record_function`` ranges of their
names, so every device operation is attributed to the child that launched
it, to the model outside its children (the aux head's resize, the layout
moves), or to nothing of the model (the window weighting and blending).

Prints the per-op totals and the per-module totals, as the JAX tool does,
then one JSON line: ``card``, ``device_ms_total``, ``events``, ``top_ops``,
``modules``, ``outside_model_ms``, ``wall_ms``. The Chrome trace is written
to ``<out>/trace.json``. Runs on CUDA unless ``--device cpu`` is given; on
the CPU the "device" is the CPU, its operators' own time stands in the
device's columns and ``card`` is ``"cpu"``.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np

OUT = os.path.join("artifacts", "profile_infer_torch")
TOP_OPS = 60  # ops in the table and in the JSON line
OUTSIDE_CHILDREN = "{} (outside its children)"


@contextlib.contextmanager
def module_ranges(model):
    """Inside the block, every forward of `model` and of each of its named
    children runs inside a ``record_function`` range of its name (the
    model's own is its class name). Yields the children's names in
    order."""
    from torch.autograd.profiler import record_function

    open_ranges, handles = [], []

    def enter(name):
        def hook(module, args):
            rf = record_function(name)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    named = [(type(model).__name__, model), *model.named_children()]
    for name, module in named:
        handles.append(module.register_forward_pre_hook(enter(name)))
        handles.append(module.register_forward_hook(leave))
    try:
        yield [name for name, _ in named[1:]]
    finally:
        for h in handles:
            h.remove()
        while open_ranges:  # a forward that raised leaves its ranges open
            open_ranges.pop().__exit__(None, None, None)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _self_times(ops):
    """Each CPU operator's own time: its duration less its direct
    children's on the same thread (the ranges of one thread nest)."""
    own = [e["dur"] for e in ops]
    by_thread = defaultdict(list)
    for i, e in enumerate(ops):
        by_thread[(e["pid"], e["tid"])].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (ops[i]["ts"], -ops[i]["dur"]))
        stack = []
        for i in idx:
            while stack and (ops[stack[-1]]["ts"] + ops[stack[-1]]["dur"]
                             <= ops[i]["ts"]):
                stack.pop()
            if stack:
                own[stack[-1]] -= ops[i]["dur"]
            stack.append(i)
    return own


def attribute(trace_events, model_name: str, children, on_device: bool):
    """Totals of one profiled call from its Chrome trace's events: the
    operations (device kernels, copies and fills on a card; operators' own
    time on the CPU) by name, and by the range that holds each one's start:
    a child's, else the model's (its time outside its children), else
    none. Times in the trace are in µs."""
    ann = "gpu_user_annotation" if on_device else "user_annotation"
    inner, outer, ops = [], [], []
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == ann:
            span = (e["ts"], e["ts"] + e["dur"])
            if e["name"] in children:
                inner.append((*span, e["name"]))
            elif e["name"] == model_name:
                outer.append((*span, OUTSIDE_CHILDREN.format(model_name)))
        elif cat in DEVICE_CATS if on_device else cat == "cpu_op":
            ops.append(e)
    own = ([e["dur"] for e in ops] if on_device else _self_times(ops))
    # the children run one after another, as do the model's calls: the
    # ranges of each kind are disjoint, so the last one starting at or
    # before t is the only one that can hold it
    inner.sort()
    outer.sort()

    def find(spans, t):
        i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else None

    by_op, count = defaultdict(float), defaultdict(int)
    by_module = {n: 0.0 for n in children}
    by_module[OUTSIDE_CHILDREN.format(model_name)] = 0.0
    outside = 0.0
    for e, us in zip(ops, own):
        by_op[e["name"]] += us / 1e3
        count[e["name"]] += 1
        where = find(inner, e["ts"]) or find(outer, e["ts"])
        if where is None:
            outside += us / 1e3
        else:
            by_module[where] += us / 1e3
    return dict(
        device_ms_total=sum(by_op.values()), events=len(ops),
        top_ops=[dict(name=k, ms=ms, count=count[k]) for k, ms in
                 sorted(by_op.items(), key=lambda kv: -kv[1])],
        modules=[dict(name=k, ms=ms) for k, ms in by_module.items()],
        outside_model_ms=outside)


def trace_prediction(model, fn, volume, num_classes: int, window, batch: int,
                     device, out_dir: str):
    """One warm-up prediction and one recorded prediction of `volume`
    through ``sliding_window_inference(fn, ...)`` under ``torch.profiler``,
    `model`'s ranges on; writes ``<out_dir>/trace.json``. Returns the
    recorded call's probabilities and its totals (``attribute``, with
    ``wall_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from .inference.sliding_window import sliding_window_inference

    on_device = device.type == "cuda"
    sync = torch.cuda.synchronize if on_device else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_device
                                     else [])

    def predict():
        return sliding_window_inference(fn, volume, num_classes,
                                        window=window, batch=batch,
                                        device=device)

    with module_ranges(model) as children, profile(
            activities=acts, schedule=schedule(wait=0, warmup=1, active=1)
    ) as prof:
        predict()
        sync()
        prof.step()  # the warm-up call ends: recording begins
        t0 = time.perf_counter()
        probs = predict()  # on the host: the device is done
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)  # read back: no parse of every event
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    res = attribute(events, type(model).__name__, children, on_device)
    res["wall_ms"] = wall_ms
    return probs, res


def print_tables(res, unit: str):
    """The JAX tool's two tables: per op, then per module."""
    print(f"\n== {res['device_ms_total']:.1f} ms total {unit} time across "
          f"{res['events']} events ==")
    print(f"{'ms':>9} {'n':>5}  op")
    for op in res["top_ops"][:TOP_OPS]:
        print(f"{op['ms']:9.2f} {op['count']:5d}  {op['name'][:100]}")
    print("\n== by module (record_function ranges of the model's children) ==")
    for m in sorted(res["modules"], key=lambda m: -m["ms"]):
        print(f"{m['ms']:9.2f}  {m['name']}")
    print(f"{res['outside_model_ms']:9.2f}  outside the model", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--edge", type=int, default=256)
    p.add_argument("--window", type=int, default=96)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--model_args_json", default=None,
                   help="JSON file or JSON text of MedFormer arguments")
    p.add_argument("--out", default=OUT, help="directory of trace.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from .bench_train import CLASSES
    from .inference.sliding_window import sliding_window_inference
    from .models import get_model, init_params
    from .predict import read_model_args
    from .utils.device import card_line, resolve_device

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    model = get_model("medformer", len(CLASSES),
                      read_model_args(args.model_args_json),
                      dtype=torch.bfloat16)
    model = init_params(model, seed=0).to(device).eval()

    def fn(x):
        out = model(x)["segmentation"]
        return out[0] if isinstance(out, (list, tuple)) else out

    vol = np.random.default_rng(0).normal(
        size=(args.edge,) * 3).astype(np.float32)
    win = (args.window,) * 3
    t0 = time.perf_counter()
    probs = sliding_window_inference(fn, vol, len(CLASSES), window=win,
                                     batch=args.batch, device=device)
    first_s = time.perf_counter() - t0
    if not np.isfinite(probs).all():
        raise RuntimeError("profile_infer: the warm call's probabilities "
                           "are not finite")
    _, res = trace_prediction(model, fn, vol, len(CLASSES), win, args.batch,
                              device, args.out)
    print_tables(res, "device" if device.type == "cuda" else "CPU operator")
    result = dict(card=card, edge=args.edge, window=args.window,
                  batch=args.batch, first_call_s=first_s, **res)
    result["top_ops"] = res["top_ops"][:TOP_OPS]
    result["trace"] = os.path.join(args.out, "trace.json")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
