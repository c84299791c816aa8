#!/usr/bin/env python3
"""Time the top-N bisection kernel (``csrc/topn.cu``) and variants of it on
the card, at the Ball Loss's shapes, against the plain bisection.

    python tools/topn_variants.py                           # the shipped build
    python tools/topn_variants.py tools/topn_variants.json  # its variants

For each shape of ``SHAPES`` (batched ``(B, V, K)``) and ``SINGLE`` (one
volume ``(V, K)``), float32, on three seeded inputs (``ball``: uniform
values inside one inserted ball of diameter 24, exactly 0 elsewhere, as the
Ball Loss's masked volume; ``dense``: normal values with negatives;
``ties``: the ball's values quantized to 4 levels): whether the thresholds
are bit-equal to the plain bisection's, then on the ball input ``ms`` (the
whole call, host included, CUDA events over 20 calls), ``device_ms`` (the
call captured once in a CUDA graph and replayed) and ``kernels_per_call``
(the nodes of a CUDA graph of one call).

The JSON lists variants: ``{"name": ..., "subs": [[old, new], ...],
"flags": [nvcc flags], "set": {name: value}}``. A variant with ``subs`` or
``flags`` is ``csrc/topn.cu`` with every ``old`` replaced by ``new`` (each
must occur), built with ``_build.NVCC_FLAGS`` and its ``flags`` into the
ignored ``rsuper_tpu_torch/_build/variants/``, all builds at once; the
module constants of ``ops/topn.py`` named in ``set`` take their values while
it is timed. ``tools/topn_variants.json`` holds the pass levels r of 1, 5,
7, 9 (shipped) and 13, clusters of 8, the volume read from L2 in every
pass, and the shipped kernel built with ``-DTOPN_TIMELINE``, whose per-CTA
clock of every phase is printed after each shape (``timeline``). Every
variant sees the same inputs. Prints one JSON line per (variant, shape) and
the card's name and power limit last. Needs the card and nvcc; an
experiment tool, nothing on the main path uses it.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from rsuper_tpu_torch.ops import _build, dispatch, topn  # noqa: E402
from rsuper_tpu_torch.ops.balls import insert_ball  # noqa: E402
from rsuper_tpu_torch.utils.device import card_line, graph_ops  # noqa: E402

SHAPES = [(1, 96 ** 3, 3), (2, 96 ** 3, 3), (1, 128 ** 3, 3),
          (9, 96 ** 3, 3), (300, 127, 3)]
SINGLE = [(96 ** 3, 3)]
ITERS, REPS = 26, 20


def build(variants):
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for v in variants:
        src = (_build.CSRC / "topn.cu").read_text()
        for old, new in v.get("subs", []):
            if old not in src:
                raise ValueError(f"{v['name']}: text not in the source: {old!r}")
            src = src.replace(old, new)
        path = out_dir / f"topn_{v['name']}.cu"
        path.write_text(src)
        so = out_dir / f"topn_{v['name']}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *v.get("flags", []),
               "-o", str(so), str(path)]
        jobs[v["name"]] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"variant": name, "build_failed": out[-3000:]}),
                  flush=True)
            continue
        libs[name] = ctypes.CDLL(str(so))
        print(json.dumps({"variant": name, "ptxas": cs.ptxas_summary(out)}),
              flush=True)
    return libs


def inputs(B, V, K, dev, gen):
    """(kind, x (B, V) float32, ns (B, K)) for the three kinds."""
    edge = round(V ** (1.0 / 3.0))
    u = torch.rand((B, V), generator=gen, device=dev)
    if edge ** 3 == V:
        c = torch.full((B,), edge // 2, device=dev)
        inside = insert_ball((edge,) * 3, (c, c + 3, c - 5),
                             torch.full((B,), 24.0, device=dev)).reshape(B, V)
        ns = torch.tensor([4000.0, 3200.0, 4800.0][:K], device=dev)
    else:
        inside = (torch.rand((B, V), generator=gen, device=dev) < 0.5).float()
        ns = torch.tensor([30.0, 20.0, 50.0][:K], device=dev)
    ball = u * inside
    ties = torch.ceil(ball * 4.0) / 4.0  # 0, 0.25, 0.5, 0.75, 1
    ns = ns.repeat(B, 1)
    return [("ball", ball, ns),
            ("dense", torch.randn((B, V), generator=gen, device=dev), ns),
            ("ties", ties, ns)]


def case(name, shape, single, dev, gen):
    if single:
        V, K = shape
        B = 1
    else:
        B, V, K = shape
    fn = topn.topn_threshold_multi if single else topn.topn_threshold_multi_batched
    row = {"v": name, "shape": list(shape), "single": single}
    equal = {}
    for kind, x, ns in inputs(B, V, K, dev, gen):
        a = (x[0], ns[0]) if single else (x, ns)
        got = fn(*a, iters=ITERS)
        with dispatch.plain_on_device():
            ref = fn(*a, iters=ITERS)
        torch.cuda.synchronize()
        equal[kind] = bool(torch.equal(got, ref))
        if kind == "ball":
            timed = a
    row["equal"] = equal
    call = lambda: fn(*timed, iters=ITERS)  # noqa: E731
    n = fn.launches
    call()
    row["launches_per_call"] = fn.launches - n
    row["ms"] = cs.time_ms(call, REPS)
    row["device_ms"] = cs.graph_ms(call, REPS)
    row["kernels_per_call"] = len(graph_ops(call))
    print(json.dumps(row), flush=True)


def _built(v) -> bool:
    """Whether the variant has a build of its own."""
    return bool(v.get("subs") or v.get("flags"))


def timeline(name, lib):
    """Per CTA of item 0, the clock64() cycles from the kernel's start to
    each recorded phase (a build with -DTOPN_TIMELINE): 1 loaded, 2 maximum
    exchanged, then per pass p 3+8p mids built, 4+8p this thread's values
    scanned, 5+8p the queued values binned, 6+8p the counts added into
    their owners' shares, 7+8p the cluster barrier passed, 8+8p the shares
    gathered, 9+8p suffix-summed, 10+8p walked; 31 the end."""
    buf = (ctypes.c_longlong * (16 * 32))()
    torch.cuda.synchronize()
    if lib.rsuper_topn_timeline(buf):
        return
    rows = [[buf[c * 32 + i] for i in range(32)] for c in range(16)]
    out = {}
    for c, row in enumerate(rows):
        if row[0] == 0:
            continue
        out[c] = {i: row[i] - row[0] for i in range(1, 32) if row[i] > row[0]}
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
    print(json.dumps({"v": name, "timeline_cycles": out, "clocks_sm": sm}),
          flush=True)


def main(argv):
    variants = json.loads(Path(argv[0]).read_text()) if argv else [
        {"name": "shipped"}]
    report = _build._finish("topn", _build._start("topn"))
    print(json.dumps({"variant": "shipped build",
                      "ptxas": cs.ptxas_summary(report)}), flush=True)
    libs = build([v for v in variants if _built(v)])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shipped = _build.load
    try:
        for v in variants:
            if _built(v) and v["name"] not in libs:
                continue
            lib = libs.get(v["name"])
            _build.load = (lambda n, lib=lib: lib if n == "topn" and lib
                           else shipped(n))
            topn._FNS.clear()
            topn._MAX_CLUSTER.clear()
            saved = {a: getattr(topn, a) for a in v.get("set", {})}
            for a, val in v.get("set", {}).items():
                setattr(topn, a, val)
            topn._plan.cache_clear()
            gen.manual_seed(0)
            for shape, single in ([(s, False) for s in SHAPES]
                                  + [(s, True) for s in SINGLE]):
                try:
                    case(v["name"], shape, single, dev, gen)
                    if lib is not None and hasattr(lib, "rsuper_topn_timeline"):
                        timeline(v["name"], lib)
                except Exception as e:  # noqa: BLE001 - a variant may not launch
                    torch.cuda.synchronize()
                    print(json.dumps({"v": v["name"], "shape": list(shape),
                                      "error": repr(e)[:300]}), flush=True)
            for a, val in saved.items():
                setattr(topn, a, val)
    finally:
        _build.load = shipped
        topn._FNS.clear()
        topn._MAX_CLUSTER.clear()
    print(card_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
