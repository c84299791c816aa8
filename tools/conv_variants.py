#!/usr/bin/env python3
"""Time variants of a conv or depthwise kernel source on the card, at the
production bf16 shapes of ``chip_smoke.py``, against the plain version.

    python tools/conv_variants.py tools/conv_variants_prologue.json
    python tools/conv_variants.py tools/conv_variants_depthwise.json
    python tools/conv_variants.py tools/conv_variants_stem.json

(``conv_variants_prologue.json``: the shipped fused forward against its
first tensor-core version and against each without the prologue's
arithmetic, the folded ReLU and the taller TN = 64 tile taken one at a
time. ``conv_variants_depthwise.json``: the shipped depthwise kernels
against the forward without its multiply-adds (the staging and stores
alone) and without staging after the first planes (the arithmetic alone),
and against other ring depths and the backward's depth-run target.
``conv_variants_stem.json``: the stem's shipped forward and weight gradient
against each without its MMAs, the forward storing its C fragments without
the shared-memory tile, staging one copy of a plane read as single values
instead of three kw-shifted copies read by ldmatrix, and other grid fills.)

The JSON lists variants: ``{"name": ..., "source": "conv_cf", "subs":
[[old, new], ...], "only": [function names], "set": {name: value}}``. Each
variant is the source ``rsuper_tpu_torch/csrc/<source>.cu`` with every
``old`` text replaced by ``new`` (each must occur), built with
``_build.NVCC_FLAGS`` into the ignored ``rsuper_tpu_torch/_build/variants/``,
all builds at once. Then, for each variant in turn, the wrappers of
``ops/conv_cf.py`` and ``ops/dwconv.py`` load it in place of the shipped
build, the module constants of ``ops/conv_cf.py`` or ``ops/dwconv.py``
named in ``set`` take their values (the depthwise tile plan is recomputed),
and each function of ``only`` (``in_relu_conv3x3x3_cf``, ``conv3x3x3_cf`` at
the fused forward's shapes, ``conv3x3x3_cf_dgrad``; ``stem_conv3x3x3_cf``
and ``stem_conv3x3x3_cf_wgrad``, the stem's forward and weight gradient at
``chip_smoke.py``'s shapes, with ``device_ms``; ``depthwise_conv3x3x3`` at
the forward's B = 8 and B = 1 shapes, ``depthwise_conv3x3x3_bwd``) is timed
on the same seeded inputs for every variant. Prints one JSON line per variant with its
``-Xptxas -v`` registers and spill stores, then one per (variant, function,
shape): ms (and for the depthwise functions ``device_ms``, a CUDA graph of
the call replayed), TFLOP/s, and whether the result is within the bf16
tolerance of the plain version (a variant that changes what the kernel
computes is timed all the same, and says so). Needs the card and nvcc; an
experiment tool, nothing on the main path uses it.
"""

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from rsuper_tpu_torch.ops import _build, conv_cf, dispatch, dwconv  # noqa: E402
from rsuper_tpu_torch.utils.device import card_line  # noqa: E402

SHAPES = {
    "in_relu_conv3x3x3_cf": cs.CONV_SHAPES["in_relu_conv3x3x3_cf"],
    "conv3x3x3_cf": cs.CONV_SHAPES["in_relu_conv3x3x3_cf"],
    "conv3x3x3_cf_dgrad": cs.DGRAD_SHAPES,
    "depthwise_conv3x3x3": cs.DW_FWD_SHAPES,
    "depthwise_conv3x3x3_bwd": cs.DW_BWD_SHAPES,
    "stem_conv3x3x3_cf": cs.CONV_SHAPES["conv3x3x3_cf"],
    "stem_conv3x3x3_cf_wgrad": cs.WGRAD_SHAPES["conv3x3x3_cf_wgrad"],
}
DW = ("depthwise_conv3x3x3", "depthwise_conv3x3x3_bwd")
STEM = ("stem_conv3x3x3_cf", "stem_conv3x3x3_cf_wgrad")


def build(variants):
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for v in variants:
        src = (_build.CSRC / f"{v['source']}.cu").read_text()
        for old, new in v.get("subs", []):
            if old not in src:
                raise ValueError(f"{v['name']}: text not in the source: {old!r}")
            src = src.replace(old, new)
        path = out_dir / f"{v['name']}.cu"
        path.write_text(src)
        so = out_dir / f"{v['name']}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(path)]
        jobs[v["name"]] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"variant": name, "build_failed": out[-3000:]}), flush=True)
            continue
        libs[name] = ctypes.CDLL(str(so))
        regs = [(k["kernel"], k.get("registers"), k.get("spill_stores"))
                for k in cs.ptxas_summary(out)
                if any(n in k["kernel"] for n in ("tc_kernel", "dw3", "stem_"))]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return libs


def depthwise_case(name, k, shape, gen, dev):
    """One depthwise function at one shape, bf16: against the plain version
    (dx and dw for the backward), ms and device_ms."""
    bf = torch.bfloat16
    x = torch.randn(shape, generator=gen, device=dev).to(bf)
    w = torch.randn((3, 3, 3, 1, shape[-1]), generator=gen, device=dev) / 27
    args = (x, w)
    if k.endswith("_bwd"):
        args += (torch.randn(shape, generator=gen, device=dev).to(bf),)
    fn = getattr(dwconv, k)
    got = fn(*args)
    with dispatch.plain_on_device():
        ref = fn(*args)
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    ok, errs = True, []
    for g, r in zip(got, ref):
        err, mx = cs._err(g, r)
        errs.append(err)
        ok = ok and err <= cs.TOL[str(g.dtype).split(".")[-1]] * (1 + mx)
    print(json.dumps({"v": name, "k": k, "shape": list(shape),
                      "ms": cs.time_ms(lambda: fn(*args), 5),
                      "device_ms": cs.graph_ms(lambda: fn(*args), 20),
                      "ok": ok, "max_abs_err": errs}), flush=True)
    del got, ref, args
    torch.cuda.empty_cache()


def stem_case(name, k, shape, gen, dev):
    """The stem's forward or weight gradient at one (B, D, 1, H, W, C_out)
    shape, bf16: against the plain version (dw at the float32 tolerance),
    ms and device_ms."""
    B, D, Ci, H, W, Co = shape
    bf = torch.bfloat16
    x = torch.randn((B, D, Ci, H, W), generator=gen, device=dev).to(bf)
    if k.endswith("_wgrad"):
        fn = conv_cf.conv3x3x3_cf_wgrad
        args = (x, torch.randn((B, D, Co, H, W), generator=gen, device=dev).to(bf))
    else:
        fn = conv_cf.conv3x3x3_cf
        args = (x, torch.randn((3, 3, 3, Ci, Co), generator=gen, device=dev)
                / math.sqrt(27 * Ci))
    got = fn(*args)
    with dispatch.plain_on_device():
        ref = fn(*args)
    err, mx = cs._err(got, ref)
    ok = err <= cs.TOL[str(got.dtype).split(".")[-1]] * (1 + mx)
    print(json.dumps({"v": name, "k": k, "shape": list(shape),
                      "ms": cs.time_ms(lambda: fn(*args), 5),
                      "device_ms": cs.graph_ms(lambda: fn(*args), 20),
                      "ok": ok, "max_abs_err": err}), flush=True)
    del got, ref, args
    torch.cuda.empty_cache()


def _module(attr):
    """The module of ``ops`` whose constant `attr` a variant sets."""
    return conv_cf if hasattr(conv_cf, attr) else dwconv


def main(argv):
    variants = json.loads(Path(argv[0]).read_text())
    libs = build(variants)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    shipped = _build.load
    try:
        for v in variants:
            if v["name"] not in libs:
                continue
            lib = libs[v["name"]]
            _build.load = (lambda n, lib=lib, src=v["source"]:
                           lib if n == src else shipped(n))
            dwconv._FNS.clear()
            saved = {a: getattr(_module(a), a) for a in v.get("set", {})}
            for a, val in v.get("set", {}).items():
                setattr(_module(a), a, val)
            dwconv._dw_plan.cache_clear()
            gen.manual_seed(0)  # every variant sees the same inputs
            for k in v.get("only", list(SHAPES)):
                if k in DW or k in STEM:
                    for shape in SHAPES[k]:
                        (depthwise_case if k in DW else stem_case)(
                            v["name"], k, shape, gen, dev)
                    continue
                fn = getattr(conv_cf, k)
                for (B, D, Ci, H, W, Co) in SHAPES[k]:
                    a = torch.randn((B, D, Ci, H, W), generator=gen, device=dev).to(bf)
                    w_in, w_out = (Co, Ci) if k == "conv3x3x3_cf_dgrad" else (Ci, Co)
                    w = torch.randn((3, 3, 3, w_in, w_out), generator=gen,
                                    device=dev) / math.sqrt(27 * w_in)
                    got = fn(a, w)
                    with dispatch.plain_on_device():
                        ref = fn(a, w)
                    err, mx = cs._err(got, ref)
                    tol = cs.TOL["bfloat16"] * (1 + mx)
                    ms = cs.time_ms(lambda: fn(a, w), 5)
                    flops = 2.0 * B * D * H * W * Ci * Co * 27
                    print(json.dumps({"v": v["name"], "k": k,
                                      "shape": [B, D, Ci, H, W, Co], "ms": ms,
                                      "tflops": flops / ms / 1e9,
                                      "ok": err <= tol, "err": err, "tol": tol}),
                          flush=True)
                    del got, ref, a, w
                    torch.cuda.empty_cache()
            for a, val in saved.items():
                setattr(_module(a), a, val)
    finally:
        _build.load = shipped
        dwconv._FNS.clear()
        dwconv._dw_plan.cache_clear()
    print(card_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
