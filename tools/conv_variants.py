#!/usr/bin/env python3
"""Time variants of a conv kernel source on the card, at the production
bf16 shapes of ``chip_smoke.py``, against the plain version.

    python tools/conv_variants.py tools/conv_variants_prologue.json

(``conv_variants_prologue.json``: the shipped fused forward against its
first tensor-core version and against each without the prologue's
arithmetic, the folded ReLU and the taller TN = 64 tile taken one at a
time.)

The JSON lists variants: ``{"name": ..., "source": "conv_cf", "subs":
[[old, new], ...], "only": [function names]}``. Each variant is the source
``rsuper_tpu_torch/csrc/<source>.cu`` with every ``old`` text replaced by
``new`` (each must occur), built with ``_build.NVCC_FLAGS`` into the
ignored ``rsuper_tpu_torch/_build/variants/``, all builds at once. Then, for
each variant in turn, the wrappers of ``ops/conv_cf.py`` load it in place of
the shipped build and each function of ``only`` (``in_relu_conv3x3x3_cf``,
``conv3x3x3_cf`` at the fused forward's shapes, ``conv3x3x3_cf_dgrad``) is
timed on the same seeded inputs for every variant. Prints one JSON line per
variant with its ``-Xptxas -v`` registers and spill stores, then one per
(variant, function, shape): ms, TFLOP/s, and whether the result is within
the bf16 tolerance of the plain version (a variant that changes what the
kernel computes is timed all the same, and says so). Needs the card and
nvcc; an experiment tool, nothing on the main path uses it.
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
from rsuper_tpu_torch.ops import _build, conv_cf, dispatch  # noqa: E402
from rsuper_tpu_torch.utils.device import card_line  # noqa: E402

SHAPES = {
    "in_relu_conv3x3x3_cf": cs.CONV_SHAPES["in_relu_conv3x3x3_cf"],
    "conv3x3x3_cf": cs.CONV_SHAPES["in_relu_conv3x3x3_cf"],
    "conv3x3x3_cf_dgrad": cs.DGRAD_SHAPES,
}


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
                for k in cs.ptxas_summary(out) if "tc_kernel" in k["kernel"]]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return libs


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
            gen.manual_seed(0)  # every variant sees the same inputs
            for k in v.get("only", list(SHAPES)):
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
    finally:
        _build.load = shipped
    print(card_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
