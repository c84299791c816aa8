"""ctypes bindings to the repository's host library
``native/rsuper_native.cpp`` (the port's own copy of
``rsuper_tpu/data/native_io.py``): multithreaded trilinear/nearest
resampling, the fused NIfTI payload decode and the one-pass packed-mask
encoder of the loader.

The library is built with ``g++`` at its first use into
``rsuper_tpu_torch/_build/`` (ignored by git; the file name holds a hash of
the source and flags, so an edited source is rebuilt):

    g++ -O3 -march=native -fPIC -std=c++17 -shared \
        native/rsuper_native.cpp -o _build/librsuper_native-<hash>.so -lpthread

Where it cannot be built or loaded, each function returns None and its
caller takes the numpy/scipy path, which gives the same results; the path
is logged once. This is host code: the device path does not depend on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "rsuper_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_PATH = "unknown"  # "native" or "numpy" once _load has run


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"librsuper_native-{digest}.so"


def _build() -> Path:
    """Compile the library unless it is built; raises when it cannot be."""
    target = _target()
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise FileNotFoundError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lpthread"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed ({out.returncode}): {out.stderr[-2000:]}")
    os.replace(tmp, target)  # atomic: concurrent builds agree
    return target


def _declare(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rsuper_resample_trilinear.argtypes = [fp, i64, i64, i64, fp, i64, i64,
                                             i64, ctypes.c_int]
    lib.rsuper_resample_trilinear.restype = ctypes.c_int
    lib.rsuper_resample_nearest_u8.argtypes = [u8p, i64, i64, i64, u8p, i64,
                                               i64, i64, ctypes.c_int]
    lib.rsuper_resample_nearest_u8.restype = ctypes.c_int
    lib.rsuper_nifti_scale_cast_f32.argtypes = [
        u8p, ctypes.c_int, i64, ctypes.c_float, ctypes.c_float, fp,
        ctypes.c_int,
    ]
    lib.rsuper_nifti_scale_cast_f32.restype = ctypes.c_int
    lib.rsuper_pack_masks_cl.argtypes = [u8p, u8p, u8p, i64, i64, u8p,
                                         ctypes.c_int]
    lib.rsuper_pack_masks_cl.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _PATH
    if _TRIED:
        return _LIB
    _TRIED = True
    log = logging.getLogger("rsuper")
    try:
        lib = ctypes.CDLL(str(_build()))
        _declare(lib)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        # the fallback gives the same records, about 8x slower an item
        log.warning("native host library unavailable (%s: %s); the loader "
                    "takes the numpy/scipy path", type(e).__name__, e)
        _PATH = "numpy"
        return None
    log.info("native host library loaded: the loader takes the native path")
    _LIB, _PATH = lib, "native"
    return _LIB


def path() -> str:
    """Which path the host data functions take: ``"native"`` or
    ``"numpy"`` (the library is built or tried first)."""
    _load()
    return _PATH


def resample(
    data: np.ndarray,
    out_shape: Sequence[int],
    order: int = 1,
    nthreads: int = 0,
) -> Optional[np.ndarray]:
    """Native resample to `out_shape` (order 0: uint8 nearest, 1:
    trilinear); None without the library (caller falls back to scipy)."""
    lib = _load()
    if lib is None:
        return None
    out_shape = tuple(int(s) for s in out_shape)
    if len(out_shape) != 3 or data.ndim != 3:
        raise ValueError(f"3-D volumes only: {data.shape} -> {out_shape}")
    if order == 0:
        src = np.ascontiguousarray(data, np.uint8)
        dst = np.empty(out_shape, np.uint8)
        rc = lib.rsuper_resample_nearest_u8(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), *src.shape,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), *out_shape,
            nthreads,
        )
    else:
        src = np.ascontiguousarray(data, np.float32)
        dst = np.empty(out_shape, np.float32)
        rc = lib.rsuper_resample_trilinear(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *src.shape,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *out_shape,
            nthreads,
        )
    return dst if rc == 0 else None


def pack_masks_cl(label: np.ndarray, unk: Optional[np.ndarray],
                  seg: Optional[np.ndarray],
                  nthreads: int = 0) -> Optional[np.ndarray]:
    """Fused channel-first → packed channels-last mask encode: (C, D, H, W)
    uint8 stacks (unk/seg ``None`` = all-zero) → (D, H, W, ceil(3C/8))
    bytes in ``np.packbits(..., bitorder='little')`` layout, in one pass.
    None without the library (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    label = np.ascontiguousarray(label, np.uint8)
    C = label.shape[0]
    spatial = label.shape[1:]
    N = int(np.prod(spatial))
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def ptr(a):
        if a is None:
            return None
        a = np.ascontiguousarray(a, np.uint8)
        if a.shape != label.shape:
            raise ValueError(f"mask stack {a.shape} != label {label.shape}")
        return a, a.ctypes.data_as(u8p)

    unk_h = ptr(unk)  # hold the arrays so the buffers outlive the call
    seg_h = ptr(seg)
    out = np.empty(spatial + ((3 * C + 7) // 8,), np.uint8)
    rc = lib.rsuper_pack_masks_cl(
        label.ctypes.data_as(u8p),
        unk_h[1] if unk_h else None,
        seg_h[1] if seg_h else None,
        C, N, out.ctypes.data_as(u8p), nthreads,
    )
    return out if rc == 0 else None


_NIFTI_ITEMSIZE = {2: 1, 4: 2, 8: 4, 16: 4, 64: 8, 512: 2}


def nifti_scale_cast_f32(
    raw: bytes, offset: int, dtype_code: int, count: int, slope: float,
    inter: float, nthreads: int = 0,
) -> Optional[np.ndarray]:
    """Native fused NIfTI payload decode: little-endian voxels of the given
    NIfTI datatype code → float32 with scl_slope/scl_inter applied, in one
    threaded pass (flat; the caller reshapes in Fortran order). None without
    the library or for an unsupported datatype."""
    lib = _load()
    if lib is None or dtype_code not in _NIFTI_ITEMSIZE:
        return None
    nbytes = count * _NIFTI_ITEMSIZE[dtype_code]
    if offset + nbytes > len(raw):
        return None
    dst = np.empty(count, np.float32)
    src = np.frombuffer(raw, np.uint8, count=nbytes, offset=offset)
    rc = lib.rsuper_nifti_scale_cast_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(dtype_code), int(count), float(slope), float(inter),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nthreads,
    )
    return dst if rc == 0 else None
