"""Device resolution for the port's entry points, and what measurements on
the card read about it: its name and power limit, and the device operations
a call launches."""

from __future__ import annotations

import ctypes
import subprocess

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when CUDA is asked for (the default) and is missing;
    nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` prints them:
    the line that stands beside every number measured on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the CUDA 12 driver API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _kernel_name(cu, node: int) -> str:
    """The (mangled) name of a kernel node's function."""
    p = _KernelNodeParams()
    name = ctypes.c_char_p()
    get = getattr(cu, "cuGraphKernelNodeGetParams_v2", None)
    if get is None or get(ctypes.c_void_p(node), ctypes.byref(p)) != 0:
        return "kernel"
    for handle, entry in ((p.func, "cuFuncGetName"), (p.kern, "cuKernelGetName")):
        fn = getattr(cu, entry, None)  # CUDA 12.3 drivers and later
        if handle and fn is not None and fn(ctypes.byref(name),
                                            ctypes.c_void_p(handle)) == 0:
            return name.value.decode()
    return "kernel"


def graph_ops(fn) -> list:
    """The device operations one call of `fn` launches on the card: the
    call is captured once in a CUDA graph (after two warm-up calls on the
    capturing stream; the graph is not replayed) and the graph's nodes are
    read through the driver API: a kernel's name for each kernel node,
    ``"memcpy"`` and ``"memset"`` for copies and fills. Unlike a profiler
    window it cannot miss an operation."""
    cu = ctypes.CDLL("libcuda.so.1")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    ops = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET; the rest (empty,
        # event and allocation nodes) are not device work
        if kind.value == 0:
            ops.append(_kernel_name(cu, node))
        elif kind.value in (1, 2):
            ops.append("memcpy" if kind.value == 1 else "memset")
    torch.cuda.synchronize()
    del graph
    return ops
