"""Profiling (the port's counterpart of ``rsuper_tpu/utils/profiling.py``):
a ``torch.profiler`` window over a few training steps, and a timer of the
loop's phases on the host's clock."""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, List


class TraceCapture:
    """A ``torch.profiler`` window over steps [start, start + num): CPU and,
    where there is a card, CUDA activity, written as a Chrome trace to
    ``<log_dir>/trace.json`` when the window closes. The profiler starts one
    step early and drops that step (a warm-up: the first device records
    after the profiler starts can be lost), and the device is synchronised
    at both ends of the window, so the trace holds whole steps."""

    def __init__(self, log_dir: str, start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None

    @staticmethod
    def _sync():
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def _export(self, prof):
        prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))

    def step(self, step: int):
        import torch

        warmup = min(1, self.start)
        if step == self.start - warmup and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts, on_trace_ready=self._export,
                schedule=torch.profiler.schedule(
                    wait=0, warmup=warmup, active=self.stop - self.start))
            self._sync()
            self._prof.start()
        elif step == self.start and self._prof is not None:
            self._sync()
            self._prof.step()  # the warm-up step ends: recording begins
        elif step >= self.stop and self._prof is not None:
            self.close()

    def close(self):
        if self._prof is None:
            return
        self._sync()
        prof, self._prof = self._prof, None
        prof.stop()


class PhaseTimer:
    """Wall time on the host's clock per named phase. A phase that only
    enqueues device work measures the enqueue, not the device."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.samples.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, float]:
        """``<phase>_ms``: the mean, as the JAX package reports it; also
        ``<phase>_median_ms`` and ``<phase>_count``."""
        out = {}
        for k, v in self.samples.items():
            out[f"{k}_ms"] = 1000.0 * sum(v) / len(v)
            out[f"{k}_median_ms"] = 1000.0 * statistics.median(v)
            out[f"{k}_count"] = len(v)
        return out
