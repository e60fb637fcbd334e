"""Profiling helpers: torch.profiler traces and simple phase timers.

The reference offers only a gprof build target (speedy.f90/Makefile:5,32);
here profiling is first-class: wrap any run in `trace()` to get a
Chrome / Perfetto trace of the host operators and the device kernels, or use
`PhaseTimer` for coarse wall-clock accounting of init/step/export phases.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch

__all__ = ["trace", "PhaseTimer", "TRACE_FILE"]

# Name of the trace file that `trace` writes into its log directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block: host operators,
    and the device's kernels, copies and fills when CUDA is available.
    Yields the log directory (a new temporary directory when none is given);
    on exit the trace is written there as TRACE_FILE, a Chrome trace that
    Perfetto (ui.perfetto.dev) and chrome://tracing open. The block's
    device work is waited for before the trace is stopped."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="pyspeedy_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class PhaseTimer:
    """Accumulate wall-clock per named phase; blocks on device results (a
    phase ends with torch.cuda.synchronize() when CUDA is in use)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:30s} {self.totals[name]:10.3f}s "
                         f"x{self.counts[name]}")
        return "\n".join(lines)
