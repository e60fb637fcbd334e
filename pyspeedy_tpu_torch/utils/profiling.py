"""Profiling helpers: torch.profiler traces, device windows, kernel times
and simple phase timers.

The reference offers only a gprof build target (speedy.f90/Makefile:5,32);
here profiling is first-class: wrap any run in `trace()` to get a
Chrome / Perfetto trace of the host operators and the device kernels, use
`window_profile` for the device time, device launches and host enqueue
calls of a run of steps (kernels replayed from a CUDA graph included, under
their own names), `kernel_device_ms` for one kernel's time per launch, or
`PhaseTimer` for coarse wall-clock accounting of init/step/export phases.
`nvidia_smi_line` names the card and its power limit for every figure.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch

__all__ = ["trace", "PhaseTimer", "TRACE_FILE", "HOST_CALLS",
           "window_profile", "kernel_device_ms", "nvidia_smi_line"]

# The CUDA runtime and driver calls by which the host enqueues work on the
# card (a kernel, a copy or fill, a graph): "host calls" below count these.
HOST_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaGraphLaunch"})

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


def nvidia_smi_line() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def window_profile(fn, n_steps: int) -> dict:
    """torch.profiler over one call of fn, a run of n_steps steps that ends
    with its device work waited for: the device's busy milliseconds and
    records (kernels, copies, fills: a graph's kernels are recorded one by
    one under their names) per step, the host's enqueue calls (HOST_CALLS)
    per step, and by device record {name: [ms per step, records per step]},
    longest first. The tracer can lose records (see kernel_device_ms): the
    caller holds the counts to what the run must launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    by_kernel = {}
    for e in device:
        entry = by_kernel.setdefault(e.key, [0.0, 0.0])
        entry[0] += e.self_device_time_total * 1e-3 / n_steps
        entry[1] += e.count / n_steps
    host = sum(e.count for e in events
               if e.device_type != DeviceType.CUDA and e.key in HOST_CALLS)
    return {"busy_ms_per_step": sum(v[0] for v in by_kernel.values()),
            "launches_per_step": sum(v[1] for v in by_kernel.values()),
            "host_calls_per_step": host / n_steps,
            "by_kernel": by_kernel}


def kernel_device_ms(fn, kernel_name: str, reps: int = 20) -> float:
    """Time the card spends in one launch of the named kernel, from the
    profiler's device-side records (CUPTI); `fn` launches it once. Where the
    profiler records none of it in five windows, the time of a call of `fn`
    from CUDA events around `reps` calls back to back (the wrappers this
    times launch that one kernel a call), with a line saying so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # The tracer may drop a record now and then: the mean is over the
    # launches it did record. On an H100 it has also returned windows without
    # any record, several in a row, and recorded every launch again a second
    # later, and once none for half a minute: such a window is profiled
    # again a second later, five windows at most, then the call is timed by
    # events. More records than launches is wrong.
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel_name in e.key]
        count = sum(e.count for e in hits)
        if count > 0:
            break
        print(f"  (profiler window {attempt + 1} held no record of "
              f"{kernel_name}; profiling again in a second)")
        time.sleep(1.0)
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        print(f"  (no profiler record of {kernel_name} in five windows: "
              f"timed by CUDA events over {reps} calls back to back, "
              f"{ms:.4f} ms a call)")
        return ms
    if not count <= reps:
        raise RuntimeError(
            f"profiler recorded {count} launches of {kernel_name}, "
            f"expected {reps}")
    return 1e-3 * sum(e.self_device_time_total for e in hits) / count
