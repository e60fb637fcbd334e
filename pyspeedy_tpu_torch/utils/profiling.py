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

Spans. `span(name, **args)` marks a part of the port's own code (the names
are SPANS: the batched runner's parts, SPPT's draw, the step and the
wrappers of its kernels and of the coupler). Without a profiler session and
outside a step graph's traced capture it is one shared null context. Under
a profiler session it opens `torch.profiler.record_function(name)` (the
host's range in the Chrome trace, on the device records' clock) and times
the span on the device: timing events on the current stream at its enter
and exit (the host's clock on the CPU). While the batched runner captures
the traced twin of a step graph (`capture_spans`), a span records external
timing events, which become event-record nodes of that graph: the runner
replays the twin, one replay of each graph in a profiled run call, and
hands its table to the store (`add_graph_spans`). The store, read with
`span_totals()` and cleared with `reset_spans()`, holds by name the spans'
total and self milliseconds (self: the total less its child spans'), their
count, the profiled run calls' steps, member-steps, member width and copy
bytes, and the set-up's counters: graph captures, and the boundary fields
remapped onto the model's grid with the source points their fill supplied
(SETUP_SPANS' `bc.remap`, coupling/remap.py); `trace()` writes it as
SPANS_FILE beside its trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch

__all__ = ["trace", "PhaseTimer", "TRACE_FILE", "SPANS_FILE", "HOST_CALLS",
           "window_profile", "kernel_device_ms", "nvidia_smi_line", "SPANS",
           "span", "span_totals", "reset_spans", "capture_spans",
           "add_graph_spans", "read_graph_spans", "resolve_spans",
           "record_run", "record_capture", "record_remap", "SETUP_SPANS"]

# The CUDA runtime and driver calls by which the host enqueues work on the
# card (a kernel, a copy or fill, a graph): "host calls" below count these.
HOST_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaGraphLaunch"})

# Name of the trace file that `trace` writes into its log directory.
TRACE_FILE = "trace.json"
# Name of the span table that `trace` writes beside it (span_totals()).
SPANS_FILE = "spans.json"

# Every span of the port, parents before their children. runner.run holds
# the runner's parts; step holds the kernels' wrappers, the coupler and the
# step's copies into the runner's buffers (its self time is the models'
# glue); sppt.draw runs inside runner.step_inputs.
SPANS = ("runner.run", "runner.inputs", "runner.copy_in", "runner.forcing",
         "runner.step_inputs", "sppt.draw", "runner.replay", "runner.capture",
         "runner.clone_out", "step", "transforms", "grid_dynamics", "physics",
         "spectral_update", "coupler", "step.copies")
# The set-up's spans, outside any run call: the boundary fields' remap
# (coupling/remap.py::remap_bc, inside Speedy.set_bc).
SETUP_SPANS = ("bc.remap",)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block: host operators,
    and the device's kernels, copies and fills when CUDA is available.
    Yields the log directory (a new temporary directory when none is given);
    on exit the trace is written there as TRACE_FILE, a Chrome trace that
    Perfetto (ui.perfetto.dev) and chrome://tracing open, and the span store
    as SPANS_FILE (span_totals(): every profiled span since the last
    reset_spans(), the replayed graphs' spans among them). The block's
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
    with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
        json.dump(span_totals(), f, indent=1)


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


# ---------------------------------------------------------------------------
# Spans and the store
# ---------------------------------------------------------------------------

_NULL = contextlib.nullcontext()
# None outside a step graph's capture; while one is captured, the traced
# twin's table (a list its spans append to), or False for the graph without
# spans.
_capture = None
_stack = []            # names of the open spans, innermost last
_call = None           # the number of the run call that is open
_totals = {}           # name -> [ms, ms of child spans, count]
_pending = []          # (name, parent, start, end) not yet read
_tables = []           # (a twin's span table, times, parent) not yet read
# Past this many pending spans a span's exit reads them (their events).
_MAX_PENDING = 1 << 14
# The profiled run calls' counters, and the set-up's.
_run = dict.fromkeys(("steps", "member_steps", "members", "bytes_in",
                      "bytes_out", "bytes_inputs"), 0)
_SETUP = {"captures": 0, "capture_s": 0.0, "remap_fields": 0,
          "remap_filled_points": 0}
_setup = dict(_SETUP)


def span(name: str, **args):
    """A context that marks the span `name` (one of SPANS or SETUP_SPANS):
    a null context unless a profiler session is active or a traced twin is
    captured (see the module's docstring). `args` go into the trace's
    record of the span; a `call` among them numbers the run call for the
    spans inside it."""
    cap = _capture
    if cap is None:
        if not torch.autograd._profiler_enabled():
            return _NULL
    elif cap is False:
        return _NULL
    return _Span(name, args)


def _mark():
    """A point on the span's clock: an external timing event on the current
    stream while a twin is captured (an event-record node of the graph), a
    timing event on the current stream where CUDA is in use, the host's
    clock (seconds) elsewhere."""
    if _capture is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
    elif torch.cuda.is_initialized():
        ev = torch.cuda.Event(enable_timing=True)
    else:
        return time.perf_counter()
    ev.record()
    return ev


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return 1e3 * (end - start)
    end.synchronize()
    return start.elapsed_time(end)


class _Span:
    __slots__ = ("name", "args", "parent", "rf", "start")

    def __init__(self, name, args):
        self.name, self.args = name, args

    def __enter__(self):
        global _call
        if "call" in self.args:
            _call = self.args["call"]
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.name)
        self.rf = None
        if torch.autograd._profiler_enabled():
            text = " ".join(f"{k}={v}" for k, v in
                            {"call": _call, **self.args}.items())
            self.rf = torch.profiler.record_function(self.name, text)
            self.rf.__enter__()
        self.start = _mark()
        return self

    def __exit__(self, *exc):
        end = _mark()
        _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = (self.name, self.parent, self.start, end)
        if _capture is not None:
            _capture.append(rec)
        else:
            _pending.append(rec)
            if len(_pending) > _MAX_PENDING:
                resolve_spans()
        return False


@contextlib.contextmanager
def capture_spans(table):
    """The spans of a step graph's capture: with a list, the traced twin's,
    each span's (name, parent, start, end) appended to it (parents inside
    the capture; None at its top); with None, the graph without spans, where
    no span records anything."""
    global _capture, _stack
    saved = _stack
    _capture, _stack = (False if table is None else table), []
    try:
        yield table
    finally:
        _capture, _stack = None, saved


def add_graph_spans(table, times: int, parent: str) -> None:
    """Count the spans of a twin's last replay `times` times, its top spans
    as children of `parent`. The twin's next replay rewrites its events:
    read_graph_spans(table) reads them before it, span_totals() at the
    latest."""
    _tables.append((table, times, parent))


def read_graph_spans(table) -> None:
    """Read the pending spans of a twin's table (before its replay)."""
    for i, (tab, times, parent) in enumerate(_tables):
        if tab is table:
            del _tables[i]
            _read(table, times, parent)
            return


def _read(recs, times: int = 1, top=None) -> None:
    for name, parent, start, end in recs:
        ms = times * _elapsed_ms(start, end)
        tot = _totals.setdefault(name, [0.0, 0.0, 0])
        tot[0] += ms
        tot[2] += times
        parent = top if parent is None else parent
        if parent is not None:
            _totals.setdefault(parent, [0.0, 0.0, 0])[1] += ms


def resolve_spans() -> None:
    """Read every pending span's time into the totals (waiting for their
    end events on the card)."""
    _read(_pending)
    _pending.clear()
    for table, times, parent in _tables:
        _read(table, times, parent)
    _tables.clear()


def record_run(steps: int, members: int, **nbytes) -> None:
    """Count a profiled run call: its steps, member-steps and member width,
    and the bytes it copied (bytes_in, bytes_out, bytes_inputs)."""
    _run["steps"] += steps
    _run["member_steps"] += steps * members
    _run["members"] = members
    for k, v in nbytes.items():
        _run[k] += v


def record_capture(seconds: float) -> None:
    """Count a step graph's capture (set-up, profiled or not)."""
    _setup["captures"] += 1
    _setup["capture_s"] += seconds


def record_remap(fields: int, filled: int) -> None:
    """Count the boundary fields remapped onto the model's grid and the
    source points their fill supplied (set-up)."""
    _setup["remap_fields"] += fields
    _setup["remap_filled_points"] += filled


def span_totals() -> dict:
    """The store: {"spans": {name: {"ms", "self_ms", "count"}}, the
    profiled run calls' "steps", "member_steps", "members" (the last one's
    width), "bytes_in", "bytes_out", "bytes_inputs", and the set-up's
    "captures", "capture_s", "remap_fields" and "remap_filled_points"}.
    Reads the pending spans first."""
    resolve_spans()
    spans = {name: {"ms": ms, "self_ms": ms - child, "count": n}
             for name, (ms, child, n) in _totals.items()}
    return {"spans": spans, **_run, **_setup}


def reset_spans() -> None:
    """Clear the store."""
    _totals.clear()
    _pending.clear()
    _tables.clear()
    _run.update(dict.fromkeys(_run, 0))
    _setup.update(_SETUP)
