"""The traced window: torch.profiler (CUPTI) over a run of segments, and
its reduction to device records, host calls and the layers' times.

A device record is a kernel, copy or fill the card ran. Its layer is the
first directory of ``layers/`` one of whose files holds a pattern found in
the record's name; a record that matches none belongs to ``torch_passes``.
A record is "eager" when the host call that launched it (the profiler's
correlation of the record to its runtime call) was not a graph launch.

The profiler has been seen to record no device activity at all for tens
of seconds on an NVIDIA H100: a window that holds fewer device records than the
launches its steps must make is profiled again a second later, five
windows at most (``profile``)."""

from __future__ import annotations

import json
import re
import time
from collections import defaultdict
from pathlib import Path

import torch

__all__ = ["HOST_CALLS", "GRAPH_LAUNCH", "layer_patterns", "profile",
           "Trace"]

HERE = Path(__file__).resolve().parent
# The CUDA runtime and driver calls by which the host enqueues work on the
# card: "host calls" count these.
HOST_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaGraphLaunch"})
GRAPH_LAUNCH = "cudaGraphLaunch"
OTHER = "torch_passes"
WINDOW = "speedy_bench.window"
# A record's name in the breakdown is cut to this many characters.
NAME_CHARS = 160


def layer_patterns() -> dict:
    """{layer: [compiled patterns]} from layers/<layer>/*.json."""
    out = {}
    for d in sorted(p for p in (HERE / "layers").iterdir() if p.is_dir()):
        pats = []
        for f in sorted(d.glob("*.json")):
            with open(f) as fh:
                pats += [re.compile(p) for p in json.load(fh)["patterns"]]
        out[d.name] = pats
    return out


def layer_of(name: str, patterns: dict) -> str:
    for layer, pats in patterns.items():
        if any(p.search(name) for p in pats):
            return layer
    return OTHER


class Trace:
    """The reduction of one profiled window of `chunk_steps` steps of
    chunks of `members` members."""

    def __init__(self, events, chunk_steps: int, members: int):
        from torch.autograd import DeviceType

        self.chunk_steps = chunk_steps
        self.members = members
        runtime = {}          # correlation id -> runtime call name
        host_calls = 0
        cpu = []
        window = None
        device = []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                # The profiler mirrors a host annotation (the window's) on
                # the device's timeline: no work of the card.
                if not (e.name() == WINDOW or e.is_user_annotation()):
                    device.append(e)
                continue
            name = e.name()
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
                continue
            if name in HOST_CALLS:
                host_calls += 1
                runtime[e.correlation_id()] = name
            cpu.append((e.start_ns(), e.end_ns(), name))
        self.window_ns = window
        self.host_calls = host_calls
        patterns = layer_patterns()
        self.by_name = defaultdict(lambda: [0.0, 0])
        self.by_layer = defaultdict(float)
        self.eager_s = 0.0
        self.linked = 0
        spans = []
        for e in device:
            t0, t1 = e.start_ns(), e.end_ns()
            if window is not None and (t1 < window[0] or t0 > window[1]):
                continue
            s = (t1 - t0) * 1e-9
            name = e.name()
            rec = self.by_name[name]
            rec[0] += s
            rec[1] += 1
            self.by_layer[layer_of(name, patterns)] += s
            call = runtime.get(e.correlation_id()) or runtime.get(
                e.linked_correlation_id())
            if call is not None:
                self.linked += 1
                if call != GRAPH_LAUNCH:
                    self.eager_s += s
            spans.append((t0, t1))
        self.records = sum(r[1] for r in self.by_name.values())
        spans.sort()
        busy, gaps, end = 0, [], None
        start = window[0] if window else (spans[0][0] if spans else 0)
        last = start
        for t0, t1 in spans:
            if t0 > last:
                gaps.append((t0 - last, last))
            if t1 > last:
                busy += t1 - max(t0, last)
                last = t1
        stop = window[1] if window else last
        if stop > last:
            gaps.append((stop - last, last))
        self.busy_s = busy * 1e-9
        self.window_s = (stop - start) * 1e-9
        gaps.sort(reverse=True)
        self.idle_gaps = [(self._host_at(cpu, at, at + length), length * 1e-9)
                          for length, at in gaps[:10]]

    @staticmethod
    def _host_at(cpu, t0, t1) -> str:
        """What the host was doing in [t0, t1]: the innermost host event
        (the latest to start) that covers the gap's middle."""
        mid = (t0 + t1) // 2
        best = None
        for s, e, name in cpu:
            if s <= mid <= e and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else "no host call (the harness's loop)"

    def device_ops(self, n: int = 10) -> list:
        """[[name (cut to NAME_CHARS), seconds]] of the n records by name
        that took the most device time."""
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:NAME_CHARS], v[0]] for name, v in top]


def profile(fn, min_records: int, attempts: int = 5):
    """(events of the first window, out of `attempts`, that holds at least
    `min_records` device records, the number of windows profiled), or
    (None, attempts) when none did. `fn` runs the window's work; the
    profiler waits for the card at its end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        n = sum(1 for e in events if e.device_type() == DeviceType.CUDA)
        if n >= min_records:
            return events, attempt
        print(f"speedy_bench: profiled window {attempt} held {n} device "
              f"records (at least {min_records} expected); profiling again "
              f"in a second", flush=True)
        time.sleep(1.0)
    return None, attempts
