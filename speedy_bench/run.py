"""The benchmark of the PyTorch port: one cell, one run.

    python3 -m speedy_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. A run builds the cell's ensemble on the port (``program.py``) from the
seed, warms one cycle (every chunk one segment: the graphs captured, the
kernels built or loaded from the checkout's ``build/kernels``), then runs
the closed loop of forecast segments for `--seconds`: a cycle advances every
member chunk by one segment in turn, the next segment starts when the last
has finished on the card, and each is timed from its run call to the end of
its work. With ``--trace 1`` a traced window of the traffic's
``trace_segments`` segments follows (``trace.py``). Once the windows have
closed the program is freed and its forecast held against the reference
(``check.py``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
with its limit (also the last lines of standard error).

End-to-end metrics (host clock): ``member_steps_per_s``, every member-step
of the segments completed in the window over the window's seconds (from
the first segment's run call to the end of the last one's work);
``segment_p95_ms``, the 95th percentile of every segment's time in the
window; ``setup_s``, from the start of the process to the first timed
segment."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import sys
import time

_T_IMPORT = time.time()

__all__ = ["main", "run_cell", "FORBIDDEN"]

# Top-level module names that a run may not hold (the JAX package and JAX).
FORBIDDEN = ("jax", "jaxlib", "flax", "pyspeedy_tpu")


def process_start() -> float:
    """The epoch second at which this process started (/proc), or this
    module's import where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def _log(msg: str) -> None:
    print(f"speedy_bench: {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _segments(prog, n_chunks: int):
    """(chunk, step context, first step) of every segment, cycle after
    cycle: each cycle's context is built once for all its chunks."""
    while True:
        ctx, first = prog.cycle_ctx()
        for c in range(n_chunks):
            yield c, ctx, first


def _sample_plan(cell, seed: int, seconds: float):
    """The times (seconds into the window) after which the next segment is
    sampled, and a random source for the members, both from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = cell.traffic["samples"]
    return sorted(rng.uniform(0.0, 0.9 * seconds, n)), rng


def _members(rng, chunk: int, k: int):
    import torch

    pick = {0, chunk - 1}
    rest = [m for m in range(chunk) if m not in pick]
    pick |= set(rng.choice(rest, size=min(max(k - len(pick), 0), len(rest)),
                           replace=False).tolist()) if rest else set()
    return torch.tensor(sorted(pick)[:max(k, 1)], dtype=torch.int64)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             program_cls=None, t0: float | None = None,
             on_check=None) -> dict:
    """One run of `cell` on `device`; returns the result object.
    `program_cls` replaces program.Program (the tests' broken programs);
    `on_check(ref, samples, want, init_fields, host_bc)`, when given, is
    called with what the check compared (control.py's readings)."""
    import torch

    from . import check, inputs
    from . import metrics as MT
    from . import program as P
    from .reference.ops.geometry import build_geometry
    from .reference.params import ModelParams as RefParams
    from .reference.runner import Reference

    t0 = process_start() if t0 is None else t0
    bench = _benchmark()
    ref_params = cell.params(RefParams)
    host_bc = inputs.boundary_conditions(cell.config,
                                         build_geometry(ref_params),
                                         cell.traffic["months"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prog = (program_cls or P.Program)(cell, seed, device, host_bc)
    init_fields = prog.initial_fields()
    n_chunks, chunk = cell.n_chunks, cell.traffic["chunk"]
    seg_iter = _segments(prog, n_chunks)
    # The warm cycle: every chunk one segment.
    for _ in range(n_chunks):
        c, ctx, first = next(seg_iter)
        prog.segment(c, ctx)
    _sync(device)
    setup_s = time.time() - t0

    plan, rng = _sample_plan(cell, seed, seconds)
    samples = [prog.spinup_sample]
    if cell.sppt:
        # The reference draws the noise from the benchmark's keys, not from
        # the program's state.
        samples[0]["before"]["sppt_key"] = inputs.spinup_sppt_key()
        keys = [inputs.sppt_keys(seed, c, chunk) for c in range(n_chunks)]
    times = []
    attempted = failed = sampled = 0
    steps = prog.n_steps
    win0 = time.perf_counter()
    deadline = win0 + seconds
    while True:
        c, ctx, first = next(seg_iter)
        attempted += 1
        s0 = time.perf_counter()
        try:
            before, after, bad = prog.segment(c, ctx)
            _sync(device)
        except Exception as exc:           # a failed segment counts
            _log(f"segment {attempted} (chunk {c}, step {first}) raised "
                 f"{type(exc).__name__}: {exc}")
            before = after = None
            bad = True
        s1 = time.perf_counter()
        if bad:
            failed += 1
        else:
            times.append(s1 - s0)
        if plan and s0 - win0 >= plan[0] and after is not None:
            plan.pop(0)
            sampled += 1
            idx = _members(rng, chunk, cell.traffic["sample_members"])
            start = P.take_members(before, prog.carried, idx)
            if cell.sppt:
                start["sppt_key"] = keys[c][idx]
            samples.append({"first_step": first, "n_steps": steps,
                            "members": idx.tolist(), "before": start,
                            "after": P.take_members(after, prog.carried,
                                                    idx)})
        if s1 >= deadline:
            break
    window_s = time.perf_counter() - win0
    done = len(times)
    e2e = {"member_steps_per_s": done * chunk * steps / window_s,
           "segment_p95_ms": 1e3 * (statistics.quantiles(times, n=20)[18]
                                    if done >= 2 else max(times or [math.nan])),
           "setup_s": setup_s}
    _log(f"{cell.name}: {attempted} segments ({failed} failed) of {chunk} "
         f"members x {steps} steps in {window_s:.3f} s; "
         + ", ".join(f"{k} {v}" for k, v in e2e.items()))
    result = {"correct": False, "attempted": attempted, "failed": failed}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else 0)}

    per_layer, breakdown = {}, None
    if trace and cuda:
        from . import trace as TR

        n_trace = cell.traffic["trace_segments"]

        def window():
            for _ in range(n_trace):
                c, ctx, _first = next(seg_iter)
                prog.segment(c, ctx)

        # Each step launches at least its six hand-written kernels.
        events, tries = TR.profile(window, 6 * n_trace * steps)
        if events is not None:
            tr = TR.Trace(events, n_trace * steps, chunk)
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            reading = MT.Reading(tr, ref_params, cell.sppt,
                                 e2e["member_steps_per_s"])
            for m in bench["per_layer"]:
                v = MT.read(m["name"], reading)
                if v is not None:
                    per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
            _log(f"traced window ({tries} profiled): {tr.records} device "
                 f"records, {tr.linked} linked to their launch, "
                 f"{tr.host_calls} host calls over {n_trace * steps} steps; "
                 f"busy {tr.busy_s:.6f} of {tr.window_s:.6f} s")
        else:
            _log("the profiler recorded no device activity in five windows: "
                 "no per-layer metric")

    # The check, once the program is freed.
    prog.free()
    del prog, seg_iter
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    try:
        ref = Reference(ref_params, host_bc, cell.start, device)
        want = check.reference_outputs(ref, samples)
        nums = check.numbers(init_fields,
                             {k: ref.state[k] for k in init_fields},
                             [s["after"] for s in samples], want,
                             ref.consts.sp.el2)
    except Exception as exc:            # no reading: not correct
        _log(f"the reference raised {type(exc).__name__}: {exc}")
        nums = {}
    correct, checks = check.verdict(nums, cell.limits, failed)
    if on_check is not None and nums:
        on_check(ref, samples, want, init_fields, host_bc)
    correct = correct and sampled > 0
    _log(f"reference check of {len(samples)} segments in "
         f"{time.perf_counter() - r0:.1f} s")

    result["correct"] = correct
    result["metrics"] = per_layer if trace else {
        m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
        for m in bench["end_to_end"]}
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _benchmark() -> dict:
    from .cell import ROOT

    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    t0 = process_start()
    import torch

    from .cell import load_cell

    cell = load_cell(a.workload)
    if not torch.cuda.is_available():
        _log("torch.cuda.is_available() is False: the benchmark runs on "
             "the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
        return 2
    _log(f"card: {_card()}")
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                      t0=t0)
    found = _forbidden_modules()
    if found:
        _log(f"the process holds {', '.join(found)}: no result")
        return 3
    _log(f"correct: {result['correct']}")
    for name, c in result["checks"].items():
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def _card() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


if __name__ == "__main__":
    sys.exit(main())
