"""Wall time per step of the full-physics float32 model on one GPU,
through the batched runner's CUDA graphs and through its eager loop.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 -m pyspeedy_tpu_torch.step_time [--preset T30|T47|T63]
        [--bf16-tendencies]

It builds the kernels, initializes the demo model of the preset (T30L8 by
default; synthetic boundary conditions; with ``--bf16-tendencies`` the
steps after the initialization take bfloat16 tendencies) and, at B=128
members and at B=1:
one warm-up day in each mode from the same state (the first graph call
captures the step's graphs), with a digest of each day's state
(state_digest: two trees' eager days compare by it), then, from the graph
day's end, four windows of `N_STEPS` steps in turns, graph, eager, eager,
graph, each ending in ``torch.cuda.synchronize()``. Then the host's time
of one call of the physics and the spectral-update wrappers, each called
`N_CALLS` times back to back with the arguments of one step at B=128 (the
host's clock before the first call and after the last, before the card is
waited for). Last, at each width, one profiled window in each mode: the
device's busy ms, device launches and the host's enqueue calls per step
(utils.profiling.window_profile), and by device kernel at B=128. It prints
one JSON line: the card's name and power limit, the preset, where the
package was imported from, the digests, the milliseconds per step of every
window, the profiles, the graphs' capture seconds, memory, copies into
buffers a step and the last call's copies by kind (StepGraphs.stats), and
the wrappers' host milliseconds per call. To compare two checkouts, run
each checkout's own step_time (or this file copied into the other's
package) on one card in turns (parent, change, change, parent): the host's
time per step spreads by tens of percent from call to call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

N_STEPS = 36
WIDTHS = (128, 1)
N_CALLS = 50
TURNS = ("graph", "eager", "eager", "graph")
GRAPH_STATS = ("captures", "capture_s", "pool_bytes", "buffer_bytes")


def run_window(run, states, cal, first: int, n_steps: int,
               eager: bool = False):
    """n_steps from step `first` for each member-batched state of `states`
    (the chunks of an ensemble, one run call each, with the same calendar)
    through the batched runner `run` (its graphs, or its eager loop with
    `eager`). Returns (the states after, the calendar after, wall seconds
    from the first call to the end of the card's work)."""
    from .models import model as M

    ctx, cal = M.build_step_ctx(dataclasses.replace(cal), first, n_steps)
    sync = (torch.cuda.synchronize if torch.cuda.is_initialized()
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    states = [run(state, ctx, eager=eager) for state in states]
    sync()
    return states, cal, time.perf_counter() - t0


def wrapper_host_ms(run, state, cal, first, M, wrappers) -> dict:
    """{wrapper: host milliseconds per call}: each (module, name) wrapper is
    recorded during step `first`, then called N_CALLS times back to back
    with the recorded arguments."""
    calls = {}

    def recorder(key, fn):
        def record(*args, **kwargs):
            calls.setdefault(key, (fn, args, kwargs))
            return fn(*args, **kwargs)
        return record

    originals = {(mod, name): getattr(mod, name) for mod, name in wrappers}
    for (mod, name), fn in originals.items():
        setattr(mod, name, recorder(name, fn))
    try:
        ctx, _ = M.build_step_ctx(dataclasses.replace(cal), first, 1)
        run(state, ctx)
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    result = {}
    for name, (fn, args, kwargs) in calls.items():
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_CALLS):
            fn(*args, **kwargs)
        result[name] = 1e3 * (time.perf_counter() - t0) / N_CALLS
        torch.cuda.synchronize()
    return result


def state_digest(state: dict) -> str:
    """sha256 of every field the steps write (models.model.DYNAMIC_FIELDS),
    in name order, each level's values in C order: two runs with the same
    digest gave the same bits."""
    import hashlib

    from .models import model as M

    h = hashlib.sha256()
    for name in sorted(M.DYNAMIC_FIELDS & state.keys()):
        val = state[name]
        for a in (val if isinstance(val, tuple) else (val,)):
            h.update(name.encode())
            h.update(a.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=("T30", "T47", "T63"), default="T30")
    ap.add_argument("--bf16-tendencies", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("step_time needs a CUDA device")
    from . import params as P
    from .models import model as M
    from .ops import column_kernels as ck
    from .ops import glue_kernels as GK
    from .parallel.ensemble import broadcast_state, make_run_steps_batched
    from .testing import make_demo_model
    from .utils.profiling import nvidia_smi_line, window_profile

    card = nvidia_smi_line()
    ck.build_kernels()
    consts, state1, cal = make_demo_model(getattr(P, f"{a.preset}L8"),
                                          device="cuda", precision="f32",
                                          fft_mode="matmul",
                                          bf16_tendencies=a.bf16_tendencies)
    run = make_run_steps_batched(consts, device="cuda")
    graphs = run.graphs
    call = lambda state, ctx, mode: run(state, ctx, eager=mode == "eager")

    def window(state, cal, first, mode):
        (state,), cal, secs = run_window(run, [state], cal, first, N_STEPS,
                                         eager=mode == "eager")
        return state, cal, 1e3 * secs / N_STEPS

    result = {"card": card, "preset": a.preset,
              "bf16_tendencies": a.bf16_tendencies,
              "package": str(Path(__file__).resolve().parent)}
    # Every timed window first: a profiler session may leave the host
    # slower for the rest of a process, so the profiled windows come
    # last.
    ends = {}
    for width in WIDTHS:
        before = dict(graphs.stats)
        # The warm-up: a graph day and an eager day from the same state,
        # their digests; the turns go on from the graph day.
        state0 = broadcast_state(state1, width)
        days = {mode: window(state0, cal, 2, mode) for mode in ("graph",
                                                                 "eager")}
        result[f"digest_B{width}"] = {mode: state_digest(day[0])
                                      for mode, day in days.items()}
        state, c, _ = days["graph"]
        first = 2 + N_STEPS
        del state0, days
        stats = {k: graphs.stats[k] - before[k] for k in GRAPH_STATS}
        # The copies into buffers a graph step makes (a tree from before
        # they were counted has none to report).
        stats["copies_per_step"] = graphs.stats.get("copies_per_step")
        stats["copies"] = graphs.stats.get("copies")
        result[f"graphs_B{width}"] = stats
        times = {"graph": [], "eager": []}
        for mode in TURNS:
            state, c, ms = window(state, c, first, mode)
            times[mode].append(ms)
            first += N_STEPS
        result[f"ms_per_step_B{width}"] = times
        ends[width] = (state, c, first)
    state, c, first = ends[WIDTHS[0]]
    # A step with shortwave: the physics writes its radiation cache.
    result["host_ms_per_wrapper_call_B128"] = wrapper_host_ms(
        lambda s, x: call(s, x, "eager"), state, c, first + 1, M,
        ((ck, "grid_physics_cuda"), (GK, "spectral_update_cuda")))
    for width, (state, c, first) in ends.items():
        ctx, _ = M.build_step_ctx(dataclasses.replace(c), first, N_STEPS)
        profiles = {}
        for mode in ("graph", "eager"):
            prof = window_profile(lambda: call(state, ctx, mode), N_STEPS)
            if width != WIDTHS[0]:
                prof.pop("by_kernel")
            profiles[mode] = prof
        result[f"profile_B{width}"] = profiles
    print(json.dumps(result))


if __name__ == "__main__":
    main()
