"""Wall time per step of the full-physics T30L8 float32 model on one GPU,
through the batched runner's CUDA graphs and through its eager loop.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 -m pyspeedy_tpu_torch.step_time

It builds the kernels, initializes the demo model (synthetic boundary
conditions) and, at B=128 members and at B=1: one warm-up day in each mode
(the first graph call captures the step's two graphs), then four windows of
`N_STEPS` steps in turns, graph, eager, eager, graph, each ending in
``torch.cuda.synchronize()``. Then the host's time of one call of the
physics and the spectral-update wrappers, each called `N_CALLS` times back
to back with the arguments of one step at B=128 (the host's clock before
the first call and after the last, before the card is waited for). Last, at
each width, one profiled window in each mode: the device's busy ms, device
launches and the host's enqueue calls per step
(utils.profiling.window_profile), and by device kernel at B=128. It prints
one JSON line: the card's name and power limit, where the package was
imported from, the milliseconds per step of every window, the profiles,
the graphs' capture seconds and memory, and the wrappers' host
milliseconds per call. To compare two checkouts, run each
checkout's own step_time on one card in turns (parent, change, change,
parent): the host's time per step spreads by tens of percent from call to
call.
"""

from __future__ import annotations

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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("step_time needs a CUDA device")
    from .models import model as M
    from .ops import column_kernels as ck
    from .ops import glue_kernels as GK
    from .parallel.ensemble import broadcast_state, make_run_steps_batched
    from .params import T30L8
    from .testing import make_demo_model
    from .utils.profiling import nvidia_smi_line, window_profile

    card = nvidia_smi_line()
    ck.build_kernels()
    consts, state1, cal = make_demo_model(T30L8, device="cuda",
                                          precision="f32", fft_mode="matmul")
    run = make_run_steps_batched(consts, device="cuda")
    graphs = run.graphs
    call = lambda state, ctx, mode: run(state, ctx, eager=mode == "eager")

    def window(state, cal, first, mode):
        ctx, cal = M.build_step_ctx(dataclasses.replace(cal), first, N_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = call(state, ctx, mode)
        torch.cuda.synchronize()
        return state, cal, 1e3 * (time.perf_counter() - t0) / N_STEPS

    result = {"card": card,
              "package": str(Path(__file__).resolve().parent)}
    # Every timed window first: a profiler session may leave the host
    # slower for the rest of the process, so the profiled windows come
    # last.
    ends = {}
    for width in WIDTHS:
        before = dict(graphs.stats)
        state, c, first = broadcast_state(state1, width), cal, 2
        for mode in ("graph", "eager"):
            state, c, _ = window(state, c, first, mode)
            first += N_STEPS
        result[f"graphs_B{width}"] = {
            k: graphs.stats[k] - before[k] for k in (
                "captures", "capture_s", "pool_bytes", "buffer_bytes")}
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
