"""Wall time per step of the full-physics T30L8 float32 model on one GPU.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 -m pyspeedy_tpu_torch.step_time

It builds the kernels, initializes the demo model (synthetic boundary
conditions), runs one warm-up day at B=128 members, then three windows of
`N_STEPS` steps, and the same at B=1; each window ends in
``torch.cuda.synchronize()``. Then the host's time of one call of the
physics and the spectral-update wrappers, each called `N_CALLS` times back
to back with the arguments of one step at B=128 (the host's clock before the
first call and after the last, before the card is waited for). It prints one
JSON line: the card's name and power limit, where the package was imported
from, the milliseconds per step of every window and the wrappers' host
milliseconds per call. To compare two checkouts, copy this file into the
other checkout's package and run both on one card in turns (parent, change,
change, parent): the host's time per step spreads by tens of percent from
call to call.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

N_STEPS = 36
WIDTHS = (128, 1)
N_CALLS = 50


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


def profiled_window(run, state, cal, first, M) -> dict:
    """Device time and launches per step of one N_STEPS window, in all and
    by device kernel ({name: [ms per step, launches per step]}, longest
    first), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), first, N_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(state, ctx)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    kernels = {}
    for e in events:
        entry = kernels.setdefault(e.key[:100], [0.0, 0.0])
        entry[0] += e.self_device_time_total * 1e-3 / N_STEPS
        entry[1] += e.count / N_STEPS
    return {"busy_ms_per_step": sum(v[0] for v in kernels.values()),
            "launches_per_step": sum(v[1] for v in kernels.values()),
            "by_kernel": kernels}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("step_time needs a CUDA device")
    from .models import model as M
    from .ops import column_kernels as ck
    from .ops import glue_kernels as GK
    from .parallel.ensemble import broadcast_state, make_run_steps_batched
    from .params import T30L8
    from .testing import make_demo_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    ck.build_kernels()
    consts, state1, cal = make_demo_model(T30L8, device="cuda",
                                          precision="f32", fft_mode="matmul")
    run = make_run_steps_batched(consts, device="cuda")

    def window(state, cal, first):
        ctx, cal = M.build_step_ctx(dataclasses.replace(cal), first, N_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run(state, ctx)
        torch.cuda.synchronize()
        return state, cal, 1e3 * (time.perf_counter() - t0) / N_STEPS

    result = {"card": card,
              "package": str(Path(__file__).resolve().parent)}
    for width in WIDTHS:
        state, c, _ = window(broadcast_state(state1, width), cal, 2)
        times = []
        for n in range(3):
            state, c, ms = window(state, c, 2 + (n + 1) * N_STEPS)
            times.append(ms)
        result[f"ms_per_step_B{width}"] = times
        if width == WIDTHS[0]:
            # A step with shortwave: the physics writes its radiation cache.
            host = wrapper_host_ms(run, state, c, 3 + 4 * N_STEPS, M, (
                (ck, "grid_physics_cuda"), (GK, "spectral_update_cuda")))
            profiled = profiled_window(run, state, c, 2 + 4 * N_STEPS, M)
    result["host_ms_per_wrapper_call_B128"] = host
    result["profiled_window_B128"] = profiled
    print(json.dumps(result))


if __name__ == "__main__":
    main()
