"""The port's benchmark: the counterpart of the JAX package's ``bench.py``
(throughput of the full-physics model) and ``bench_scaling.py`` (weak
scaling over devices), on one GPU.

Run from the root of a checkout:

    python -m pyspeedy_tpu_torch.bench                  # the cells
    python -m pyspeedy_tpu_torch.bench --sweep --scaling  # instead of them
    python -m pyspeedy_tpu_torch.bench --device cpu --tiny

It runs on the card by default (float32, the dense transform route; it
raises without one: there is no quiet move to the CPU); ``--device cpu``
runs the plain path in float64, as the JAX bench does on a CPU backend.
Every cell initializes the demo model (synthetic boundary conditions) and
runs the batched runner (parallel/ensemble.py::make_run_steps_batched: its
CUDA graphs on the card) from step 2, an ensemble in member chunks of
pick_member_chunk's width, each chunk one run call per window, the windows
timed by step_time.run_window and one more window (a day at most)
profiled by utils.profiling.window_profile. The cells, as the JAX bench has them:

- one member, full physics, T30L8: the median of five 30-day windows after
  one discarded window, in simulated years per wall-clock day (the
  headline ``metric``), against the 100 SYPD single-core estimate of
  BASELINE.md (``vs_baseline``, ``baseline_is_estimate``);
- ensembles of 64, 256 and 1,024 members (``ensemble_msps_{n}``,
  member-steps per second: the median of three 2-day windows after two
  discarded ones), with the card's busy time per member-step
  (``ensemble_device_us_per_mstep_{n}``);
- 16 members with SPPT against 16 without (``ensemble_msps_16_sppt``,
  ``sppt_overhead_pct``: 5 windows of 4 days each);
- T47L8 and T63L8: 64 members (``t47_ensemble_msps_64``,
  ``t63_ensemble_msps_64``, the median of three 1-day windows after two
  discarded) and one T63 member
  (``t63_sypd_1member``, 3 windows of 5 days).

For every cell it also prints, on a line of its own and as keys with the
cell's suffix: the card's busy share of the wall time, device launches and
the host's enqueue calls per step (all three of the profiled window, whose
host the profiler slows: a host-bound cell's share reads low there), and
the peak
device memory per member (torch.cuda.max_memory_allocated over the cell,
the runner's graph pool and buffers included). The last line of the output
is one JSON object with these keys and the card's name and power limit
(``card``).

Left out: the JAX bench's XLA cost-analysis keys (``*_logical_gbs*``,
``*_hbm_frac_upper_*``, ``*_achieved_gflops*``, ``*_mfu_*``,
``achieved_gflops_per_s``, ``logical_gb_per_s``). They come from XLA's
count of the bytes and operations of a compiled program, which PyTorch
has no counterpart of; the kernels' own bounds are chip_smoke.py's.

``--sweep`` times the member chunk width instead of the cells: 1,024 T30 members in chunks of
64 to 1,024, and 512 T47 and T63 members in chunks of 16 to 512, a fresh
runner for every width (so that only one width's graphs and buffers are
held), each width the median of three 1-day windows after two discarded
ones, and prints each width's member-steps/s, device time per
member-step, busy share, peak memory per member, capture seconds and
graph memory, and the fastest width. parallel/ensemble.py's MEMBER_CHUNK
and MEMBER_CHUNK_HIRES hold its optima.

``--scaling`` is bench_scaling.py's weak-scaling line (instead of the
cells, or beside the sweep): MEMBERS_PER_DEVICE
members a rank on the sharded runner (the mesh= runner, an ensemble mesh
of one rank per card, parallel/launch_multihost.py's process launcher;
nccl on the card, gloo on the CPU), on one rank and, with several cards,
on one rank per card; ``efficiency`` is null with one card.

``--tiny`` cuts every window to a few steps and the ensembles to a few
members (the tests' size on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import tempfile
import time

import torch

# SPEEDY single-core SYPD anchor: the reference publishes no throughput and
# no Fortran toolchain was at hand (BASELINE.md), so vs_baseline divides by
# this documented estimate.
REFERENCE_SYPD_ESTIMATE = 100.0
# Members a rank of the weak-scaling line advances.
MEMBERS_PER_DEVICE = 128
ENSEMBLE_SIZES = (64, 256, 1024)
N_SPPT = 16
N_HIRES = 64
# The chunk sweep: (members, chunk widths) by preset.
SWEEP = {"T30": (1024, (64, 128, 256, 512, 1024)),
         "T47": (512, (16, 32, 64, 128, 256, 512)),
         "T63": (512, (16, 32, 64, 128, 256, 512))}
# Calendar months the demo model's SST anomaly record covers: the longest
# cell (six 30-day windows) stays inside it.
N_MONTHS = 8


@dataclasses.dataclass(frozen=True)
class Depth:
    """Windows of each kind of cell: (discarded, timed, days each)."""

    single: tuple = (1, 5, 30)
    ensemble: tuple = (2, 3, 2)
    sppt: tuple = (2, 5, 4)
    hires_single: tuple = (1, 3, 5)
    hires_ensemble: tuple = (2, 3, 1)
    sweep: tuple = (2, 3, 1)
    sizes: tuple = ENSEMBLE_SIZES
    n_sppt: int = N_SPPT
    n_hires: int = N_HIRES
    sweep_cases: tuple = tuple(SWEEP.items())
    members_per_device: int = MEMBERS_PER_DEVICE


# The tests' size: every window a twelfth of a day (3 steps at T30).
TINY = Depth(single=(1, 2, 1 / 12), ensemble=(1, 2, 1 / 12),
             sppt=(1, 2, 1 / 12), hires_single=(1, 2, 1 / 24),
             hires_ensemble=(1, 2, 1 / 24), sweep=(1, 1, 1 / 12),
             sizes=(2, 4), n_sppt=2, n_hires=2,
             sweep_cases=(("T30", (4, (2, 4))),), members_per_device=2)


def _log(msg: str) -> None:
    print(f"bench: {msg}", flush=True)


def sypd(steps_per_s: float, nsteps_per_day: int) -> float:
    """Simulated years per wall-clock day at steps_per_s model steps a
    second."""
    return steps_per_s / nsteps_per_day / 365.0 * 86400.0


class Models:
    """The demo model of each preset on one device, built at first use:
    (consts, single-member state, calendar)."""

    def __init__(self, device: str):
        self.device = device
        self.cache = {}

    def params(self, preset: str, **overrides):
        from . import params as P
        precision = "f64" if self.device == "cpu" else "f32"
        return dataclasses.replace(getattr(P, f"{preset}L8"),
                                   precision=precision, fft_mode="matmul",
                                   **overrides)

    def get(self, preset: str, **overrides):
        key = (preset, tuple(sorted(overrides.items())))
        if key not in self.cache:
            from .testing import make_demo_model
            self.cache[key] = make_demo_model(
                self.params(preset, **overrides), device=self.device,
                n_months=N_MONTHS)
        return self.cache[key]


def measure(model, n_members: int, chunk: int, windows: tuple) -> dict:
    """One cell: n_members members of `model` ((consts, state, calendar))
    in chunks of `chunk` through a fresh batched runner, `windows` =
    (discarded, timed, days each) from step 2, then one profiled window
    (of a day at most).
    Returns the rates of the timed windows (member-steps/s and steps/s),
    their median, the profile per step and the memory figures. Raises if
    a member's error flag is set."""
    from .parallel.ensemble import broadcast_state, make_run_steps_batched
    from .step_time import run_window
    from .utils.profiling import window_profile

    consts, state1, cal = model
    device = consts.device
    cuda = device.type == "cuda"
    if n_members % chunk:
        raise ValueError(f"{n_members} members do not split into chunks of "
                         f"{chunk}")
    discarded, timed, days = windows
    n_steps = max(1, round(days * consts.params.nsteps))
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    run = make_run_steps_batched(consts, device=device)
    states = [broadcast_state(state1, chunk)
              for _ in range(n_members // chunk)]
    first, secs = 2, []
    for w in range(discarded + timed):
        states, cal, s = run_window(run, states, cal, first, n_steps)
        first += n_steps
        if w >= discarded:
            secs.append(s)
    out = {"members": n_members, "chunk": chunk, "steps_per_window": n_steps,
           "msps": [n_members * n_steps / s for s in secs]}
    out["msps_median"] = statistics.median(out["msps"])
    out["ms_per_step"] = 1e3 * statistics.median(secs) / n_steps
    # The card's figures; None (not measured) on the CPU.
    out.update(dict.fromkeys(DEVICE_FIGURES))
    if cuda:
        # At most a day under the profiler: its records cost the host.
        n_prof = min(n_steps, consts.params.nsteps)
        held = {}

        def window():
            held["states"], _, held["secs"] = run_window(run, states, cal,
                                                         first, n_prof)

        prof = window_profile(window, n_prof)
        states = held["states"]
        busy = prof["busy_ms_per_step"]
        # The busy share of the profiled window's own wall time.
        out.update(busy_pct=100.0 * busy / (1e3 * held["secs"] / n_prof),
                   busy_ms_per_step=busy,
                   launches_per_step=prof["launches_per_step"],
                   host_calls_per_step=prof["host_calls_per_step"],
                   device_us_per_mstep=1e3 * busy / n_members)
    if cuda:
        out["peak_mb_per_member"] = (torch.cuda.max_memory_allocated(device)
                                     / 1e6 / n_members)
    out["capture_s"] = out["pool_mb"] = out["buffer_mb"] = None
    if run.graphs is not None:
        st = run.graphs.stats
        out.update(capture_s=st["capture_s"], pool_mb=st["pool_bytes"] / 1e6,
                   buffer_mb=st["buffer_bytes"] / 1e6,
                   copies_per_step=st["copies_per_step"])
    bad = sum(int(s["error_flag"].sum()) for s in states)
    if bad:
        raise RuntimeError(f"{bad} of {n_members} members set their error "
                           f"flag")
    del run, states
    return out


def _describe(name: str, cell: dict, card: str) -> str:
    extra = "".join(
        f", {label} {cell[k]}" for k, label in (
            ("busy_pct", "busy % of the profiled window"),
            ("launches_per_step", "launches/step"),
            ("host_calls_per_step", "host calls/step"),
            ("device_us_per_mstep", "device us/member-step"),
            ("peak_mb_per_member", "peak MB/member"),
            ("copies_per_step", "copies into buffers/step"))
        if cell.get(k) is not None)
    rates = ", ".join(f"{r:.1f}" for r in cell["msps"])
    return (f"{name}: {cell['members']} members in chunks of "
            f"{cell['chunk']}, {cell['steps_per_window']}-step windows: "
            f"[{rates}] member-steps/s, median {cell['msps_median']:.1f} "
            f"({cell['ms_per_step']:.4f} ms/step){extra} [{card}]")


# The figures of a cell that only the card gives (profiled window, peak
# memory), and those that go into the JSON line with the cell's suffix.
DEVICE_FIGURES = ("busy_pct", "busy_ms_per_step", "launches_per_step",
                  "host_calls_per_step", "device_us_per_mstep",
                  "peak_mb_per_member")
SUFFIXED = ("busy_pct", "launches_per_step", "host_calls_per_step",
            "peak_mb_per_member")


def _suffixed(out: dict, prefix: str, suffix: str, cell: dict) -> None:
    """The cell's extra figures as keys `{prefix}{figure}{suffix}` (None
    where not measured)."""
    for k in SUFFIXED:
        out[f"{prefix}{k}{suffix}"] = cell[k]


def bench(models: Models, depth: Depth, card: str) -> dict:
    """Every cell of the JAX bench that the port measures; returns the
    JSON object (the figures unrounded)."""
    from .parallel.ensemble import pick_member_chunk

    out = {}
    p30 = models.params("T30")
    single = measure(models.get("T30"), 1, 1, depth.single)
    _log(_describe("T30 single member", single, card))
    steps_per_s = single["msps"]      # one member: steps/s
    value = sypd(statistics.median(steps_per_s), p30.nsteps)
    out.update({
        "metric": "SYPD_T30L8_full_physics_1member_median5",
        "value": value,
        "unit": "simulated_years_per_wallclock_day",
        "vs_baseline": value / REFERENCE_SYPD_ESTIMATE,
        "baseline_is_estimate": True,
        "window_sypd_min": sypd(min(steps_per_s), p30.nsteps),
        "window_sypd_max": sypd(max(steps_per_s), p30.nsteps)})
    _suffixed(out, "single_", "", single)

    for n in depth.sizes:
        cell = measure(models.get("T30"), n, pick_member_chunk(n, p30),
                       depth.ensemble)
        _log(_describe(f"T30 ensemble {n}", cell, card))
        out[f"ensemble_msps_{n}"] = cell["msps_median"]
        out[f"ensemble_device_us_per_mstep_{n}"] = cell["device_us_per_mstep"]
        _suffixed(out, "ensemble_", f"_{n}", cell)

    n = depth.n_sppt
    off = measure(models.get("T30"), n, pick_member_chunk(n, p30),
                  depth.sppt)
    _log(_describe(f"T30 ensemble {n} without SPPT", off, card))
    on = measure(models.get("T30", sppt_on=True), n,
                 pick_member_chunk(n, p30), depth.sppt)
    _log(_describe(f"T30 ensemble {n} with SPPT", on, card))
    out[f"ensemble_msps_{n}_sppt"] = on["msps_median"]
    out["sppt_overhead_pct"] = 100.0 * (off["msps_median"]
                                        / on["msps_median"] - 1.0)
    _suffixed(out, "ensemble_", f"_{n}_sppt", on)

    n = depth.n_hires
    for preset in ("T47", "T63"):
        p = models.params(preset)
        cell = measure(models.get(preset), n, pick_member_chunk(n, p),
                       depth.hires_ensemble)
        _log(_describe(f"{preset} ensemble {n}", cell, card))
        key = preset.lower()
        out[f"{key}_ensemble_msps_{n}"] = cell["msps_median"]
        _suffixed(out, f"{key}_ensemble_", f"_{n}", cell)
    p63 = models.params("T63")
    cell = measure(models.get("T63"), 1, 1, depth.hires_single)
    _log(_describe("T63 single member", cell, card))
    out["t63_sypd_1member"] = sypd(cell["msps_median"], p63.nsteps)
    _suffixed(out, "t63_single_", "", cell)
    return out


def sweep(models: Models, depth: Depth, card: str) -> dict:
    """The member chunk width by preset: {preset: {"members", "widths":
    {width: cell}, "best"}}."""
    result = {}
    for preset, (n, widths) in depth.sweep_cases:
        cells = {}
        for w in widths:
            cells[w] = measure(models.get(preset), n, w, depth.sweep)
            _log(_describe(f"sweep {preset}, chunk {w}", cells[w], card))
        best = max(cells, key=lambda w: cells[w]["msps_median"])
        _log(f"sweep {preset}: {n} members, fastest chunk width {best} "
             f"({cells[best]['msps_median']:.1f} member-steps/s) [{card}]")
        result[preset] = {"members": n, "widths": cells, "best": best}
    return result


def scaling_worker(rank: int, world: int, device: str, backend: str,
                   init: str, per_rank: int, n_steps: int, windows: int,
                   path: str) -> None:
    """One rank of the weak-scaling line: per_rank members of an ensemble
    mesh of `world` ranks, one discarded and `windows` timed windows of
    n_steps; rank 0 writes {"msps", "world"} to `path`."""
    import torch.distributed as dist

    from .models import model as M
    from .parallel import distributed as D
    from .parallel.ensemble import make_run_steps_batched
    from .testing import make_demo_model

    if device == "cpu":
        torch.set_num_threads(1)
    D.initialize_distributed(init, world, rank, backend, device)
    dev = D.rank_device()
    mesh = D.make_hybrid_mesh(1)
    consts, state, cal = make_demo_model(
        Models(device).params("T30"), device=dev, n_months=N_MONTHS)
    local = D.make_global_ensemble(state, per_rank * world, mesh)
    run = make_run_steps_batched(consts, device=dev, mesh=mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    first, walls = 2, []
    for w in range(1 + windows):
        ctx, cal = M.build_step_ctx(cal, first, n_steps)
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        local = run(local, ctx)
        sync()
        wall = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                            device=dev)
        dist.all_reduce(wall, op=dist.ReduceOp.MAX)
        if w:
            walls.append(float(wall))
        first += n_steps
    if rank == 0:
        with open(path, "w") as f:
            json.dump({"msps": per_rank * world * n_steps
                       / statistics.median(walls), "world": world}, f)
    dist.barrier()
    dist.destroy_process_group()


def scaling(device: str, depth: Depth, card: str) -> dict:
    """bench_scaling.py's line: member-steps/s on one rank and, with
    several cards, on one rank per card; efficiency rate_n / (n rate_1)."""
    from .parallel.launch_multihost import free_port, run_workers

    n_dev = torch.cuda.device_count() if device == "cuda" else 1
    backend = "nccl" if device == "cuda" else "gloo"
    n_steps = max(1, round(depth.ensemble[2] * 36))
    rates = {}
    for world in sorted({1, n_dev}):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "rate.json")
            codes = run_workers(scaling_worker, world, (
                world, device, backend, f"tcp://127.0.0.1:{free_port()}",
                depth.members_per_device, n_steps, depth.ensemble[1], path))
            if any(codes):
                raise RuntimeError(f"scaling run on {world} ranks: exit "
                                   f"codes {codes}")
            with open(path) as f:
                rates[world] = json.load(f)["msps"]
        _log(f"weak scaling: {world} rank(s) x {depth.members_per_device} "
             f"members over {backend}: {rates[world]:.1f} member-steps/s "
             f"[{card}]")
    eff = rates[n_dev] / (n_dev * rates[1]) if n_dev > 1 else None
    return {"scaling_metric": f"ensemble_weak_scaling_efficiency_{n_dev}dev",
            "scaling_msps_1dev": rates[1],
            f"scaling_msps_{n_dev}dev": rates[n_dev],
            "efficiency": eff, "scaling_backend": backend}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sweep", action="store_true",
                    help="time the member chunk widths (instead of the "
                         "cells)")
    ap.add_argument("--scaling", action="store_true",
                    help="the weak-scaling line over the cards (instead "
                         "of the cells)")
    ap.add_argument("--tiny", action="store_true",
                    help="windows of a few steps, ensembles of a few "
                         "members")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("the bench runs on a CUDA device (--device cpu for the "
                     "plain path): torch.cuda.is_available() is False")
        from .ops.column_kernels import build_kernels
        from .utils.profiling import nvidia_smi_line
        build_kernels()
        card = nvidia_smi_line()
    else:
        card = "cpu"
    depth = TINY if a.tiny else Depth()
    models = Models(a.device)
    out = {"card": card, "device": a.device,
           "precision": models.params("T30").precision}
    if not (a.sweep or a.scaling):
        out.update(bench(models, depth, card))
    if a.sweep:
        out["sweep"] = sweep(models, depth, card)
    if a.scaling:
        out.update(scaling(a.device, depth, card))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
