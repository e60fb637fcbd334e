#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``pyspeedy_tpu_torch/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card at the shapes the
model gives it (the two column kernels, their bfloat16-output instantiations,
the fused spectral transforms in float32, float64 and the 2-byte operand
mode, alone and in the step's groups of fields (each group bitwise equal to
its fields launched one by one), the four probe stages (the direct
transform stopped after each stage) at 256 and 9,344 rows with the stage
attribution of the direct transform, the spectral update in float32 and
float64 on random inputs and on the model's own state, the DFT chain at the
JAX tool's shapes, a member alone bitwise as in the batch), drives the
port's paths through the public entry points (the member-batched
dynamics-only T30L8 model at a reduced depth; the main path:
the full-physics T30L8 model, initialization and one model day of 128
members; the bf16_tendencies configuration at a reduced depth, and at
T47 and T63 a day of 128 members (row 3 with a bfloat16 grid bitwise the
float32 / float64 kernel on the widened grid, rows 1-2 with bfloat16
outputs from float32 and float64, float64 with the flag against the CPU);
the SPPT path: the full-physics model with stochastic physics, one day of
128 members, and SPPT's noise kernel (csrc/sppt_noise.cu) at the SPPT
cell's chunk of 1,024 members and 8 steps against its bound and the plain
passes, float32 and float64; the API: ``Speedy`` in float64 for a day from
the bundled boundary conditions, held against the golden fixture, and ``SpeedyEns``
with SPPT (and with bf16_tendencies), batched against member by member;
the probe stages on the model's own
fields; the DFT chain through its entry point; the explicit gravity-wave
branch, alph = 0 at 144 steps a day, a day of 128 members, with no
spectral-update launch, a member alone bitwise equal to it in a batch and
float64 against the CPU; the T47L8 and T63L8 presets, rows 1, 2, 6 and the
T47/T63 transform kernels (rows 3-4, csrc/fused_transform_hires.cu, against
the einsum chain in float32 and float64, alone and as the step's groups) at
their shapes and a day of 128 members through them, member 0 bitwise the
same member run alone and the graph day bitwise the eager day, float64
against the CPU; the multi-device phase: rows 1 and 2 at the band shapes
of 24 and 12 latitudes, then four ranks of ``pyspeedy_tpu_torch.parallel``
(one process each, gloo on a shared card, nccl with a card each) on the
("ensemble", "space") meshes 4x1, the main path's day bitwise or within its
limit and the main path's launches on every rank, and 2x2, latitude bands
with one all_reduce per direct transform group, float32 and float64 against
the unsharded runs; the climatology check of the port's
validate_climatology at T30 through Speedy; a trace of a 3-step window of
the main path through utils.profiling, which must name the step's kernels
and count its steps in the span table),
checks the results and the exact launch counts of every path (for the
transforms, launches and fields apart), and that no plain version ran on the
card, and prints what it measured. Every model path runs through the
batched runner's CUDA graphs (parallel/ensemble.py::StepGraphs), as a
user's run call on the card takes them: their wrapper counts are those of
the initialization and of each step kind's eager warm-up and captures; the
main path's graph day runs under the profiler, and its kernels' launches
(the ``kernels`` line's ``launches``) are the initialization's and that
day's device records, held to every step's; each path's graph day is then held bitwise to the eager loop's day of the same
runner (eager=True, whose counts are every step's), the two modes are timed
in turns (graph, eager, eager, graph) and profiled, the profiler's records
of each window held to the launches the window makes, and the graphs'
capture seconds and memory printed ("graphs, ..." lines and a
``{"graphs": ...}`` JSON line), with the copies into the graphs' buffers a
step and the profiler's copy records by name (every path fails if its
profiled graph window holds more copy records a step over the eager
window's than the runner counts, StepGraphs.stats["copies"]; the main path
fails if its graph steps copy other than coupling/coupler.py::STEP_COPIES
and the daily forcing's fields); the multi-device phase keeps the eager loop
(a mesh does) and says so. Among what it prints: the registers, occupancy and
SASS float/double conversions of the physics and spectral-update kernels,
the physics kernel on the model's state after a day, the spectral update at
B=1 and across member tiles (bitwise). It needs a CUDA
device and exits non-zero without one; there is no CPU fallback. Every phase
that fails raises, so the run exits non-zero.

Output: one line (or a few) per phase; the wall time of each phase
(utils.profiling.PhaseTimer); a ``{"graphs": ...}`` and a
``{"kernels": [...]}`` JSON line;
the card's name and power limit as nvidia-smi gives them; and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

from pyspeedy_tpu_torch import Speedy, SpeedyEns
from pyspeedy_tpu_torch.callbacks import XarrayExporter
from pyspeedy_tpu_torch.models import model as M
from pyspeedy_tpu_torch.models import spectral_glue as SG
from pyspeedy_tpu_torch.models.implicit import build_implicit
from pyspeedy_tpu_torch.models.tendencies import (grid_dynamics_core,
                                                  grid_tendency_specs)
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import dft_chain as DC
from pyspeedy_tpu_torch.ops import glue_kernels as GK
from pyspeedy_tpu_torch.ops import spectral as S
from pyspeedy_tpu_torch.ops import sppt_noise as SN
from pyspeedy_tpu_torch.ops import transform_kernels as tk
from pyspeedy_tpu_torch.parallel import distributed as PDIST
from pyspeedy_tpu_torch.parallel import mesh as PMESH
from pyspeedy_tpu_torch.parallel import shard_transforms as PST
from pyspeedy_tpu_torch.coupling.coupler import STEP_COPIES
from pyspeedy_tpu_torch.coupling.forcing import FORCING_FIELDS
from pyspeedy_tpu_torch.parallel.ensemble import (broadcast_state,
                                                   make_run_steps_batched,
                                                   takes_graphs)
from pyspeedy_tpu_torch.parallel.launch_multihost import (free_port,
                                                          run_workers)
from pyspeedy_tpu_torch.params import T30L5, T30L8, T47L8, T63L8
from pyspeedy_tpu_torch.physics import driver as PD
from pyspeedy_tpu_torch.physics import sppt as SP
from pyspeedy_tpu_torch.testing import make_demo_model
from pyspeedy_tpu_torch.utils.dataset import open_dataset
from pyspeedy_tpu_torch.utils.profiling import (SPANS, PhaseTimer,
                                                kernel_device_ms,
                                                nvidia_smi_line,
                                                window_profile)

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 / float64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# bfloat16 products run in the tensor cores (dense rate, same data sheet).
PEAK_FLOPS_BF16 = 989e12
# float64 products on the FP64 tensor cores (DMMA; same data sheet): the
# DFT chain's float64 kernel runs there.
PEAK_FLOPS_F64_TENSOR = 67e12
# The tensor-core rates of rows 3-4 at T47/T63: DMMA in float64, and in
# float32 3xTF32, three TF32 products (495 TFLOP/s, same data sheet) for
# each float one.
PEAK_FLOPS_TENSOR = {torch.float32: 495e12 / 3,
                     torch.float64: PEAK_FLOPS_F64_TENSOR}
# Integer instructions a clock an SM on the INT32 pipe (16 lanes in each of
# an SM's four partitions; NVIDIA's Hopper architecture white paper).
INT32_PER_SM_CLOCK = 64
# SPPT's noise (csrc/sppt_noise.cu), an element: threefry2x32's 20 rounds of
# an add, a rotate and a xor, the key's two adds before them and five
# injections of two, the index's add; of them the rotates (funnel shifts)
# and xors only the INT32 pipe issues (an add may go to the FMA pipe as an
# IMAD).
SPPT_NOISE_INT_OPS = 20 * 3 + 2 + 5 * 2 + 1
SPPT_NOISE_INT_PIPE_OPS = 20 * 2

N_MEMBERS = 128
# Rows 3-4 at T47/T63 (csrc/fused_transform_hires.cu): every device kernel,
# and those one wrapper call launches by shape and type (the library's plan,
# ops/transform_kernels.py::hires_kernel_plan): one kernel on thread-block
# clusters a direction.
HIRES_KERNEL_NAMES = ("hires_direct_cluster_kernel", "hires_inverse_ws_kernel")


def hires_kernels(sp, direction: str) -> tuple:
    """The device kernels of rows 3-4 one call launches at sp's shape and
    type, direction "direct" or "inverse"."""
    return tk.hires_kernel_plan(sp)[f"{direction}_kernels"]
N_STEPS = 36            # one model day at T30
N_STEPS_DYN = 12        # depth of the dynamics-only path
N_STEPS_BF16 = 12       # depth of the bf16_tendencies path
N_STEPS_PROFILED = 12   # profiled windows of the graphs against the eager loop
N_PROBE_ROWS = 256      # rows of the probe stages' comparison
N_PROBE_ROWS_STEP = 9344   # the step's direct group at B=128: 128 x 73 fields
N_DFT_MEMBERS = 256     # members of the DFT chain (the JAX tool's default)
N_ENS = 16              # members of the SpeedyEns phase
# The explicit gravity-wave branch (alph < 0.5) at T30: 144 steps a day
# (dt = 600 s); at 108 steps a day it blows up within a day
# (tests/test_torch_explicit.py).
EXPLICIT = {"alph": 0.0, "nsteps": 144}
N_STEPS_F64_EXPLICIT = 12   # depth of the explicit path's f64 card-vs-CPU run
N_STEPS_F64_PRESET = 6      # depth of the presets' f64 card-vs-CPU runs
# The JAX package's plausibility checks of a climate, on the port: T30 f32
# through Speedy, two 30-day months (the first one spin-up).
CLIMATE_ARGS = ["--months", "2", "--f32"]
# The rtol ladder of tests/test_speedy.py, down to the fixtures' 1e-6.
FIXTURE_LADDER = (1e-1, 1e-2, 1e-3, 1e-4, 1e-6)
FIXTURE = Path(__file__).resolve().parent / "tests/fixtures/1982-01-02_0000.nc"
PHYS_NAMES = (("utend", "vtend", "ttend", "qtend") + PD.DIAG_FIELDS
              + PD.CACHE_FIELDS)
# Columns of a float32 comparison that may sit on a threshold of the physics
# (a convection or cloud top, a stability switch, nint(T)) and take the other
# branch in the kernel: counted, shown to agree in float64, and gated here.
F32_FLIP_CEILING = 20
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
OUT_NAMES = ("utend", "vtend", "ttend", "trtend", "psdt_g", "flux_ut",
             "flux_vt", "flux_qu", "flux_qv", "ke")


def time_ms(fn, reps: int, warmup: int = 3, windows: int = 5) -> float:
    """Time of one call of fn on the card: CUDA events around a run of
    `reps` calls enqueued back to back (so the host's share of one call
    overlaps the card's work on the previous one), median over `windows`
    such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_inputs(params, n_members: int, seed: int = 0, il=None):
    """Seeded grid fields of plausible magnitude at the model's shapes (`il`
    latitudes: a band's, or the sphere's)."""
    rng = np.random.default_rng(seed)
    kx, ix, ntr = params.kx, params.ix, params.ntr
    il = params.il if il is None else il
    mk = lambda k, scale, mean=0.0: torch.from_numpy(
        mean + scale * rng.standard_normal((n_members, k, il, ix))
    ).to("cuda", params.dtype).contiguous()
    return (mk(kx, 3e-5), mk(kx, 1e-5), mk(kx, 15.0, 250.0),
            mk(ntr * kx, 2.0, 5.0), mk(kx, 15.0), mk(kx, 10.0),
            mk(2, 2e-8))


def grid_dynamics_bound(params, n_members: int, args, outs):
    """Least time the card could take: the larger of bytes over the memory
    rate (each input read once, each output written once) and operations
    over the peak rate of the scalar type."""
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *outs))
    # Arithmetic per column, counted from grid_dynamics_core: about 70
    # operations per level, 11 per tracer level, 5 per column.
    ops = (n_members * args[0].shape[2] * params.ix
           * (params.kx * (70 + 11 * params.ntr) + 5))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[params.dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes


def check_kernel(params, n_members: int, limit: float, card: str,
                 n_space: int = 1):
    """Grid-dynamics kernel against its plain version on the card: all ten
    outputs; with n_space > 1 on the first of that many latitude bands
    (models.model.band_consts: the band's rcos and coriol)."""
    consts, _ = M.build_consts(params, device="cuda", physics_on=False)
    if n_space > 1:
        consts = M.band_consts(consts, n_space, 0)
    args = kernel_inputs(params, n_members, il=consts.sp.il)
    outs_k = ck.grid_dynamics_cuda(consts.col, *args)
    torch.cuda.synchronize()
    outs_p = grid_dynamics_core(consts.col, *args)
    errs = {}
    for name, a, b in zip(OUT_NAMES, outs_k, outs_p):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"grid_dynamics {name}: bad shape or values")
        errs[name] = float((a - b).abs().max() / b.abs().max())
    worst = max(errs.values())
    max_abs = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
    bound_ms, bound_by, nbytes = grid_dynamics_bound(
        params, n_members, args, outs_k)
    launch = lambda: ck.grid_dynamics_cuda(consts.col, *args)
    ms = kernel_device_ms(launch, "grid_dynamics_kernel")
    call_ms = time_ms(launch, reps=20)
    plain_ms = time_ms(lambda: grid_dynamics_core(consts.col, *args), reps=3,
                       warmup=1, windows=3)
    tag = f"T{params.trunc}L{params.kx} {params.precision} B={n_members}"
    if n_space > 1:
        tag += f" il={consts.sp.il} (band 0 of {n_space})"
    print(f"kernel grid_dynamics {tag}: max rel err vs plain {worst:.3e} "
          f"(limit {limit:.0e}), kernel {ms:.4f} ms on the card "
          f"({call_ms:.4f} ms per wrapper call, back to back), plain "
          f"{plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) "
          f"[{card}]")
    if not worst <= limit:
        raise RuntimeError(
            f"grid_dynamics kernel disagrees with its plain version: {errs}")
    return {"max_rel_err": worst, "max_abs_err": max_abs, "ms": ms,
            "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}



# ---------------------------------------------------------------------------
# The physics kernel against its plain version
# ---------------------------------------------------------------------------

def _qsat_np(ta, p):
    e = np.where(ta >= 273.16,
                 6.108e-3 * np.exp(17.269 * (ta - 273.16) / (ta - 35.86)),
                 6.108e-3 * np.exp(21.875 * (ta - 273.16) / (ta - 7.66)))
    return 622.0 * e / (p - 0.378 * e)


def random_physics_inputs(consts, n_members: int, seed: int = 0) -> dict:
    """Seeded random but plausible columns (a lapse-rate profile with noise,
    humidity from a random RH, half of the columns with a moist boundary
    layer so that convection fires) and boundary fields in the layouts the
    model hands over: shared (il, ix), zonal (il, 1) and its expanded views,
    member-batched (B, il, ix)."""
    p = consts.params
    kx, il, ix = p.kx, consts.sp.il, p.ix
    rng = np.random.default_rng(seed)
    fsg = np.asarray(consts.geom.fsg, dtype=np.float64)
    sh2, sh3 = (n_members, il, ix), (n_members, kx, il, ix)
    lev = lambda x: x[None, :, None, None]
    psa = 0.7 + 0.35 * rng.random(sh2)
    t_sfc = 260.0 + 40.0 * rng.random(sh2)
    ta = np.clip(t_sfc[:, None] - 60.0 * lev(1.0 - fsg)
                 + rng.normal(0, 3.0, sh3), 180.0, 330.0)
    qs = _qsat_np(ta, lev(fsg) * psa[:, None])
    rh = np.clip(0.15 + 0.9 * rng.random(sh3), 0.0, 1.1)
    moist = rng.random(sh2) < 0.5
    for k in (kx - 1, kx - 2):
        rh[:, k] = np.where(moist, 0.88 + 0.2 * rng.random(sh2), rh[:, k])
    rgas = (2.0 / 7.0) * 1004.0
    phi = np.zeros(sh3)
    phi[:, kx - 1] = rgas * ta[:, kx - 1] * 0.05
    for k in range(kx - 2, -1, -1):
        phi[:, k] = phi[:, k + 1] + rgas * 0.5 * (
            ta[:, k] + ta[:, k + 1]) * np.log(fsg[k + 1] / fsg[k])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        "cuda", p.dtype)
    zonal = lambda lo, hi: dev(lo + (hi - lo) * rng.random((il, 1)))
    fm = rng.random((il, ix))
    fmask = np.where(fm < 0.4, 0.0, np.where(fm > 0.7, 1.0, fm))
    alb_l = 0.1 + 0.5 * rng.random(sh2)
    alb_s = 0.07 + 0.5 * rng.random(sh2)
    sst = 271.0 + 30.0 * rng.random(sh2)
    bc = {
        "fmask_land": dev(fmask),
        "phis0": dev(fmask * 5000.0 * rng.random((il, ix))),
        "forog": dev(1.0 + 0.5 * rng.random((il, ix))),
        "sst_am": dev(sst), "alb_land": dev(alb_l), "alb_sea": dev(alb_s),
        "alb_surface": dev(alb_s + fmask * (alb_l - alb_s)),
        "snowc": dev(rng.random(sh2)),
        "land_temp": dev(250.0 + 50.0 * rng.random(sh2)),
        "soil_avail_water": dev(rng.random(sh2)),
        "zenit_correction": zonal(1.0, 2.0).expand(n_members, il, ix),
        "flux_solar_in": zonal(0.0, 450.0).expand(n_members, il, ix),
        "flux_ozone_upper": zonal(0.0, 3.0),
        "flux_ozone_lower": zonal(0.0, 3.0).expand(n_members, il, 1),
        "stratospheric_correction": zonal(0.0, 5.0).expand(il, ix),
        "ssti_om": dev(sst + rng.normal(0, 1.0, sh2)),
    }
    return {
        "args": (dev(rng.normal(0, 10, sh3)), dev(rng.normal(0, 8, sh3)),
                 dev(ta), dev(rh * qs), dev(phi), dev(np.log(psa)),
                 tuple(bc[n] for n in PD.BC_FIELDS), (),
                 torch.tensor(6.0, dtype=p.dtype, device="cuda")),
        "phisg": dev(fmask * 3000.0 * rng.random((il, ix))),
        "m0corr": dev(rng.normal(0, 30.0, (n_members, kx, il, 1))),
        "sppt": dev(np.clip(0.33 * rng.normal(0, 1, sh3), -0.95, 0.95)),
    }


def _flatten(result):
    return list(result[:4]) + list(result[4]) + list(result[5])


def _to64(x):
    if isinstance(x, tuple):
        return tuple(_to64(a) for a in x)
    return None if x is None else x.double()


def unique_bytes(x) -> int:
    """Bytes of a tensor's distinct elements (a broadcast axis counts once)."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        if stride != 0:
            n *= size
    return n * x.element_size()


def physics_bound(params, sw_flag, args, kwargs, result):
    """Least time the card could take for this call: the larger of bytes over
    the memory rate and operations over the peak rate. Each input is counted
    once as far as the function reads it (of u and v only the lowest level;
    of the cache on a step without shortwave tt_rsw, rad_tau2, rad_strat_corr
    and ssrd), each output once (on a step without shortwave the cache is not
    written)."""
    ug, vg, tg, qg, phig, pslg, bc, cache, ablco2 = args
    nbytes = (unique_bytes(ug) + unique_bytes(vg)) // params.kx
    for x in (tg, qg, phig, pslg, *bc, kwargs.get("phisg"),
              kwargs.get("m0corr"), kwargs.get("sppt_pattern")):
        if x is not None:
            nbytes += unique_bytes(x)
    if not sw_flag:
        nbytes += sum(unique_bytes(cache[n]) for n in (0, 1, 2, 4))
    outs = list(result[:4]) + list(result[4])
    if sw_flag:
        outs += list(result[5])
    nbytes += sum(unique_bytes(x) for x in outs)
    # Arithmetic per column, counted from grid_physics: about 190 operations
    # per level without shortwave and 120 more with it (an exponential taken
    # as 20), 150 per column for the surface fluxes.
    per_level = 310 if sw_flag else 190
    ops = (tg.shape[0] * tg.shape[2] * params.ix
           * (params.kx * per_level + 150))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[params.dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes


def compare_physics(consts, sw_flag, args, kwargs, limit, tag):
    """One call of the kernel against the plain version on the same inputs.
    Returns (plain result, kernel result, worst relative error, number of
    columns over the limit). Errors are relative to each output's largest
    value. In float64 no column may exceed the limit. In float32 a column
    that does is run again in float64 through both: it must agree there
    (then it sat on a threshold), and at most F32_FLIP_CEILING may do so."""
    want = PD.grid_physics(consts, sw_flag, *args, **kwargs)
    got = ck.grid_physics_cuda(consts, sw_flag, *args, **kwargs)
    torch.cuda.synchronize()
    worst, worst_name, over, bad = 0.0, "", {}, None
    for name, g, w in zip(PHYS_NAMES, _flatten(got), _flatten(want)):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"grid_physics {tag} {name}: bad shape or "
                               f"non-finite values")
        err = (g - w).abs() / (float(w.abs().max()) or 1.0)
        worst_here = float(err.max())
        b = err.reshape(g.shape[0], -1, *g.shape[-2:]).amax(1) > limit
        bad = b if bad is None else bad | b
        if worst_here > limit:
            over[name] = worst_here
        elif worst_here > worst:
            worst, worst_name = worst_here, name
    n_bad = int(bad.sum())
    compare_physics.worst_field = worst_name
    if n_bad == 0:
        return want, got, worst, 0
    if consts.params.dtype == torch.float64 or n_bad > F32_FLIP_CEILING:
        raise RuntimeError(
            f"grid_physics {tag}: {n_bad} columns over {limit:g}: {over}")
    # float32: the same inputs, widened, through both versions in float64.
    band = consts.sp.band
    c64 = check_physics.consts64[consts.params.trunc, consts.params.kx,
                                 consts.sea_coupling_flag,
                                 band.n_space if band else 1]
    a64, k64 = _to64(args), {k: _to64(v) for k, v in kwargs.items()}
    w64 = PD.grid_physics(c64, sw_flag, *a64, **k64)
    g64 = ck.grid_physics_cuda(c64, sw_flag, *a64, **k64)
    torch.cuda.synchronize()
    for name, g, w in zip(PHYS_NAMES, _flatten(g64), _flatten(w64)):
        e64 = float(((g - w).abs() / (float(w.abs().max()) or 1.0)).max())
        if not e64 <= 1e-12:
            raise RuntimeError(
                f"grid_physics {tag}: {n_bad} float32 columns over the limit "
                f"and {name} disagrees in float64 too ({e64:.3e})")
    where = torch.nonzero(bad)[:4].tolist()
    print(f"  {tag}: {n_bad} of {bad.numel()} columns exceed {limit:g} in "
          f"float32 ({over}); the same inputs agree to 1e-12 in float64, so "
          f"they sit on a threshold or amplify a last-bit difference through "
          f"a cancellation; first (member, lat, lon): {where}; "
          f"ceiling {F32_FLIP_CEILING}")
    return want, got, worst, n_bad


def branch_shares(consts, pslg, want):
    """Share of columns with convection, with large-scale condensation, with
    cloud (a window-band transmissivity in the free troposphere below its
    clear-sky value) and with an unstable lowest layer (upward sensible heat
    flux over sea), from a plain shortwave result."""
    diag, cache = want[4], want[5]
    cbmf, precls, shf = diag[0], diag[2], diag[8]
    dhs = torch.as_tensor(np.asarray(consts.geom.dhs, dtype=np.float64),
                          dtype=pslg.dtype, device=pslg.device)
    clear = torch.exp(-torch.exp(pslg)[:, None] * dhs[2:-1, None, None] * 0.3)
    cloudy = (cache[1][:, 0, 2:-1] < 0.9999 * clear).any(dim=1)
    return {"convection": float((cbmf > 0).float().mean()),
            "condensation": float((precls > 0).float().mean()),
            "cloud": float(cloudy.float().mean()),
            "unstable surface layer": float((shf[:, 1] > 0).float().mean())}


def check_physics(params, n_members, limit, card, what, sea=0, inputs=None,
                  timed=False, n_space=1):
    """The physics kernel against its plain version on the card, both
    shortwave variants, in the modes `what` names: "phig" (geopotential
    read), "grid_phi" (integrated in the kernel), "sppt" (with a pattern);
    with n_space > 1 on the first of that many latitude bands
    (models.model.band_consts: the band's sqrtcoa and zonal fields).
    Returns {variant: measurements} for the last mode when `timed`."""
    band = lambda c: c if n_space == 1 else M.band_consts(c, n_space, 0)
    consts = band(M.build_consts(params, device="cuda",
                                 sea_coupling_flag=sea)[0])
    key64 = (params.trunc, params.kx, sea, n_space)
    if key64 not in check_physics.consts64:
        check_physics.consts64[key64] = band(M.build_consts(
            dataclasses.replace(params, precision="f64"), device="cuda",
            sea_coupling_flag=sea)[0])
    x = inputs or random_physics_inputs(consts, n_members)
    ug, vg, tg, qg, phig, pslg, bc, _, ablco2 = x["args"]
    res = {}
    for mode in what:
        kwargs = {}
        if mode == "grid_phi":
            phi_in = None
            kwargs = {"phisg": x["phisg"], "m0corr": x["m0corr"]}
        else:
            phi_in = phig if phig is not None else None
            if phi_in is None:   # inputs from a grid_phi model state
                kwargs = {"phisg": x["phisg"], "m0corr": x["m0corr"]}
        if mode == "sppt":
            kwargs["sppt_pattern"] = x["sppt"]
        tag = (f"T{params.trunc}L{params.kx} {params.precision} "
               f"B={tg.shape[0]} "
               + (f"il={tg.shape[2]} (band 0 of {n_space}) "
                  if n_space > 1 else "")
               + f"{x.get('source', 'random columns')} {mode} sea={sea}")
        args_sw = (ug, vg, tg, qg, phi_in, pslg, bc, (), ablco2)
        want, got, worst_sw, flips_sw = compare_physics(
            consts, True, args_sw, kwargs, limit, tag + " sw")
        cache = tuple(c.contiguous() for c in want[5])
        args_ns = (ug, vg, tg, qg, phi_in, pslg, bc, cache, ablco2)
        want_ns, got_ns, worst_ns, flips_ns = compare_physics(
            consts, False, args_ns, kwargs, limit, tag + " nosw")
        shares = branch_shares(consts, pslg, want)
        worst_field = compare_physics.worst_field
        print(f"kernel grid_physics {tag}: max rel err vs plain "
              f"{worst_sw:.3e} (shortwave) {worst_ns:.3e} (without, in "
              f"{worst_field}), limit "
              f"{limit:.0e}, columns over it {flips_sw}/{flips_ns}; columns "
              + ", ".join(f"{k} {100 * v:.1f}%" for k, v in shares.items()))
        if not timed:
            continue
        same_b1 = first_member_bitwise(consts, args_sw, kwargs, got) and \
            first_member_bitwise(consts, args_ns, kwargs, got_ns)
        if not same_b1:
            raise RuntimeError(f"grid_physics {tag}: member 0 alone differs "
                               f"from member 0 of the batch")
        print(f"  {tag}: member 0 alone (B=1) equals member 0 of B="
              f"{tg.shape[0]} bitwise, both variants")
        for sw_flag, a, w, g, worst, flips in (
                (True, args_sw, want, got, worst_sw, flips_sw),
                (False, args_ns, want_ns, got_ns, worst_ns, flips_ns)):
            launch = lambda: ck.grid_physics_cuda(consts, sw_flag, *a,
                                                  **kwargs)
            ms = kernel_device_ms(launch, "grid_physics_kernel")
            call_ms = time_ms(launch, reps=20)
            plain_ms = time_ms(
                lambda: PD.grid_physics(consts, sw_flag, *a, **kwargs),
                reps=2, warmup=1, windows=3)
            bound_ms, bound_by, nbytes = physics_bound(
                params, sw_flag, a, kwargs, g)
            max_abs = max(float((p - q).abs().max())
                          for p, q in zip(_flatten(g), _flatten(w)))
            name = "grid_physics_sw" if sw_flag else "grid_physics_nosw"
            print(f"  {name} {mode}: kernel {ms:.4f} ms on the card "
                  f"({call_ms:.4f} ms per wrapper call, back to back), plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({nbytes / 1e6:.1f} MB) = {100 * bound_ms / ms:.0f}% "
                  f"[{card}]")
            res[name] = {"max_rel_err": worst, "max_abs_err": max_abs,
                         "flipped_columns": flips, "ms": ms,
                         "call_ms": call_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
    return res


check_physics.consts64 = {}


def first_member_bitwise(consts, args, kwargs, got) -> bool:
    """The kernel on member 0 alone (B=1) against member 0 of its batched
    result `got`, bitwise: every output."""
    one = lambda x: (None if x is None else tuple(one(a) for a in x)
                     if isinstance(x, tuple) else x[:1] if x.dim() >= 3
                     else x)
    sw_flag = len(args[7]) == 0
    a1 = tuple(one(x) for x in args[:8]) + (args[8][:1] if args[8].dim() else
                                            args[8],)
    k1 = {k: one(v) if k != "phisg" else v for k, v in kwargs.items()}
    alone = ck.grid_physics_cuda(consts, sw_flag, *a1, **k1)
    torch.cuda.synchronize()
    return all(torch.equal(x, y[:1]) for x, y in zip(_flatten(alone),
                                                     _flatten(got)))


def state_physics_inputs(consts, state) -> dict:
    """Kernel inputs from a member-batched model state, as the step makes
    them (physics.driver.physics_grid_inputs), plus a seeded SPPT pattern."""
    args, kw = PD.physics_grid_inputs(consts, state, True)
    rng = np.random.default_rng(3)
    sppt = torch.from_numpy(np.clip(
        0.33 * rng.normal(0, 1, tuple(args[2].shape)), -0.95, 0.95)).to(
        "cuda", consts.params.dtype)
    return {"args": args, "phisg": kw["phisg"], "m0corr": kw["m0corr"],
            "sppt": sppt, "source": "model state after one day"}


# ---------------------------------------------------------------------------
# The fused transform kernels against their plain versions
# ---------------------------------------------------------------------------

def transform_bound(sp, nrows: int, direct: bool, in_dtype, launches: int = 1):
    """Least time the card could take for `nrows` field rows of one launch
    (or `launches` launches): the bytes, the grid rows, the spectral pairs
    and the two tables (once per launch) each moved once, over the memory
    rate. Beside it the dense operation figure, the first version's
    yardstick: a DFT of il x ix x 2mx and a block-structured Legendre stage
    of 2 x mx x nx x il multiply-adds per row at the peak rate of the
    operand type outside the tensor cores (bfloat16 in the tensor cores).
    Returns (bytes ms, "bytes", bytes, dense operation ms, operations)."""
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    work = sp.rdtype.itemsize
    grid_b = il * ix * (in_dtype.itemsize if direct else work)
    spec_b = 2 * mx * nx * work
    table_b = (2 * ix * mx + il * mx * nx) * (
        in_dtype.itemsize if direct else work)
    nbytes = nrows * (grid_b + spec_b) + launches * table_b
    ops = nrows * 2 * (il * ix * 2 * mx + 2 * mx * nx * il)
    peak = (PEAK_FLOPS_BF16 if in_dtype == torch.bfloat16
            else PEAK_FLOPS[sp.rdtype])
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes", nbytes, \
        1e3 * ops / peak, ops


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def transform_inputs(sp, nmem: int, k: int, seed: int):
    """A seeded (B, k, il, ix) grid and a (B, 2, k, mx, nx) spectral pair
    inside the transform triangle, on the card."""
    rng = np.random.default_rng(seed)
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    tri = (np.arange(mx)[:, None] + np.arange(nx)[None] <= mx).astype(float)
    g = torch.from_numpy(rng.standard_normal((nmem, k, il, ix)))
    p = torch.from_numpy(rng.standard_normal((nmem, 2, k, mx, nx)) * tri)
    return g.to("cuda", sp.rdtype), p.to("cuda", sp.rdtype)


def step_groups(sp, params, nmem: int, seed: int, grid_dtype=None):
    """The step's three transform groups, seeded, in the shapes and layouts
    the call sites build them (models/tendencies.py, physics/driver.py with
    grid_phi): the dynamics' 7 inverse stacks (a tracer stack flattened, the
    stacked log-ps gradient), the physics' 5 (u, v with kcos 2, T, the
    humidity block of the tracer stack, log ps) and the 7 + 3 ntr direct
    fields (psdt, winds, fluxes, level slices of the tracer flux stacks).
    Returns {name: (kind, fields, kcos)}."""
    rng = np.random.default_rng(seed)
    kx, ntr = params.kx, params.ntr
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    tri = torch.from_numpy((np.arange(mx)[:, None] + np.arange(nx)[None]
                            <= mx).astype(float)).to("cuda", sp.rdtype)
    spec = lambda *s: torch.from_numpy(rng.standard_normal(
        (nmem, 2) + s + (mx, nx))).to("cuda", sp.rdtype) * tri
    grid = lambda *s: torch.from_numpy(rng.standard_normal(
        (nmem,) + s + (il, ix))).to("cuda", grid_dtype or sp.rdtype)
    tr = spec(ntr, kx)
    pxy = torch.stack([spec(), spec()], dim=2)
    flux_qu, flux_qv, trtend = (grid(ntr * kx) for _ in range(3))
    direct = [grid(), grid(kx), grid(kx), grid(kx), grid(kx)]
    for i in range(ntr):
        direct += [flux_qu[:, i * kx:(i + 1) * kx],
                   flux_qv[:, i * kx:(i + 1) * kx]]
    direct += [grid(kx), grid(kx)]
    direct += [trtend[:, i * kx:(i + 1) * kx] for i in range(ntr)]
    return {
        "inverse, dynamics": ("inverse", [spec(kx), spec(kx), spec(kx),
                                          tr.flatten(2, 3), spec(kx),
                                          spec(kx), pxy], [1] * 7),
        "inverse, physics": ("inverse", [spec(kx), spec(kx), spec(kx),
                                         tr[:, :, 0], spec()],
                             [2, 2, 1, 1, 1]),
        "direct": ("direct", direct, None),
    }


def group_rows(fields, direct: bool) -> int:
    return sum(x.numel() // (x.shape[-1] * x.shape[-2] * (1 if direct else 2))
               for x in fields)


def plain_of(sp, kind):
    """The plain version of rows 3-4 (kind "direct" or "inverse") at sp's
    shape: the dense chain at T30, the einsum chain at T47/T63."""
    hires = (sp.il, sp.ix, sp.mx, sp.nx) in tk.HIRES_SHAPES
    if kind == "direct":
        return tk.grid2spec_hires_plain if hires else tk.grid2spec_plain
    return tk.spec2grid_hires_plain if hires else tk.spec2grid_plain


def check_group(sp, kind, fields, kcos, limit):
    """One group launched once against the plain chain field by field and
    against its fields launched one by one (bitwise). Returns (worst rel
    err, max abs err)."""
    plain_fn = plain_of(sp, kind)
    if kind == "direct":
        many = tk.fused_grid2spec_many_cuda(sp, fields, 1)
        alone = [tk.fused_grid2spec_cuda(sp, f, 1) for f in fields]
        plain = [plain_fn(sp, f, 1) for f in fields]
    else:
        many = tk.fused_spec2grid_many_cuda(sp, fields, kcos, 1)
        alone = [tk.fused_spec2grid_cuda(sp, f, k, 1)
                 for f, k in zip(fields, kcos)]
        plain = [plain_fn(sp, f, k, 1) for f, k in zip(fields, kcos)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(many, alone)):
        raise RuntimeError(f"a {kind} group differs from its fields "
                           f"launched one by one")
    worst = max(_rel(a, b) for a, b in zip(many, plain))
    if not worst <= limit:
        raise RuntimeError(f"a {kind} group disagrees with the plain chain: "
                           f"{worst:.3e} (limit {limit:g})")
    return worst, max(float((a - b).abs().max()) for a, b in zip(many, plain))


def time_group(sp, sp_fft, name, kind, fields, kcos, card, tag):
    """Device time of one launch of a group, a wrapper call back to back,
    the plain chain field by field (the cuBLAS yardstick) and the fft route
    field by field, against the bytes bound."""
    direct = kind == "direct"
    if direct:
        launch = lambda: tk.fused_grid2spec_many_cuda(sp, fields, 1)
        plain = lambda: [tk.grid2spec_plain(sp, f, 1) for f in fields]
        fft = lambda: [S.grid2spec_p(sp_fft, f.to(sp.rdtype), 1)
                       for f in fields]
        kern = "grid2spec_fold_kernel"
    else:
        launch = lambda: tk.fused_spec2grid_many_cuda(sp, fields, kcos, 1)
        plain = lambda: [tk.spec2grid_plain(sp, f, k, 1)
                         for f, k in zip(fields, kcos)]
        fft = lambda: [S.spec2grid_p(sp_fft, f, k, 1)
                       for f, k in zip(fields, kcos)]
        kern = "spec2grid_fold_kernel"
    rows = group_rows(fields, direct)
    ms = kernel_device_ms(launch, kern, reps=10)
    call_ms = time_ms(launch, reps=10)
    plain_ms = time_ms(plain, reps=3, warmup=1, windows=3)
    fft_ms = time_ms(fft, reps=3, warmup=1, windows=3)
    bound_ms, _, nbytes, ops_ms, _ = transform_bound(
        sp, rows, direct, fields[0].dtype)
    print(f"  group {name} {tag}: {len(fields)} fields, {rows} rows, one "
          f"launch: kernel {ms:.4f} ms on the card ({call_ms:.4f} ms per "
          f"wrapper call, back to back), the plain cuBLAS chain field by "
          f"field {plain_ms:.4f} ms, the fft route field by field "
          f"{fft_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes "
          f"({nbytes / 1e6:.1f} MB) = {100 * bound_ms / ms:.0f}%; dense "
          f"operation figure {ops_ms:.4f} ms [{card}]")
    return {"fields": len(fields), "rows": rows, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "fft_route_ms": fft_ms,
            "bound_ms": bound_ms}


def check_transforms(params, limit: float, card: str):
    """Both fused transform kernels against their plain versions (the dense
    matmul chain, which is also the library yardstick) at 1, 128, 256 and
    1,024 rows, in the strided layouts the step passes and in the step's
    three groups (each group bitwise equal to its fields launched one by
    one); timed at one kx stack of 128 members (1,024 rows) and as the
    step's groups at B=128; beside them the same transforms through the
    torch.fft route."""
    consts, _ = M.build_consts(params, device="cuda", physics_on=False)
    sp = consts.sp
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    kx = params.kx
    prec = params.precision
    worst_d = worst_i = abs_d = abs_i = 0.0
    for nmem, k in ((N_MEMBERS, kx), (N_MEMBERS, 1), (1, 1), (N_MEMBERS, 2)):
        g, p = transform_inputs(sp, nmem, k, seed=nmem + k)
        got_d = tk.fused_grid2spec_cuda(sp, g, 1)
        want_d = tk.grid2spec_plain(sp, g, 1)
        worst_d = max(worst_d, _rel(got_d, want_d))
        abs_d = max(abs_d, float((got_d - want_d).abs().max()))
        for kcos in (1, 2):
            got_i = tk.fused_spec2grid_cuda(sp, p, kcos, 1)
            want_i = tk.spec2grid_plain(sp, p, kcos, 1)
            if not got_i.is_contiguous():
                raise RuntimeError("fused_spec2grid: output not dense")
            worst_i = max(worst_i, _rel(got_i, want_i))
            abs_i = max(abs_i, float((got_i - want_i).abs().max()))
    # Layouts as the step passes them: a tracer's level block of the
    # (B, 2, ntr, kx, mx, nx) stack, a freshly broadcast state (member
    # stride 0), a tracer's slice of a (B, ntr*kx, il, ix) flux stack.
    g, p = transform_inputs(sp, 16, 3 * kx, seed=5)
    tr = p.reshape(16, 2, 3, kx, mx, nx)[:, :, 1]
    shared = p[:1, :, :kx].expand(5, 2, kx, mx, nx)
    flux = g[:, kx:2 * kx]
    strided = max(_rel(tk.fused_spec2grid_cuda(sp, tr, 1, 1),
                       tk.spec2grid_plain(sp, tr, 1, 1)),
                  _rel(tk.fused_spec2grid_cuda(sp, shared, 2, 1),
                       tk.spec2grid_plain(sp, shared, 2, 1)),
                  _rel(tk.fused_grid2spec_cuda(sp, flux, 1),
                       tk.grid2spec_plain(sp, flux, 1)))
    # The step's three groups at B=128, each bitwise equal to its fields
    # launched one by one.
    groups = step_groups(sp, params, N_MEMBERS, seed=8)
    group_err = {name: check_group(sp, kind, fields, kcos, limit)[0]
                 for name, (kind, fields, kcos) in groups.items()}
    # Garbage in the imaginary part of m = 0 changes nothing in the inverse.
    g, p = transform_inputs(sp, 4, kx, seed=6)
    p = S.truncate(sp, p)
    p[:, 1, :, 0, :] = 0.0
    dirty = p.clone()
    dirty[:, 1, :, 0, :] = 1e3 * torch.randn(4, kx, nx, device="cuda",
                                             dtype=sp.rdtype)
    clean_g = tk.fused_spec2grid_cuda(sp, p, 1, 1)
    if not torch.equal(tk.fused_spec2grid_cuda(sp, dirty, 1, 1), clean_g):
        raise RuntimeError("fused_spec2grid reads the m=0 imaginary part")
    # Round trip of a truncated field: back to its input as far as the
    # reference's quadrature lets it (the pair is not exactly orthogonal:
    # Gaussian nodes rounded to float32), and equal to the plain round trip.
    back = tk.fused_grid2spec_cuda(sp, clean_g, 1)
    trip = _rel(back, p)
    trip_plain = _rel(back, tk.grid2spec_plain(
        sp, tk.spec2grid_plain(sp, p, 1, 1), 1))
    torch.cuda.synchronize()
    tag = f"T30L{kx} {prec}"
    print(f"kernel fused_grid2spec / fused_spec2grid {tag}: max rel err vs "
          f"plain {worst_d:.3e} / {worst_i:.3e} over 1,024, 128, 1 and 256 "
          f"rows ((B, k) = (128, {kx}), (128, 1), (1, 1), (128, 2)), kcos 1 "
          f"and 2; strided layouts {strided:.3e}; the step's groups "
          + ", ".join(f"{n} {e:.3e}" for n, e in group_err.items())
          + f", each bitwise equal to its fields launched one by one (limit "
          f"{limit:.0e}); m=0 imaginary garbage: bitwise no effect; round "
          f"trip of a truncated field {trip:.3e} (limit 2e-2), vs the plain "
          f"round trip {trip_plain:.3e}")
    if not max(worst_d, worst_i, strided, trip_plain,
               *group_err.values()) <= limit:
        raise RuntimeError("a fused transform kernel disagrees with its "
                           "plain version")
    if not trip <= 2e-2:
        raise RuntimeError(f"round trip error {trip:.3e}")

    # Times at one kx stack of 128 members (1,024 rows), then of the groups.
    g, p = transform_inputs(sp, N_MEMBERS, kx, seed=7)
    nrows = N_MEMBERS * kx
    sp_fft = S.build_spectral(params, M.build_geometry(params),
                              use_matmul_fft=False, device="cuda")
    res = {}
    for name, kern, launch, plain, fft, worst, max_abs, direct in (
            ("fused_grid2spec", "grid2spec_fold_kernel",
             lambda: tk.fused_grid2spec_cuda(sp, g, 1),
             lambda: tk.grid2spec_plain(sp, g, 1),
             lambda: S.grid2spec_p(sp_fft, g, 1), worst_d, abs_d, True),
            ("fused_spec2grid", "spec2grid_fold_kernel",
             lambda: tk.fused_spec2grid_cuda(sp, p, 1, 1),
             lambda: tk.spec2grid_plain(sp, p, 1, 1),
             lambda: S.spec2grid_p(sp_fft, p, 1, 1), worst_i, abs_i, False)):
        ms = kernel_device_ms(launch, kern)
        call_ms = time_ms(launch, reps=20)
        plain_ms = time_ms(plain, reps=10, warmup=2, windows=3)
        fft_ms = time_ms(fft, reps=10, warmup=2, windows=3)
        bound_ms, bound_by, nbytes, ops_ms, ops = transform_bound(
            sp, nrows, direct, sp.rdtype)
        print(f"  {name} {tag} {nrows} rows: the same transform through the "
              f"fft route (torch.fft + Legendre einsum) {fft_ms:.4f} ms")
        print(f"  {name} {tag} {nrows} rows: kernel {ms:.4f} ms on the card "
              f"({call_ms:.4f} ms per wrapper call, back to back), plain = "
              f"library (dense cuBLAS chain) {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} MB) = "
              f"{100 * bound_ms / ms:.0f}%; the first version's yardstick, "
              f"the dense operation figure: {ops_ms:.4f} ms ({ops / 1e9:.2f} "
              f"GFLOP at {PEAK_FLOPS[sp.rdtype] / 1e12:.0f} TFLOP/s) = "
              f"{100 * ops_ms / ms:.0f}% [{card}]")
        res[name] = {"max_rel_err": worst, "max_abs_err": max_abs, "ms": ms,
                     "call_ms": call_ms, "plain_ms": plain_ms,
                     "library_ms": plain_ms, "fft_route_ms": fft_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "groups": {}}
    for name, (kind, fields, kcos) in groups.items():
        key = "fused_grid2spec" if kind == "direct" else "fused_spec2grid"
        res[key]["groups"][name] = time_group(sp, sp_fft, name, kind, fields,
                                              kcos, card, tag)
    return res


def hires_bound(sp, nrows: int, direct: bool, grid_bytes=None):
    """Least time the card could take for `nrows` field rows of rows 3-4 at
    T47/T63: the larger of the bytes (grid rows, of `grid_bytes` an element
    (the tables' type's by default; 2 for a bfloat16 grid), and spectral
    pairs each moved once, the folded tables and the 1/cos column once) over
    the memory rate and the folded work the kernels do (il*mx*ix DFT and
    il*triangle
    Legendre multiply-adds a row, two operations each) at the peak rate of
    the type outside the tensor cores; and the same with the work at the
    tensor cores' rate (DMMA in float64, 3xTF32 in float32), where the
    kernels' DFT runs. Returns (bound ms, "bytes" or "operations", bytes ms,
    operations ms, bytes, operations, tensor-core bound ms, its "bytes" or
    "operations", operations ms at the tensor-core rate)."""
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    w = sp.rdtype.itemsize
    tri = mx * nx - mx * (mx - 1) // 2
    tables = (sp.fold_dir if direct else sp.fold_inv).numel() + (
        0 if direct else il)
    gw = w if grid_bytes is None else grid_bytes
    nbytes = nrows * (il * ix * gw + 2 * mx * nx * w) + tables * w
    ops = 2 * nrows * (il * mx * ix + il * tri)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_FLOPS[sp.rdtype]
    tc_ms = 1e3 * ops / PEAK_FLOPS_TENSOR[sp.rdtype]
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            bytes_ms, ops_ms, nbytes, ops, max(bytes_ms, tc_ms),
            "bytes" if bytes_ms >= tc_ms else "operations", tc_ms)


def hires_occupancy(libs, sp, trunc: int, prec: str) -> dict:
    """{device kernel: six numbers from the CUDA runtime} of the T47/T63
    kernels one shape and type runs, each on thread-block clusters (clusters
    the card holds at once, cudaOccupancyMaxActiveClusters; threads a block,
    shared memory a block, registers, local bytes, blocks a cluster),
    raising unless its threads, shared memory and cluster size are those of
    the library's plan (ops.transform_kernels.hires_kernel_plan) and its
    shared memory fits in a block. Raises unless the library's
    decomposition is the one the CPU tests model
    (ops.transform_kernels.hires_cluster_plan)."""
    import ctypes
    fn = ctypes.CDLL(str(libs["fused_transform_hires"])) \
        .pyspeedy_fused_transform_hires_occupancy
    plan = tk.hires_kernel_plan(sp)
    model = tk.hires_cluster_plan((sp.il, sp.ix, sp.mx, sp.nx), sp.rdtype)
    got = {k: plan[k] for k in ("cluster", "pairs_per_band", "rows_per_step",
                                "band_columns", "mma_k", "inverse_threads",
                                "inverse_pairs_per_item",
                                "inverse_rows_per_step", "direct_dft_warps",
                                "direct_legendre_warps", "direct_threads")}
    want = {k: model[k] for k in got}
    if got != want or plan["m_pairs"] != len(model["m_slices"][0]) // 2:
        raise RuntimeError(f"the library's plan at T{trunc} {prec} {plan} is "
                           f"not the modelled decomposition {model}")
    kinds = {"hires_direct_cluster_kernel": 0, "hires_inverse_ws_kernel": 1}
    out, rows = (ctypes.c_int * 6)(), {}
    for direction in ("direct", "inverse"):
        for name in plan[f"{direction}_kernels"]:
            rc = fn(kinds[name], trunc, 0 if prec == "f32" else 1, out)
            if rc != 0:
                raise RuntimeError(f"occupancy query of {name} at T{trunc} "
                                   f"{prec} failed with {rc}")
            rows[name] = tuple(out)
            want = (plan[f"{direction}_threads"], plan[f"{direction}_smem"],
                    plan["cluster"])
            if (out[1], out[2], out[5]) != want or out[2] > 227 * 1024:
                raise RuntimeError(f"{name} at T{trunc} {prec}: threads, "
                                   f"shared memory and cluster "
                                   f"{tuple(out)[1:]} against the plan's "
                                   f"{want}")
    return rows


def time_hires(sp, kind, launch, plain, rows: int) -> dict:
    """Device ms of one launch of rows 3-4 at T47/T63 (its kernel, from the
    profiler), a wrapper call back to back, the plain version (the einsum
    chain, which is also the library yardstick) and the bounds outside and
    on the tensor cores, for `rows` field rows."""
    per = {k: kernel_device_ms(launch, k, reps=10)
           for k in hires_kernels(sp, kind)}
    (bound_ms, bound_by, bytes_ms, ops_ms, nbytes, ops, tc_ms, tc_by,
     tc_ops_ms) = hires_bound(sp, rows, kind == "direct")
    ms = sum(per.values())
    return {"rows": rows, "ms": ms, "ms_by_kernel": per,
            "call_ms": time_ms(launch, reps=10),
            "plain_ms": time_ms(plain, reps=3, warmup=1, windows=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": nbytes,
            "flops": ops, "tc_bound_ms": tc_ms, "tc_bound_by": tc_by,
            "tc_ops_ms": tc_ops_ms}


def check_transforms_hires(params, limit: float, card: str, libs) -> dict:
    """Rows 3-4 at a T47/T63 shape (csrc/fused_transform_hires.cu) against
    their plain version, the einsum chain: at 1,024, 128, 1 and 256 rows,
    kcos 1 and 2, the strided layouts the step passes, the step's three
    groups at B=128 (each bitwise equal to its fields launched one by one),
    the imaginary part of m = 0 ignored, and a member alone bitwise the same
    member of the 1,024-row batch. Raises past `limit`. The device ms of
    each direction at 1,024 rows and as the step's groups, beside the einsum
    chain and the bounds. Returns {"fused_grid2spec_hires": ...,
    "fused_spec2grid_hires": ...}."""
    sp = S.build_spectral(params, M.build_geometry(params),
                          use_matmul_fft=True, device="cuda")
    if not sp.use_fused_kernels or sp.use_dense_legendre:
        raise RuntimeError(f"T{params.trunc}: not on the T47/T63 kernels")
    kx, prec = params.kx, params.precision
    g2s, s2g = plain_of(sp, "direct"), plain_of(sp, "inverse")
    worst = {"direct": 0.0, "inverse": 0.0}
    absd = {"direct": 0.0, "inverse": 0.0}

    def note(kind, got, want):
        worst[kind] = max(worst[kind], _rel(got, want))
        absd[kind] = max(absd[kind], float((got - want).abs().max()))

    alone_ok = True
    for nmem, k in ((N_MEMBERS, kx), (N_MEMBERS, 1), (1, 1), (N_MEMBERS, 2)):
        g, p = transform_inputs(sp, nmem, k, seed=nmem + k)
        got_d = tk.fused_grid2spec_cuda(sp, g, 1)
        note("direct", got_d, g2s(sp, g, 1))
        for kcos in (1, 2):
            got_i = tk.fused_spec2grid_cuda(sp, p, kcos, 1)
            note("inverse", got_i, s2g(sp, p, kcos, 1))
        if nmem > 1:
            m = nmem // 2 + 1
            alone_ok &= torch.equal(tk.fused_grid2spec_cuda(sp, g[m:m + 1], 1),
                                    got_d[m:m + 1])
            alone_ok &= torch.equal(
                tk.fused_spec2grid_cuda(sp, p[m:m + 1], 2, 1), got_i[m:m + 1])
    g, p = transform_inputs(sp, 16, 3 * kx, seed=5)
    tr = p.reshape(16, 2, 3, kx, sp.mx, sp.nx)[:, :, 1]
    shared = p[:1, :, :kx].expand(5, 2, kx, sp.mx, sp.nx)
    flux = g[:, kx:2 * kx]
    note("inverse", tk.fused_spec2grid_cuda(sp, tr, 1, 1), s2g(sp, tr, 1, 1))
    note("inverse", tk.fused_spec2grid_cuda(sp, shared, 2, 1),
         s2g(sp, shared, 2, 1))
    note("direct", tk.fused_grid2spec_cuda(sp, flux, 1), g2s(sp, flux, 1))
    groups = step_groups(sp, params, N_MEMBERS, seed=8)
    group_err = {name: check_group(sp, kind, fields, kcos, limit)
                 for name, (kind, fields, kcos) in groups.items()}
    _, p = transform_inputs(sp, 4, kx, seed=6)
    p = S.truncate(sp, p)
    p[:, 1, :, 0, :] = 0.0
    dirty = p.clone()
    dirty[:, 1, :, 0, :] = 1e3 * torch.randn(4, kx, sp.nx, device="cuda",
                                             dtype=sp.rdtype)
    discard = torch.equal(tk.fused_spec2grid_cuda(sp, dirty, 1, 1),
                          tk.fused_spec2grid_cuda(sp, p, 1, 1))
    torch.cuda.synchronize()
    tag = f"T{params.trunc}L{kx} {prec}"
    print(f"kernel fused_grid2spec / fused_spec2grid {tag} (T47/T63 kernels, "
          f"{' + '.join(HIRES_KERNEL_NAMES)}): max rel err vs the einsum "
          f"chain {worst['direct']:.3e} / {worst['inverse']:.3e} over 1,024, "
          f"128, 1 and 256 rows, kcos 1 and 2, and the strided layouts; the "
          f"step's groups "
          + ", ".join(f"{n} {e[0]:.3e}" for n, e in group_err.items())
          + f", each bitwise equal to its fields launched one by one (limit "
          f"{limit:.0e}); a member alone bitwise that member of the batch: "
          f"{alone_ok}; m=0 imaginary garbage: "
          + ("bitwise no effect" if discard else "CHANGES THE RESULT"))
    if not (max(*worst.values(), *(e[0] for e in group_err.values()))
            <= limit and alone_ok and discard):
        raise RuntimeError(f"rows 3-4 at {tag} disagree with their plain "
                           f"version, depend on the batch or read the m=0 "
                           f"imaginary part")
    occ = hires_occupancy(libs, sp, params.trunc, prec)
    print(f"  rows 3-4 at {tag}, from the CUDA runtime: " + "; ".join(
        f"{k} on clusters of {o[5]} blocks, {o[0]} clusters at once, "
        f"{o[1]} threads, {o[2] / 1024:.1f} KB shared memory a block, "
        f"{o[3]} registers, {o[4]} B local" for k, o in occ.items()))
    res = {}
    g, p = transform_inputs(sp, N_MEMBERS, kx, seed=7)
    for name, kind, launch, plain in (
            ("fused_grid2spec_hires", "direct",
             lambda: tk.fused_grid2spec_cuda(sp, g, 1),
             lambda: g2s(sp, g, 1)),
            ("fused_spec2grid_hires", "inverse",
             lambda: tk.fused_spec2grid_cuda(sp, p, 1, 1),
             lambda: s2g(sp, p, 1, 1))):
        res[name] = {"max_rel_err": worst[kind], "max_abs_err": absd[kind],
                     "member_alone_bitwise": alone_ok,
                     "occupancy": {k: occ[k] for k in hires_kernels(sp, kind)},
                     "groups": {}}
        for gname, (gkind, fields, kcos) in groups.items():
            if gkind == kind:
                res[name]["groups"][gname] = {
                    "fields": len(fields),
                    "rows": group_rows(fields, kind == "direct"),
                    "max_rel_err": group_err[gname][0],
                    "max_abs_err": group_err[gname][1]}
        res[name].update(time_hires(sp, kind, launch, plain,
                                    N_MEMBERS * kx))
        r = res[name]
        print(f"  {name} {tag} {r['rows']} rows: kernels "
              + " + ".join(f"{v:.4f}" for v in r["ms_by_kernel"].values())
              + f" = {r['ms']:.4f} ms on the card ({r['call_ms']:.4f} ms per "
              f"wrapper call, back to back), plain = library (the einsum "
              f"chain) {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']} (bytes {r['bytes_ms']:.4f} ms, "
              f"{r['bytes'] / 1e6:.1f} MB; operations {r['ops_ms']:.4f} ms, "
              f"{r['flops'] / 1e9:.2f} GFLOP) = "
              f"{100 * r['bound_ms'] / r['ms']:.0f}%; on the tensor cores "
              f"{r['tc_bound_ms']:.4f} ms by {r['tc_bound_by']} "
              f"(operations {r['tc_ops_ms']:.4f} ms) = "
              f"{100 * r['tc_bound_ms'] / r['ms']:.0f}% [{card}]")
        for gname, (gkind, fields, kcos) in groups.items():
            if gkind != kind:
                continue
            if kind == "direct":
                glaunch = lambda f=fields: tk.fused_grid2spec_many_cuda(sp, f, 1)
                gplain = lambda f=fields: [g2s(sp, x, 1) for x in f]
            else:
                glaunch = lambda f=fields, k=kcos: tk.fused_spec2grid_many_cuda(
                    sp, f, k, 1)
                gplain = lambda f=fields, k=kcos: [s2g(sp, x, c, 1)
                                                   for x, c in zip(f, k)]
            t = time_hires(sp, kind, glaunch, gplain,
                           group_rows(fields, kind == "direct"))
            r["groups"][gname].update(t)
            print(f"  group {gname} {tag}: {len(fields)} fields, {t['rows']} "
                  f"rows, one launch: kernels "
                  + " + ".join(f"{v:.4f}" for v in t["ms_by_kernel"].values())
                  + f" = {t['ms']:.4f} ms on the card, the einsum chain field "
                  f"by field {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f}"
                  f" ms by {t['bound_by']} = "
                  f"{100 * t['bound_ms'] / t['ms']:.0f}%, on the tensor cores "
                  f"{t['tc_bound_ms']:.4f} ms by {t['tc_bound_by']} = "
                  f"{100 * t['tc_bound_ms'] / t['ms']:.0f}% [{card}]")
    return res


def hires_bf16_occupancy(libs, sp, trunc: int) -> tuple:
    """The CUDA runtime's six numbers of the direct kernel's bfloat16-grid
    instantiation at sp's shape and type (as hires_occupancy), held to the
    library's plan for a bfloat16 grid."""
    import ctypes
    fn = ctypes.CDLL(str(libs["fused_transform_hires"])) \
        .pyspeedy_fused_transform_hires_occupancy
    plan = tk.hires_kernel_plan(sp, torch.bfloat16)
    out = (ctypes.c_int * 6)()
    rc = fn(0, trunc, tk.c_mode(torch.bfloat16, sp.rdtype), out)
    if rc != 0:
        raise RuntimeError(f"occupancy query of the bfloat16-grid direct "
                           f"kernel at T{trunc} failed with {rc}")
    want = (plan["direct_threads"], plan["direct_smem"], plan["cluster"])
    if (out[1], out[2], out[5]) != want or out[2] > 227 * 1024:
        raise RuntimeError(f"the bfloat16-grid direct kernel at T{trunc}: "
                           f"{tuple(out)} against the plan's {want}")
    return tuple(out), plan


def check_transforms_hires_bf16(params, limit: float, card: str, libs):
    """Row 3 at a T47/T63 shape with a bfloat16 grid
    (hires_direct_cluster_kernel<S, T, __nv_bfloat16>): bitwise the tables'
    type's instantiation fed the widened grid (the JAX package widens, then
    transforms) at 1,024, 128 and 1 rows, a level slice of a stack and the
    step's direct group as the bf16_tendencies step builds it (which is also
    bitwise its fields launched one by one), and within `limit` of the
    einsum chain of the widened grid; a mixed group launches once per type;
    an unaligned bfloat16 grid is refused before launch. Its device ms at
    1,024 rows and as the step's group beside the tables' type's on the
    widened grid, the einsum chain and the bound with the grid at 2 bytes
    an element. Returns the figures."""
    sp = S.build_spectral(params, M.build_geometry(params),
                          use_matmul_fft=True, device="cuda")
    kx, prec = params.kx, params.precision
    bf = torch.bfloat16
    g2s = plain_of(sp, "direct")
    bitwise, worst, max_abs = True, 0.0, 0.0
    cases = []
    for nmem, k in ((N_MEMBERS, kx), (N_MEMBERS, 1), (1, 1)):
        g, _ = transform_inputs(sp, nmem, k, seed=60 + k)
        cases.append(g.to(bf))
    stack, _ = transform_inputs(sp, 16, 3 * kx, seed=63)
    cases.append(stack.to(bf)[:, kx:2 * kx])
    for g in cases:
        got = tk.fused_grid2spec_cuda(sp, g, 1)
        wide = tk.fused_grid2spec_cuda(sp, g.to(sp.rdtype), 1)
        want = g2s(sp, g.to(sp.rdtype), 1)
        bitwise &= torch.equal(got, wide) and got.dtype == sp.rdtype
        worst = max(worst, _rel(got, want))
        max_abs = max(max_abs, float((got - want).abs().max()))
    _, fields, _ = step_groups(sp, params, N_MEMBERS, seed=64,
                               grid_dtype=bf)["direct"]
    widened = [f.to(sp.rdtype) for f in fields]
    ck.reset_launch_counts()
    many = tk.fused_grid2spec_many_cuda(sp, fields, 1)
    one_launch = ck.launch_counts["fused_grid2spec_hires_bf16"] == 1
    many_w = tk.fused_grid2spec_many_cuda(sp, widened, 1)
    alone = [tk.fused_grid2spec_cuda(sp, f, 1) for f in fields]
    bitwise &= all(torch.equal(a, b) for a, b in zip(many, many_w))
    bitwise &= all(torch.equal(a, b) for a, b in zip(many, alone))
    group_err = max(_rel(a, g2s(sp, w, 1)) for a, w in zip(many, widened))
    worst = max(worst, group_err)
    ck.reset_launch_counts()
    mixed = tk.fused_grid2spec_many_cuda(sp, [fields[1], widened[2]], 1)
    mixed_ok = (dict((k, v) for k, v in ck.launch_counts.items() if v)
                == {"fused_grid2spec_hires": 1,
                    "fused_grid2spec_hires_bf16": 1}
                and torch.equal(mixed[0], many[1])
                and torch.equal(mixed[1], many[2]))
    base = cases[0]
    unaligned = torch.empty(base.numel() + 8, dtype=bf, device="cuda")[
        1:1 + base.numel()].view(base.shape)
    try:
        tk.fused_grid2spec_cuda(sp, unaligned, 1)
        refused = False
    except ValueError:
        refused = True
    torch.cuda.synchronize()
    occ, plan = hires_bf16_occupancy(libs, sp, params.trunc)
    tag = f"T{params.trunc}L{kx} {prec}"
    ok = bitwise and one_launch and mixed_ok and refused and worst <= limit
    print(f"kernel fused_grid2spec {tag}, bfloat16 grid "
          f"(hires_direct_cluster_kernel<S, {'float' if prec == 'f32' else 'double'}, "
          f"__nv_bfloat16>, widened as read): bitwise the {prec} kernel on "
          f"the widened grid at 1,024, 128, 1 rows, a level slice and the "
          f"step's direct group ({len(fields)} fields, one launch, bitwise "
          f"its fields one by one): {bitwise}; max rel err vs the einsum "
          f"chain of the widened grid {worst:.3e} (the group {group_err:.3e};"
          f" limit {limit:.0e}); a mixed group launches once per type: "
          f"{mixed_ok}; an unaligned bfloat16 grid refused before launch: "
          f"{refused}; from the CUDA runtime: clusters of {occ[5]} blocks, "
          f"{occ[0]} clusters at once, {occ[1]} threads, "
          f"{occ[2] / 1024:.1f} KB shared memory a block ({plan['grid_buffers']}"
          f" grid buffers), {occ[3]} registers, {occ[4]} B local [{card}]")
    if not ok:
        raise RuntimeError(f"row 3 at {tag} with a bfloat16 grid: bitwise "
                           f"{bitwise}, one launch {one_launch}, mixed "
                           f"{mixed_ok}, refused {refused}, err {worst:.3e}")
    res = {"max_rel_err": worst, "max_abs_err": max_abs,
           "bitwise_widened": bitwise, "occupancy": occ,
           "grid_buffers": plan["grid_buffers"]}
    name = "hires_direct_cluster_kernel"
    timed = {"rows_1024": (cases[0], None), "group": (fields, widened)}
    for key, (x, wide) in timed.items():
        if key == "group":
            launch = lambda: tk.fused_grid2spec_many_cuda(sp, x, 1)
            launch_t = lambda: tk.fused_grid2spec_many_cuda(sp, wide, 1)
            plain = lambda: [g2s(sp, f.to(sp.rdtype), 1) for f in x]
            rows = group_rows(x, True)
        else:
            xw = x.to(sp.rdtype)
            launch = lambda: tk.fused_grid2spec_cuda(sp, x, 1)
            launch_t = lambda: tk.fused_grid2spec_cuda(sp, xw, 1)
            plain = lambda: g2s(sp, x.to(sp.rdtype), 1)
            rows = x.numel() // (sp.il * sp.ix)
        ms, ms_t = [], []
        for _ in range(2):     # in turns: bfloat16, widened, widened, bf16
            ms.append(kernel_device_ms(launch, name, reps=10))
            ms_t.append(kernel_device_ms(launch_t, name, reps=10))
        (bound_ms, bound_by, _, _, nbytes, ops, tc_ms, tc_by,
         _) = hires_bound(sp, rows, True, grid_bytes=2)
        bound_t = hires_bound(sp, rows, True)[0]
        r = {"rows": rows, "ms": min(ms), "ms_runs": ms,
             "ms_widened": min(ms_t), "ms_widened_runs": ms_t,
             "call_ms": time_ms(launch, reps=10),
             "plain_ms": time_ms(plain, reps=3, warmup=1, windows=3),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bytes": nbytes, "flops": ops, "tc_bound_ms": tc_ms,
             "tc_bound_by": tc_by, "bound_ms_widened": bound_t}
        res[key] = r
        print(f"  {key} {tag}, bfloat16 grid, {rows} rows: kernel "
              + ", ".join(f"{v:.4f}" for v in ms) + f" ms on the card "
              f"(the {prec} instantiation on the widened grid "
              + ", ".join(f"{v:.4f}" for v in ms_t) + f" ms, in turns; "
              f"{r['call_ms']:.4f} ms per wrapper call), the einsum chain of "
              f"the widened grid {r['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, the "
              f"grid at 2 bytes; {bound_t:.4f} ms with the grid at "
              f"{sp.rdtype.itemsize}) = {100 * bound_ms / min(ms):.0f}%; on "
              f"the tensor cores {tc_ms:.4f} ms by {tc_by} [{card}]")
    return res


def check_bf16_operands(params, card: str):
    """The 2-byte operand mode of the direct transform (T30) against its
    plain chain, sums and result in the tables' type (float32, or float64:
    grid2spec_fold_kernel<double, __nv_bfloat16, true, 256>): limit 2^-8 of
    the output's largest value (one bfloat16 rounding of the Fourier
    intermediate may fall the other way), the rms error beside it."""
    consts, _ = M.build_consts(params, device="cuda", physics_on=False)
    sp = consts.sp
    kx = params.kx
    worst = max_abs = rms = 0.0
    for nmem, k in ((N_MEMBERS, kx), (N_MEMBERS, 1), (1, 1)):
        g, _ = transform_inputs(sp, nmem, k, seed=20 + k)
        g = g.to(torch.bfloat16)
        got = tk.fused_grid2spec_cuda(sp, g, 1)
        want = tk.grid2spec_plain(sp, g, 1)
        scale = float(want.abs().max())
        worst = max(worst, _rel(got, want))
        max_abs = max(max_abs, float((got - want).abs().max()))
        rms = max(rms, float((got - want).pow(2).mean().sqrt()) / scale)
        if got.dtype != sp.rdtype:
            raise RuntimeError(f"2-byte operand mode must return "
                               f"{sp.rdtype}")
    vs_f32 = _rel(got, tk.grid2spec_plain(sp, g.to(sp.rdtype), 1))
    limit = 2.0 ** -8
    # The step's direct group with bfloat16 operands, as the
    # bf16_tendencies step builds it.
    kind, fields, _ = step_groups(sp, params, N_MEMBERS, seed=22,
                                  grid_dtype=torch.bfloat16)["direct"]
    group_err = check_group(sp, kind, fields, None, limit)[0]
    worst = max(worst, group_err)
    g, _ = transform_inputs(sp, N_MEMBERS, kx, seed=21)
    g = g.to(torch.bfloat16)
    launch = lambda: tk.fused_grid2spec_cuda(sp, g, 1)
    ms = kernel_device_ms(launch, "grid2spec_fold_kernel")
    call_ms = time_ms(launch, reps=20)
    plain_ms = time_ms(lambda: tk.grid2spec_plain(sp, g, 1), reps=10,
                       warmup=2, windows=3)
    bound_ms, bound_by, nbytes, ops_ms, _ = transform_bound(
        sp, N_MEMBERS * kx, True, torch.bfloat16)
    print(f"kernel fused_grid2spec, 2-byte operands (bfloat16 grid and "
          f"tables, {params.precision} sums and result): max rel err vs its "
          f"plain chain {worst:.3e} (limit 2^-8 = {limit:.3e}; the step's "
          f"direct group {group_err:.3e}, bitwise equal to its fields "
          f"launched one by one), rms {rms:.3e}; against the "
          f"{params.precision} transform of the same rounded grid "
          f"{vs_f32:.3e}; {N_MEMBERS * kx} rows: kernel "
          f"{ms:.4f} ms on the card ({call_ms:.4f} ms per call), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes "
          f"({nbytes / 1e6:.1f} MB) = {100 * bound_ms / ms:.0f}%; dense "
          f"operation figure {ops_ms:.5f} ms [{card}]")
    if not worst <= limit:
        raise RuntimeError("the 2-byte operand kernel disagrees with its "
                           "plain chain")
    sp_fft = S.build_spectral(params, M.build_geometry(params),
                              use_matmul_fft=False, device="cuda")
    group = time_group(sp, sp_fft, "direct", kind, fields, None, card,
                       f"T30L{kx} {params.precision} 2-byte operands")
    return {"max_rel_err_bf16": worst, "max_abs_err_bf16": max_abs,
            "rms_rel_err_bf16": rms, "ms_bf16": ms, "call_ms_bf16": call_ms,
            "plain_ms_bf16": plain_ms, "bound_ms_bf16": bound_ms,
            "bound_by_bf16": bound_by, "group_bf16": group}


def probe_work(sp, stage: int, n: int):
    """(bytes, operations) each probe stage needs for n rows: the grid rows
    read once, the output written once, the direct kernel's folded tables
    once (p0-p2); the operations of the folded real part (the DFT of each
    parity over half a period, 2 x (ix/2) x mx per latitude; p2 adds the
    Legendre sums over the northern latitudes and the triangle)."""
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    size = sp.rdtype.itemsize
    ntri = sum(nx - m for m in range(mx))
    tables = sp.fold_dir.numel() * size
    dft_ops = 2 * n * il * (ix // 2) * mx
    if stage == 3:
        return 2 * n * il * mx * size, n * il * mx
    if stage < 2:
        return n * il * (ix + mx) * size + tables, dft_ops
    return (n * (il * ix + mx * nx) * size + tables,
            dft_ops + 2 * n * (il // 2) * ntri)


def probe_occupancy(lib, prec: str) -> dict:
    """{stage: (blocks per SM, threads, shared bytes, registers, local
    bytes)} of the probe kernels, from the CUDA runtime."""
    import ctypes
    fn = ctypes.CDLL(str(lib)).pyspeedy_fused_probe_occupancy
    out, res = (ctypes.c_int * 5)(), {}
    for stage in tk.PROBE_STAGES:
        rc = fn(2 + stage, 0 if prec == "f32" else 1, out)
        if rc != 0:
            raise RuntimeError(f"occupancy query of probe p{stage} failed "
                               f"with {rc}")
        res[stage] = tuple(out)
    return res


PROBE_KERNELS = {0: "grid2spec_fold_kernel<T, T, false, THREADS, 0>",
                 1: "grid2spec_fold_kernel<T, T, false, THREADS, 1>",
                 2: "grid2spec_fold_kernel<T, T, false, THREADS, 2>",
                 3: "split_probe_kernel<T, true>"}


def check_probes(params, limit: float, card: str, libs, row3_group_ms=None):
    """Each probe stage against its plain version, and its time on the card,
    at the JAX tool's 256 rows and at 9,344 rows (the rows of the step's
    direct group at B=128): which stage is wrong, and which stage of the
    direct transform (row 3) takes the time. Beside the 9,344-row probes the
    whole direct kernel on the same grid, and the step's group."""
    consts, _ = M.build_consts(params, device="cuda", physics_on=False)
    sp = consts.sp
    rng = np.random.default_rng(30)
    what = {0: "DFT stage to device memory",
            1: "DFT stage through shared memory, stored flat",
            2: "DFT + Legendre stage, one part",
            3: "inverse-side split, times 2"}
    occ = probe_occupancy(libs["fused_transform"], params.precision)
    peak = PEAK_FLOPS[sp.rdtype]
    res = {}
    for n in (N_PROBE_ROWS, N_PROBE_ROWS_STEP):
        g = torch.from_numpy(rng.standard_normal(
            (n, sp.il, sp.ix))).to("cuda", sp.rdtype)
        stages = []
        for stage in tk.PROBE_STAGES:
            got = tk.fused_probe_cuda(sp, stage, g)
            want = tk.probe_plain(sp, stage, g)
            err = _rel(got, want)
            kern = "split_probe_kernel" if stage == 3 else \
                "grid2spec_fold_kernel"
            launch = lambda: tk.fused_probe_cuda(sp, stage, g)
            ms = kernel_device_ms(launch, kern)
            call_ms = time_ms(launch, reps=20)
            plain_ms = time_ms(lambda: tk.probe_plain(sp, stage, g), reps=10,
                               warmup=2, windows=3)
            nbytes, ops = probe_work(sp, stage, n)
            t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / peak
            bound_ms, bound_by = 1e3 * max(t_b, t_o), (
                "bytes" if t_b >= t_o else "operations")
            blocks, threads, smem, regs, local = occ[stage]
            print(f"kernel fused_probe p{stage} ({what[stage]}, "
                  f"{PROBE_KERNELS[stage]}) T30L{params.kx} "
                  f"{params.precision} {n} rows: max rel err vs plain "
                  f"{err:.3e} (limit {limit:.0e}), kernel {ms:.4f} ms on the "
                  f"card ({call_ms:.4f} ms per wrapper call, back to back), "
                  f"bound {bound_ms:.5f} ms by {bound_by} "
                  f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP) = "
                  f"{100 * bound_ms / ms:.0f}%, plain = PyTorch's own calls "
                  f"{plain_ms:.4f} ms; {regs} registers, {local} B local, "
                  f"{blocks * threads // 32} warps per SM [{card}]")
            if got.shape != want.shape or not err <= limit:
                raise RuntimeError(f"probe stage {stage} disagrees with its "
                                   f"plain version at {n} rows")
            # The plain version of a stage is PyTorch's own calls and nothing
            # else (one matmul, two for p2, a multiply for p3), so its time is
            # also the stage's library time.
            stages.append({"stage": f"p{stage}", "rows": n,
                           "kernel": PROBE_KERNELS[stage], "max_rel_err": err,
                           "max_abs_err": float((got - want).abs().max()),
                           "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                           "library_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "registers": regs,
                           "local_bytes": local,
                           "warps_per_sm": blocks * threads // 32})
        res[n] = stages
    # The attribution the probes exist for: row 3 on the same 9,344-row grid
    # (one field, one launch), and its stages.
    row3 = lambda: tk.fused_grid2spec_cuda(sp, g, 0)
    row3_ms = kernel_device_ms(row3, "grid2spec_fold_kernel")
    t = {x["stage"]: x["ms"] for x in res[N_PROBE_ROWS_STEP]}
    print(f"  row 3 by stage at {N_PROBE_ROWS_STEP} rows T30L{params.kx} "
          f"{params.precision}: the whole direct kernel on the same grid "
          f"{row3_ms:.4f} ms"
          + ("" if row3_group_ms is None else
             f" (the step's direct group of 10 fields, {N_PROBE_ROWS_STEP} "
             f"rows, {row3_group_ms:.4f} ms)")
          + f"; p1 = copy-in, half-period fold and DFT of both parts into "
          f"the shared intermediate, the real part stored {t['p1']:.4f} ms "
          f"({100 * t['p1'] / row3_ms:.0f}%); p0 - p1 = the DFT's values "
          f"stored straight from the register tiles instead "
          f"{t['p0'] - t['p1']:+.4f} ms; p2 - p1 = hemispheric fold, the real "
          f"part's Legendre sums and stores {t['p2'] - t['p1']:.4f} ms; row 3 "
          f"- p1 = hemispheric fold, both parts' Legendre sums and stores "
          f"{row3_ms - t['p1']:.4f} ms "
          f"({100 * (row3_ms - t['p1']) / row3_ms:.0f}%) [{card}]")
    return {"stages": res[N_PROBE_ROWS], "stages_step": res[N_PROBE_ROWS_STEP],
            "row3_ms_step": row3_ms, "row3_group_ms": row3_group_ms}


# ---------------------------------------------------------------------------
# The bfloat16-output instantiations of the two column kernels
# ---------------------------------------------------------------------------

# Share of an output's elements that may differ from the plain version by
# more than one bfloat16 unit (see bf16_agreement).
BF16_WIDE_SHARE = 1e-4


def bf16_agreement(name, kern_bf16, plain_bf16, kern_f32, f32_limit=1e-5):
    """A kernel's bfloat16 output against the plain version's. The kernel
    must store exactly the bfloat16 rounding of its own float32 value. Kernel
    and plain version agree to `f32_limit` of the output's largest value in
    float32, so their roundings differ by at most one bfloat16 unit in the
    last place where a tie is straddled. An element far below the largest
    value (the remainder of a cancellation) may differ by more units, but by
    no more than that float32 disagreement, and at most BF16_WIDE_SHARE of
    the elements may. Returns the share of elements that differ at all, the
    share that differ by more than one unit, and the worst of those in units
    and as a fraction of the output's largest value."""
    if kern_bf16.dtype != torch.bfloat16 or plain_bf16.dtype != torch.bfloat16:
        raise RuntimeError(f"{name}: expected bfloat16 outputs")
    if not torch.equal(kern_bf16, kern_f32.to(torch.bfloat16)):
        raise RuntimeError(f"{name}: the bfloat16 store is not the rounding "
                           f"of the kernel's float32 value")
    a, b = kern_bf16.double(), plain_bf16.double()
    big = torch.maximum(a.abs(), b.abs())
    unit = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(
        big.clamp_min(1e-300))) - 7), torch.zeros_like(big))
    largest = float(b.abs().max())
    diff = (a - b).abs()
    wide = diff > unit
    res = {"differ": float((diff > 0).double().mean()),
           "wide": float(wide.double().mean()), "wide_units": 0.0,
           "wide_of_largest": 0.0}
    if bool(wide.any()):
        res["wide_units"] = float((diff[wide] / unit[wide]).max())
        res["wide_of_largest"] = float(diff[wide].max()) / largest
    if res["wide_of_largest"] > f32_limit or res["wide"] > BF16_WIDE_SHARE:
        raise RuntimeError(
            f"{name}: bfloat16 outputs differ by more than one unit in the "
            f"last place in {res['wide']:.2e} of the elements (at most "
            f"{BF16_WIDE_SHARE:g}), the worst by {res['wide_units']:.0f} "
            f"units = {res['wide_of_largest']:.2e} of the largest value (at "
            f"most {f32_limit:g})")
    return res


def bf16_summary(results) -> str:
    """The worst output of each figure of bf16_agreement, as text."""
    worst = {k: max(r[k] for r in results) for k in results[0]}
    return (f"share of elements that differ {worst['differ']:.2e}, by more "
            f"than one unit {worst['wide']:.2e} (at most {BF16_WIDE_SHARE:g}; "
            f"the worst by {worst['wide_units']:.0f} units = "
            f"{worst['wide_of_largest']:.2e} of the output's largest value, "
            f"at most 1e-05: elements a cancellation leaves far below it) "
            f"(worst output of each)")


def double_rounded(x) -> int:
    """Elements of a float64 tensor whose bfloat16 rounding through float32
    (how the kernels and the JAX package's astype(bfloat16) on the CPU round
    a float64) differs from its direct rounding to nearest even: the cases
    a float64 kernel's bfloat16 store has to get right."""
    if x.dtype != torch.float64:
        return 0
    bits = x.contiguous().view(torch.int64)
    lsb = (bits >> 45) & 1
    direct = (((bits + (1 << 44) - 1 + lsb) >> 45) << 45).view(torch.float64)
    finite = torch.isfinite(x) & (x.abs() < 3e38)
    return int(((direct != x.to(torch.bfloat16).double()) & finite).sum())


def check_bf16_outputs(params, card: str):
    """The bfloat16-output instantiations of the grid-dynamics and physics
    kernels against their plain versions with the flag, at params' shapes
    and type (a float64 kernel rounds through float32, as the plain
    version's cast does: the elements where that differs from a direct
    rounding are counted)."""
    consts, _ = M.build_consts(params, device="cuda")
    tag = f"T{params.trunc}L{params.kx} {params.precision}"
    cb = dataclasses.replace(consts, bf16_tendencies=True)
    args = kernel_inputs(params, N_MEMBERS)
    k32 = ck.grid_dynamics_cuda(consts.col, *args)
    kb = ck.grid_dynamics_cuda(consts.col, *args, bf16_out=True)
    pb = grid_dynamics_core(consts.col, *args, bf16_out=True)
    shares = [bf16_agreement(f"grid_dynamics {n}", b, p, f)
              for n, b, p, f in zip(OUT_NAMES, kb, pb, k32)]
    twice = sum(double_rounded(f) for f in k32)
    launch = lambda: ck.grid_dynamics_cuda(consts.col, *args, bf16_out=True)
    ms = kernel_device_ms(launch, "grid_dynamics_kernel")
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *kb))
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    print(f"kernel grid_dynamics, bfloat16 outputs (all ten), {tag} "
          f"B={N_MEMBERS}: every store is the rounding of the kernel's own "
          f"value ({twice} float64 values where rounding through float32 "
          f"differs from a direct rounding); vs the plain version with the "
          f"flag {bf16_summary(shares)}; kernel {ms:.4f} ms on the card, "
          f"bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} MB) "
          f"[{card}]")
    out = {"grid_dynamics": {
        "ms_bf16": ms, "bound_ms_bf16": bound_ms, "double_rounded": twice,
        "share_differing_bf16": max(r["differ"] for r in shares),
        "share_over_one_unit_bf16": max(r["wide"] for r in shares)}}

    x = random_physics_inputs(consts, N_MEMBERS)
    kwargs = {"phisg": x["phisg"], "m0corr": x["m0corr"],
              "sppt_pattern": x["sppt"]}
    a = list(x["args"])
    a[4] = None                                  # grid_phi: the main path's
    r32 = ck.grid_physics_cuda(consts, True, *a, **kwargs)
    cache = tuple(c.contiguous() for c in r32[5])
    for sw_flag, name in ((True, "grid_physics_sw"),
                          (False, "grid_physics_nosw")):
        a[7] = () if sw_flag else cache
        f32 = ck.grid_physics_cuda(consts, sw_flag, *a, **kwargs)
        rb = ck.grid_physics_cuda(cb, sw_flag, *a, **kwargs)
        rp = PD.grid_physics(cb, sw_flag, *a, **kwargs)
        shares = [bf16_agreement(f"{name} {n}", rb[i], rp[i], f32[i])
                  for i, n in enumerate(PHYS_NAMES[:4])]
        twice = sum(double_rounded(x) for x in f32[:4])
        for g, f in zip(_flatten(rb)[4:], _flatten(f32)[4:]):
            if g.dtype != params.dtype or not torch.equal(g, f):
                raise RuntimeError(f"{name}: a diagnostic or cache field "
                                   f"changed with bf16_tendencies")
        launch = lambda: ck.grid_physics_cuda(cb, sw_flag, *a, **kwargs)
        ms = kernel_device_ms(launch, "grid_physics_kernel")
        bound_ms = physics_bound(
            params, sw_flag, a, {k: v for k, v in kwargs.items()}, rb)[0]
        print(f"kernel {name}, bfloat16 tendencies, {tag} B={N_MEMBERS} "
              f"(after the SPPT multiply; 14 diagnostics and 7 cache fields "
              f"stay {params.precision} and are bitwise unchanged), "
              f"grid_phi ({twice} float64 values where rounding through "
              f"float32 differs from a direct rounding): vs the plain version "
              f"with the flag {bf16_summary(shares)}; kernel {ms:.4f} ms on "
              f"the card, bound {bound_ms:.4f} ms by bytes [{card}]")
        out[name] = {
            "ms_bf16": ms, "bound_ms_bf16": bound_ms, "double_rounded": twice,
            "share_differing_bf16": max(r["differ"] for r in shares),
            "share_over_one_unit_bf16": max(r["wide"] for r in shares)}
    return out


# ---------------------------------------------------------------------------
# The spectral-update kernel against its plain version
# ---------------------------------------------------------------------------

GLUE_OUTS = ("ps0", "ps1", "vor0", "vor1", "div0", "div1", "t0", "t1",
             "trf0", "trf1")


def glue_inputs(params, n_members: int, seed: int, shared: bool):
    """Seeded arguments of the spectral update at the step's shapes: the
    6 + 3*ntr flux spectra and psdt, then the state, each of plausible
    magnitude. tcorh arrives as the forcing leaves it (one plane expanded
    over the members); with `shared` the whole state does, as from
    broadcast_state before the first step (a stride-0 member axis)."""
    rng = np.random.default_rng(seed)
    kx, mx, nx, ntr = params.kx, params.mx, params.nx, params.ntr

    def mk(shape, scale, one=False):
        x = torch.from_numpy(scale * rng.standard_normal(
            (1 if one else n_members,) + shape)).to("cuda", params.dtype)
        return x.expand(n_members, *shape)

    lev, plane, trac = (2, kx, mx, nx), (2, mx, nx), (2, ntr * kx, mx, nx)
    specs = [mk(lev, 1e-5) for _ in range(6 + 3 * ntr)]
    st = lambda shape, scale: mk(shape, scale, one=shared)
    state = (mk(plane, 1e-5), st(lev, 1e-5), st(lev, 1e-5), st(lev, 1e-6),
             st(lev, 1e-6), st(lev, 10.0), st(lev, 10.0), st(plane, 1e-2),
             st(plane, 1e-2), st(trac, 1e-3), st(trac, 1e-3), st(lev, 1e3),
             mk(plane, 1.0, one=True), st(plane, 1e-3))
    return specs, state


def glue_bound(params, n_members: int, ins, outs):
    """Least time the card could take for one spectral update: the larger
    of bytes over the memory rate (each distinct input element read once,
    each output written once) and operations over the peak rate of the
    scalar type (per (member, part, m, n) point about 116 + 6*kx + 25*ntr
    per level, counted from the kernel, and 20 for log-ps)."""
    nbytes = sum(unique_bytes(x) for x in (*ins, *outs))
    kx, ntr = params.kx, params.ntr
    ops = (n_members * 2 * params.mx * params.nx
           * (kx * (116 + 6 * kx + 25 * ntr) + 20))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[params.dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes


def compare_glue(consts, j1, dt, specs, state, limit, tag):
    """One launch of the kernel against the plain version on the same
    inputs: (worst relative error over the ten outputs, each relative to
    its largest value; worst absolute error; the ten errors)."""
    eps = 0.0 if j1 == 1 else consts.params.rob
    got = GK.spectral_update_cuda(consts, j1, dt, eps, specs, *state)
    torch.cuda.synchronize()
    want = SG.spectral_update_plain(consts, j1, dt, eps, specs, *state)
    errs = []
    for name, a, b in zip(GLUE_OUTS, got, want):
        if (a.shape != b.shape or not a.is_contiguous()
                or not bool(torch.isfinite(a).all())):
            raise RuntimeError(f"spectral_update {tag} {name}: bad shape, "
                               f"layout or values")
        errs.append(_rel(a, b))
    if not max(errs) <= limit:
        raise RuntimeError(
            f"spectral_update {tag}: kernel vs plain "
            + ", ".join(f"{n} {e:.3e}" for n, e in zip(GLUE_OUTS, errs))
            + f" (limit {limit:g})")
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return max(errs), max_abs, errs


def check_spectral_update(params, limit: float, card: str,
                          startup: bool = True):
    """The spectral-update kernel against its plain version at B=128 on
    seeded inputs: the three time steps of the start-up sequence with their
    implicit tables (j1=1 with dt/2 and dt, j1=2 with 2 dt; with `startup`
    False the leapfrog step alone), each with a dense state and with a
    stride-0 member axis; timed on the dense j1=2 case."""
    consts, geom = M.build_consts(params, device="cuda", physics_on=False)
    p = params
    worst, max_abs, lines = 0.0, 0.0, []
    for shared in (False, True):
        for j1, f in ((1, 0.5), (1, 1.0), (2, 2.0))[0 if startup else 2:]:
            c = consts.with_implicit(build_implicit(
                p, geom, consts.hd, f * p.delt, device="cuda"))
            specs, state = glue_inputs(p, N_MEMBERS, int(4 * f) + shared,
                                       shared)
            tag = (f"T{p.trunc}L{p.kx} {p.precision} B={N_MEMBERS} j1={j1} "
                   f"dt={f}*delt {'stride-0 members' if shared else 'dense'}")
            w, a, errs = compare_glue(c, j1, f * p.delt, specs, state, limit,
                                      tag)
            worst, max_abs = max(worst, w), max(max_abs, a)
            lines.append(f"  {tag}: " + " ".join(
                f"{n} {e:.1e}" for n, e in zip(GLUE_OUTS, errs)))
    specs, state = glue_inputs(p, N_MEMBERS, 9, False)
    dt, eps = 2.0 * p.delt, p.rob
    launch = lambda: GK.spectral_update_cuda(consts, 2, dt, eps, specs,
                                             *state)
    outs = launch()
    # A member's result is the same bits whatever tile or lane it lands in
    # (the batch cut at offsets that move every member to another tile and
    # lane), and alone (B=1).
    offsets = (1, 5, 19)
    for off in offsets:
        cut = lambda xs: [x[off:] for x in xs]
        again = GK.spectral_update_cuda(consts, 2, dt, eps, cut(specs),
                                        *cut(state))
        if not all(torch.equal(x, y[off:]) for x, y in zip(again, outs)):
            raise RuntimeError(f"spectral_update T{p.trunc}L{p.kx} "
                               f"{p.precision}: "
                               f"the batch from member {off} on changes the "
                               f"result")
    first = lambda xs: [x[:1] for x in xs]
    alone = GK.spectral_update_cuda(consts, 2, dt, eps, first(specs),
                                    *first(state))
    if not all(torch.equal(x, y[:1]) for x, y in zip(alone, outs)):
        raise RuntimeError(f"spectral_update T{p.trunc}L{p.kx} "
                           f"{p.precision}: "
                           f"member 0 alone differs from member 0 of the "
                           f"batch")
    ms = kernel_device_ms(launch, "spectral_update_kernel")
    call_ms = time_ms(launch, reps=20)
    ms_b1 = kernel_device_ms(lambda: GK.spectral_update_cuda(
        consts, 2, dt, eps, first(specs), *first(state)),
        "spectral_update_kernel")
    plain_ms = time_ms(lambda: SG.spectral_update_plain(
        consts, 2, dt, eps, specs, *state), reps=3, warmup=1, windows=3)
    bound_ms, bound_by, nbytes = glue_bound(p, N_MEMBERS, (*specs, *state),
                                            outs)
    bound_b1 = glue_bound(p, 1, (*first(specs), *first(state)), first(outs))[0]
    print(f"kernel spectral_update T{p.trunc}L{p.kx} {p.precision} "
          f"B={N_MEMBERS}: "
          f"max rel err vs plain {worst:.3e} (limit {limit:.0e}) over the "
          f"ten outputs of {len(lines)} cases; kernel {ms:.4f} ms on the "
          f"card "
          f"({call_ms:.4f} ms per wrapper call, back to back), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB) = {100 * bound_ms / ms:.0f}%; B=1 "
          f"{ms_b1:.4f} ms (bound {bound_b1:.4f}); the batch from members "
          f"{', '.join(map(str, offsets))} on and member 0 alone give the "
          f"same bits [{card}]")
    for line in lines:
        print(line)
    return {"max_rel_err": worst, "max_abs_err": max_abs, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_b1": ms_b1, "bound_ms_b1": bound_b1}


def check_spectral_update_on_state(consts, state, limit: float):
    """The spectral-update kernel against its plain version on the model's
    own state after a day: the flux spectra and psdt of the next step (its
    transforms, grid dynamics and physics with shortwave), j1=2."""
    step = 2 + N_STEPS
    specs, psdt, st = grid_tendency_specs(
        consts, state, 1, PD.get_physical_tendencies,
        {"compute_shortwave": True, "stepno": step})
    p = consts.params
    tag = (f"T{p.trunc}L{p.kx} {p.precision} B={psdt.shape[0]} on the "
           f"model's state after a day")
    worst, _, errs = compare_glue(consts, 2, 2.0 * p.delt, specs,
                                  SG.update_inputs(st, psdt), limit, tag)
    print(f"kernel spectral_update {tag}: max rel err vs plain {worst:.3e} "
          f"(limit {limit:.0e}): " + " ".join(
              f"{n} {e:.1e}" for n, e in zip(GLUE_OUTS, errs)))
    return worst


def check_call_site_groups(consts, state, limit: float, extra_ctx=None):
    """The transform groups the step's call sites build (the dynamics' and
    the physics' inverse groups, the direct group) on the model's own state
    after a day, captured during one step evaluation: each launched once
    against the plain chain field by field and against its fields launched
    one by one (bitwise). With SPPT (`extra_ctx` holding the step's noise,
    "sppt_se") the physics' group carries the pattern's spectrum as a sixth
    field. Returns (worst relative error, [(kind, fields, kcos, pdim)] of
    the three groups)."""
    captured = []
    direct_many, inverse_many = tk.fused_grid2spec_many, tk.fused_spec2grid_many

    def record_direct(sp, grids, pdim=0):
        grids = list(grids)
        captured.append(("direct", grids, None, pdim))
        return direct_many(sp, grids, pdim)

    def record_inverse(sp, pairs, kcos=1, pdim=0):
        pairs = list(pairs)
        kcos = tk.kcos_list(kcos, len(pairs))
        captured.append(("inverse", pairs, kcos, pdim))
        return inverse_many(sp, pairs, kcos, pdim)

    tk.fused_grid2spec_many, tk.fused_spec2grid_many = (record_direct,
                                                        record_inverse)
    try:
        grid_tendency_specs(consts, state, 1, PD.get_physical_tendencies,
                            {"compute_shortwave": True,
                             "stepno": 2 + N_STEPS, **(extra_ctx or {})})
    finally:
        tk.fused_grid2spec_many, tk.fused_spec2grid_many = (direct_many,
                                                            inverse_many)
    sizes = [(kind, len(fields), pdim) for kind, fields, _, pdim in captured]
    n_phys = 5 + (1 if extra_ctx else 0)
    want = [("inverse", 7, 1), ("inverse", n_phys, 1),
            ("direct", 7 + 3 * consts.params.ntr, 1)]
    if sizes != want:
        raise RuntimeError(f"the step's transform groups are {sizes}, "
                           f"expected {want}")
    errs = [check_group(consts.sp, kind, fields, kcos, limit)[0]
            for kind, fields, kcos, _ in captured]
    print(f"the step's transform groups as its call sites build them, on the "
          f"model's state after a day (T30L8 f32 B={N_MEMBERS}"
          f"{', SPPT' if extra_ctx else ''}): "
          + ", ".join(f"{kind} of {len(f)} fields {e:.3e}"
                      for (kind, f, _, _), e in zip(captured, errs))
          + f" max rel err vs the plain chain (limit {limit:.0e}), each "
          f"bitwise equal to its fields launched one by one")
    return max(errs), captured


# ---------------------------------------------------------------------------
# The DFT chain against its plain version
# ---------------------------------------------------------------------------

def dft_chain_inputs(dtype, seed: int = 40):
    """Seeded Fourier pairs at the JAX tool's shapes (standard normal, as
    the tool makes them) and the four DFT tables, on the card."""
    rng = np.random.default_rng(seed)
    shape = (N_DFT_MEMBERS, DC.NFIELDS, DC.KX, DC.IL, DC.MX)
    fre = torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype)
    fim = torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype)
    return DC.device_tables(dtype, "cuda"), fre, fim


DFT_MEMBERS_ALONE = (0, 137, N_DFT_MEMBERS - 1)


def dft_chain_occupancy(lib, dtype) -> tuple:
    """(blocks per SM, threads, shared bytes, registers, local bytes) of the
    DFT-chain kernel's instantiation for `dtype`, from the CUDA runtime."""
    import ctypes
    out = (ctypes.c_int * 5)()
    rc = ctypes.CDLL(str(lib)).pyspeedy_dft_chain_occupancy(
        torch.empty((), dtype=dtype).element_size(), out)
    if rc != 0:
        raise RuntimeError(f"occupancy query of the DFT chain failed: {rc}")
    return tuple(out)


def check_dft_chain(dtype, limit: float, card: str, libs):
    """The DFT-chain kernel against its plain version (12 matrix products
    and the chain's elementwise passes) at B=256, a member alone bitwise
    that member of the batch, and its time against the bound of the least
    work, folded by the half period and the mirror (float32 at the FFMA
    peak, float64 at the FP64 tensor-core peak: the kernel runs on DMMA)."""
    tabs, fre, fim = dft_chain_inputs(dtype)
    got = DC.dft_chain_cuda(tabs, fre, fim)
    torch.cuda.synchronize()
    want = DC.dft_chain_plain(tabs, fre, fim)
    for a, b in zip(got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise RuntimeError("dft_chain: bad shape or values")
    err = max(_rel(a, b) for a, b in zip(got, want))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    alone_ok = all(
        torch.equal(x[0], y[m]) for m in DFT_MEMBERS_ALONE
        for x, y in zip(DC.dft_chain_cuda(tabs, fre[m:m + 1].contiguous(),
                                          fim[m:m + 1].contiguous()), got))
    launch = lambda: DC.dft_chain_cuda(tabs, fre, fim)
    ms = kernel_device_ms(launch, "dft_chain_fold_kernel", reps=10)
    call_ms = time_ms(launch, reps=10)
    plain_ms = time_ms(lambda: DC.dft_chain_plain(tabs, fre, fim), reps=2,
                       warmup=1, windows=3)
    size = fre.element_size()
    rows = fre.numel() // DC.MX                     # (member, field, level, lat)
    # The least work: the tables are cos and sin, symmetric under the half
    # period (i -> i + ix/2, sign (-1)^m) and the mirror (i -> ix - i), so
    # each DFT needs 2 parts x mx x ix/4 multiply-adds per field row. The
    # kernel folds by the half period only (twice this); PR 4's design by
    # neither (four times this).
    ops = rows * 2 * 2 * (2 * DC.MX * (DC.IX // 4))
    ops_unfolded = rows * 8 * DC.MX * DC.IX
    nbytes = 4 * fre.numel() * size + 4 * DC.MX * DC.IX * size
    peak = PEAK_FLOPS[dtype] if dtype == torch.float32 else \
        PEAK_FLOPS_F64_TENSOR
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    blocks, threads, smem, regs, local = dft_chain_occupancy(
        libs["dft_chain"], dtype)
    name = "f32" if dtype == torch.float32 else "f64"
    beside = "" if dtype == torch.float32 else (
        f"; at the {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s FP64 peak outside "
        f"the tensor cores the least work takes {1e3 * ops / PEAK_FLOPS[dtype]:.4f} ms")
    print(f"kernel dft_chain {name} B={N_DFT_MEMBERS} ({rows} field rows, "
          f"dft_chain_fold_kernel<{'float' if name == 'f32' else 'double'}>"
          f"): max rel err vs plain {err:.3e} (limit {limit:.0e}); members "
          f"{', '.join(map(str, DFT_MEMBERS_ALONE))} alone bitwise as in the "
          f"batch: {alone_ok}; kernel {ms:.4f} ms on the card ({call_ms:.4f} "
          f"ms per wrapper call, back to back), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} (least work, both folds: "
          f"{ops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s = "
          f"{1e3 * t_ops:.4f} ms; {nbytes / 1e6:.1f} MB = "
          f"{1e3 * t_bytes:.4f} ms{beside}) = {100 * bound_ms / ms:.0f}%; "
          f"the unfolded work of PR 4's design {ops_unfolded / 1e9:.2f} "
          f"GFLOP; {regs} registers, {local} B local, {smem / 1024:.1f} KB "
          f"shared memory and {threads} threads a block, {blocks} blocks = "
          f"{blocks * threads // 32} warps per SM [{card}]")
    if not err <= limit:
        raise RuntimeError(f"dft_chain kernel disagrees with its plain "
                           f"version: {err:.3e}")
    if not alone_ok:
        raise RuntimeError("dft_chain: a member alone differs from the same "
                           "member in the batch")
    return {"max_rel_err": err, "max_abs_err": max_abs, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "member_alone_bitwise": alone_ok,
            "registers": regs, "local_bytes": local,
            "warps_per_sm": blocks * threads // 32,
            "kernel": f"dft_chain_fold_kernel<{'float' if name == 'f32' else 'double'}>"}


def expected_transforms(consts, n_evals: int, n_forcings: int,
                        with_init: bool):
    """((direct launches, direct fields), (inverse launches, inverse
    fields)) of a path, from the step's structure. A step evaluation
    transforms 7 stacks to the grid for the dynamics (vor, div, T, tracers,
    u, v, the log-ps gradient) in one launch and, with the physics, 5 more
    (u, v, T, q, ps; 6 without grid_phi: the phi stack) in a second one, and
    7 + 3*ntr fields back (psdt, two wind and two temperature-flux fields,
    two fluxes and one tendency per tracer, kinetic energy, T) in one launch
    per MAX_SEGMENTS fields; the daily forcing 2 direct fields, one launch
    each; with SPPT the physics' group carries the pattern's spectrum too
    (one field more, no launch more); the initialization itself 4 direct
    and 2 inverse, one launch each
    (the filtered orography, its spectral form and synthesis, surface
    pressure and humidity of the rest state). The fields are the arithmetic
    of the transforms; the launches follow the grouping."""
    ntr = consts.params.ntr
    # With SPPT the pattern's spectrum joins the physics' group.
    sppt = 1 if consts.params.sppt_on else 0
    inv_fields = 7 + ((5 if consts.grid_phi else 6) + sppt
                      if consts.physics_on else 0)
    inv_launches = 2 if consts.physics_on else 1
    dir_fields = 7 + 3 * ntr
    dir_launches = -(-dir_fields // tk.MAX_SEGMENTS)
    direct = [n_evals * dir_launches + 2 * n_forcings,
              n_evals * dir_fields + 2 * n_forcings]
    inverse = [n_evals * inv_launches, n_evals * inv_fields]
    if with_init:
        direct = [direct[0] + 4, direct[1] + 4]
        inverse = [inverse[0] + 2, inverse[1] + 2]
    return tuple(direct), tuple(inverse)


def reset_counts():
    """Every launch, field and plain-call count to 0, just before a path."""
    ck.reset_launch_counts()
    tk.reset_field_counts()
    tk.reset_plain_chain_calls()
    tk.reset_einsum_chain_calls()
    GK.reset_plain_calls()


def plain_calls() -> dict:
    """Calls of every plain version since the last reset_counts: the dense
    matmul chain (rows 3-4 at T30), the einsum chain as the plain version of
    rows 3-4 at T47/T63 (einsum_*), the spectral update's."""
    return dict(tk.plain_chain_calls, **GK.plain_calls,
                **{"einsum_" + k: v for k, v in tk.einsum_chain_calls.items()})


def build_report() -> list:
    """Registers and spill bytes of every kernel instantiation, from what
    nvcc -Xptxas -v printed when the libraries were built."""
    import re
    bases = ("grid_dynamics_kernel", "grid_physics_kernel",
             "grid2spec_fold_kernel", "spec2grid_fold_kernel",
             "split_probe_kernel", "spectral_update_kernel",
             "dft_chain_fold_kernel") + HIRES_KERNEL_NAMES
    words = {"f": "float", "d": "double", "13__nv_bfloat16": "bfloat16"}
    rows = []
    for name, log in ck.build_logs.items():
        lines = log.splitlines()
        for n, line in enumerate(lines):
            if "Function properties for" not in line:
                continue
            base = next((b for b in bases if b + "I" in line), None)
            if base is None:
                continue
            # Template arguments of the mangled name, up to the closing EEv.
            targs = re.search(re.escape(base) + r"I(.+?)EEv", line).group(1)
            parts = []
            for tok in re.findall(r"13__nv_bfloat16|Lb[01]E|Lin?\d+E|[fd]",
                                  targs):
                if tok.startswith("Lb"):
                    parts.append("true" if tok[2] == "1" else "false")
                elif tok.startswith("Li"):
                    parts.append(tok[2:-1].replace("n", "-"))
                else:
                    parts.append(words[tok])
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", lines[n + 1])
            regs = re.search(r"Used (\d+) registers", lines[n + 2])
            rows.append(f"{name} {base}<{', '.join(parts)}>: "
                        f"{regs.group(1)} registers, spill "
                        f"{spill.group(1)}/{spill.group(2)} B")
    return rows


def sass_counts(lib, bases=("grid_physics_kernel",
                               "spectral_update_kernel")) -> dict:
    """{mangled kernel name: (conversions between float and double, all F2F
    conversions, instructions)} of the kernels of library `lib` whose names
    hold one of `bases`, counted in the SASS that cuobjdump prints (F2F is
    the conversion between floating-point types; F2F.F32.F64 and
    F2F.F64.F32 are those between float and double)."""
    import re
    tool = Path(ck.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1) if any(b in head.group(1) for b in bases) \
                else None
            if name:
                counts[name] = [0, 0, 0]
            continue
        if name is None or not re.search(r"/\*[0-9a-f]{4,}\*/", line):
            continue
        c = counts[name]
        c[2] += 1
        if re.search(r"\bF2F\.", line):
            c[1] += 1
            if re.search(r"F2F\.F(32\.F64|64\.F32)", line):
                c[0] += 1
    return {k: tuple(v) for k, v in counts.items()}


def sass_report(libs, bases=("grid_physics_kernel",
                             "spectral_update_kernel")) -> list:
    """One line per kernel instantiation of `libs` whose name holds one of
    `bases`: its conversions between float and double, all its F2F
    conversions and its instruction count."""
    import re
    rows = []
    for lib in libs:
        for name, (f2f64, f2f, n) in sorted(sass_counts(lib, bases).items()):
            m = re.search("(" + "|".join(bases) + r")I(.+?)EEv", name)
            targs = m.group(2) if m else name
            rows.append(f"{Path(str(lib)).name} {m.group(1) if m else ''}"
                        f"<{targs}>: F2F float<->double {f2f64}, all F2F "
                        f"{f2f}, {n} instructions")
    return rows


def occupancy_report(libs) -> dict:
    """{instantiation: (resident blocks per SM, threads a block, shared
    memory a block, registers, local memory bytes)} of the two
    column-parallel kernels at T30 (nx = 32, one tracer), from the CUDA
    runtime (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes
    rows, out = {}, (ctypes.c_int * 7)()
    phys = ctypes.CDLL(str(libs["grid_physics"])).pyspeedy_grid_physics_occupancy
    glue = ctypes.CDLL(str(libs["spectral_update"])).pyspeedy_spectral_update_occupancy
    word = lambda flag: "true" if flag else "false"
    cases = [(f"grid_physics_kernel<{t}, {kx}, {word(sw)}, {word(bf16)}>",
              lambda es=es, bf16=bf16, kx=kx, sw=sw: phys(es, bf16, kx, sw, out))
             for t, es, bf16 in (("float", 4, 0), ("double", 8, 0),
                                 ("float", 4, 1))
             for kx in (5, 7, 8) for sw in (1, 0)]
    cases += [(f"spectral_update_kernel<{t}, {kx}>",
               lambda es=es, kx=kx: glue(es, kx, 1, 32, out))
              for t, es in (("float", 4), ("double", 8)) for kx in (5, 7, 8)]
    for name, call in cases:
        rc = call()
        if rc != 0:
            raise RuntimeError(f"occupancy query of {name} failed with {rc}")
        rows[name] = tuple(out[:5])
    return rows


def sass_opcodes(lib, base: str) -> dict:
    """{mangled kernel name: {opcode: instructions}} of the kernels of
    library `lib` whose names hold `base`, from the SASS that cuobjdump
    prints (an opcode without its modifiers)."""
    import re
    tool = Path(ck.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1) if base in head.group(1) else None
            if name:
                counts[name] = {}
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                       line)
        if name is not None and op:
            counts[name][op.group(1)] = counts[name].get(op.group(1), 0) + 1
    return counts


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi's clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def ulps_apart(got, want) -> int:
    """The largest distance in units of the last place between two float
    tensors of one type and shape (their bit patterns' difference; values
    of one sign)."""
    itype = torch.int32 if got.dtype == torch.float32 else torch.int64
    return int((got.view(itype) - want.view(itype)).abs().max())


def check_sppt_noise(el2, card: str, lib, nmem: int = 1024,
                     n_steps: int = 8) -> dict:
    """SPPT's noise kernel (csrc/sppt_noise.cu) at the SPPT cell's chunk:
    T30L8, nmem members, the first n_steps steps of a 9-step run call from
    step 2, float32 and float64, the sigma of the Laplacian eigenvalues
    `el2`. Its time (CUDA events, the table already on the card), its bound
    (the larger of its INT32-pipe work, the rotates and xors at 64 a clock
    an SM at the card's highest SM clock, and its bytes at 3.35 TB/s; beside
    it all its integer operations at that rate), the plain passes' time on
    the same card and the agreement of the two (bitwise, or the largest ulp
    distance; raises past 1 ulp); the SASS opcodes of each instantiation.
    Prints one line a type; returns the figures."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = INT32_PER_SM_CLOCK * sms * sm_clock_hz()
    sass = sass_opcodes(lib, "sppt_noise_kernel")
    out = {}
    for prec in ("f32", "f64"):
        params = dataclasses.replace(T30L8, precision=prec)
        dtype = params.dtype
        sigma = SP.build_sppt_tables(params, el2, "cuda").sigma
        shape = SP._pair_shape(params)
        per = math.prod(shape)
        rows = [(s, j * per) for s, n in SP.sppt_groups(2, 9)
                for j in range(n)][:n_steps]
        fold, offset = [r[0] for r in rows], [r[1] for r in rows]
        keys = SP.split_keys(SP.key_data(2**31 + 11), nmem).cuda()
        table = torch.from_numpy(SN.step_table(fold, offset)).cuda()
        fold_t = torch.tensor(fold, device="cuda")
        offs_t = torch.tensor(offset, device="cuda")
        kernel = lambda: SN.sppt_noise_cuda(keys, table, shape, dtype, sigma)
        plain = lambda: sigma * SP.draw_noise_plain(
            SP.fold_in(keys[:, None, :], fold_t), shape, dtype, offs_t)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        bitwise = torch.equal(got, want)
        ulps = 0 if bitwise else ulps_apart(got, want)
        n_diff = int((got != want).sum())
        del got, want
        ms = time_ms(kernel, reps=10)
        plain_ms = time_ms(plain, reps=1, warmup=1, windows=3)
        elements = nmem * n_steps * per
        nbytes = (elements + math.prod(sigma.shape)) * sigma.element_size() \
            + 8 * (keys.numel() + table.numel())
        pipe_ms = SPPT_NOISE_INT_PIPE_OPS * elements / int_rate * 1e3
        int_ms = SPPT_NOISE_INT_OPS * elements / int_rate * 1e3
        byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(pipe_ms, byte_ms)
        t = "float" if prec == "f32" else "double"
        ops = next((v for k, v in sass.items() if f"kernelI{t[0]}" in k), {})
        mix = {op: ops.get(op, 0) for op in ("SHF", "LOP3", "IADD3", "IMAD",
                                             "FMNMX", "MUFU")}
        print(f"sppt_noise_kernel<{t}> (T30L8, B={nmem}, {n_steps} steps, "
              f"{elements:,} elements, {nbytes / 1e6:.1f} MB written): "
              f"{ms:.4f} ms, bound {bound:.4f} ms by "
              f"{'the INT32 pipe' if pipe_ms >= byte_ms else 'bytes'} "
              f"({100 * bound / ms:.1f} %; INT32 pipe {pipe_ms:.4f}, all "
              f"{SPPT_NOISE_INT_OPS} integer operations an element "
              f"{int_ms:.4f}, bytes {byte_ms:.4f}); the plain passes "
              f"{plain_ms:.3f} ms; kernel vs plain "
              f"{'bitwise' if bitwise else f'{n_diff} elements differ, at most {ulps} ulp'}; "
              f"SASS {sum(ops.values())} instructions, {mix} [{card}]")
        if ulps > 1:
            raise RuntimeError(f"sppt_noise_kernel<{t}>: {ulps} ulp from the "
                               f"plain passes")
        out[prec] = {"ms": ms, "bound_ms": bound, "int_pipe_ms": pipe_ms,
                     "int_ops_ms": int_ms, "byte_ms": byte_ms,
                     "plain_ms": plain_ms, "bitwise": bitwise,
                     "ulps": ulps, "elements_differing": n_diff,
                     "sass": ops}
    return out


def run_window(run, state, cal, first_step: int, n_steps: int,
               eager: bool = False):
    """n_steps through the batched runner (its CUDA graphs, or its eager
    loop with `eager`); returns (state, calendar after, wall seconds
    including the final synchronize)."""
    ctx, cal = M.build_step_ctx(dataclasses.replace(cal), first_step, n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, ctx, eager=eager)
    torch.cuda.synchronize()
    return state, cal, time.perf_counter() - t0


# The device kernel of each launch counter (its instantiations share it);
# rows 3-4 at T47/T63 run those of the library's plan for the path's shape
# and type. SPPT's noise kernel is held by its wrapper count alone: it is
# the first kernel of a run call's window, and the profiler has left its
# record out of eager windows (0 of 8 after a few sessions on the H100,
# while the graph windows between them held it).
KERNEL_OF_COUNTER = {
    "grid_dynamics": "grid_dynamics_kernel",
    "grid_dynamics_bf16": "grid_dynamics_kernel",
    "grid_physics_sw": "grid_physics_kernel",
    "grid_physics_nosw": "grid_physics_kernel",
    "grid_physics_sw_bf16": "grid_physics_kernel",
    "grid_physics_nosw_bf16": "grid_physics_kernel",
    "fused_grid2spec": "grid2spec_fold_kernel",
    "fused_grid2spec_bf16": "grid2spec_fold_kernel",
    "fused_spec2grid": "spec2grid_fold_kernel",
    "fused_grid2spec_hires": "direct",
    "fused_grid2spec_hires_bf16": "direct",
    "fused_spec2grid_hires": "inverse",
    "spectral_update": "spectral_update_kernel"}


def _kernel_names(counter, sp) -> tuple:
    """The device kernels one launch of `counter` runs on a path whose
    spectral tables are sp (none of rows 3-4 at T47/T63 off their
    shapes)."""
    name = KERNEL_OF_COUNTER[counter]
    if "_hires" in counter:
        hires = (sp.il, sp.ix, sp.mx, sp.nx) in tk.HIRES_SHAPES
        return hires_kernels(sp, name) if hires else ()
    return (name,)


def device_launches_of(consts, first: int, n_steps: int) -> dict:
    """{device kernel: launches} of n_steps of the batched runner from step
    `first`, in either mode: a graph replays every kernel of its step."""
    want, _ = expected_path_launches(consts, first, n_steps, with_init=False)
    out = {}
    for counter, n in want.items():
        if n and counter in KERNEL_OF_COUNTER:
            for name in _kernel_names(counter, consts.sp):
                out[name] = out.get(name, 0) + n
    return out


def device_time_per_step(run, state, cal, first_step: int, n_steps: int,
                         consts, eager: bool = False) -> dict:
    """A profiled window of n_steps in the runner's graph mode (or its
    eager loop with `eager`), utils.profiling.window_profile: the card's
    busy ms, device launches and the host's enqueue calls per step, the
    eight device kernels that take most of the time as [(name, ms per step,
    launches per step)], and the ms per step of the matrix products, the row
    reductions and the hand-written kernels. The window's records of the
    step's kernels must equal the launches the window makes
    (device_launches_of): on the graph paths this is the launch-count check.
    The tracer can lose every record for a while (see kernel_device_ms): a
    window that is not whole is profiled again a second later, five windows
    at most; then this raises. The profiler slows the host, so the busy
    share is taken against the step time of an unprofiled window."""
    want = device_launches_of(consts, first_step, n_steps)
    for attempt in range(5):
        ctx, _ = M.build_step_ctx(dataclasses.replace(cal), first_step,
                                  n_steps)
        prof = window_profile(lambda: run(state, ctx, eager=eager), n_steps)
        by = prof["by_kernel"]
        got = {name: round(n_steps * sum(v[1] for k, v in by.items()
                                         if name in k)) for name in want}
        if got == want:
            break
        print(f"  (profiled window {attempt + 1} of {n_steps} steps is not "
              f"whole: {got} records of {want})")
        time.sleep(1.0)
    else:
        mode = "eager" if eager else "graphs"
        raise RuntimeError(f"{n_steps}-step window ({mode}): the profiler "
                           f"recorded {got} launches, the window makes "
                           f"{want}")
    share = lambda *keys: sum(v[0] for k, v in by.items()
                              if any(x in k.lower() for x in keys))
    groups = {"matrix products": share("gemm", "cutlass", "xmma"),
              "fused transform kernels": share("grid2spec_fold_kernel",
                                               "spec2grid_fold_kernel",
                                               *HIRES_KERNEL_NAMES),
              "grid_physics kernel": share("grid_physics_kernel"),
              "grid_dynamics kernel": share("grid_dynamics_kernel"),
              "spectral_update kernel": share("spectral_update_kernel"),
              "row reductions": share("reduce_kernel")}
    top = [(k[:60], v[0], v[1]) for k, v in list(by.items())[:8]]
    copies = {k[:60]: (v[0], v[1]) for k, v in by.items()
              if k not in SPANS
              and any(x in k.lower() for x in COPY_RECORDS)}
    return {"busy_ms": prof["busy_ms_per_step"],
            "launches": prof["launches_per_step"],
            "host_calls": prof["host_calls_per_step"],
            "top": top, "groups": groups, "kernels": got, "copies": copies}


# The profiler's names of the device records that copy memory: the
# runtime's copies ("Memcpy DtoD (Device -> Device)") and PyTorch's copy
# kernels (a broadcast or strided copy_, elementwise_kernel<...copy...>);
# not the spans (utils.profiling.SPANS), whose ranges the profiler mirrors
# on the device's timeline in some windows ("runner.copy_in").
COPY_RECORDS = ("memcpy", "copy")
# The kinds of copies a graph run call makes (StepGraphs.stats["copies"]).
COPY_KINDS = ("in", "step", "forcing", "inputs", "out")


def _copy_summary(copies: dict) -> str:
    return "; ".join(f"{name} {n:.2f} ({ms:.4f} ms)"
                     for name, (ms, n) in copies.items()) or "none"


def device_launches(fn) -> int:
    """Device launches (kernels, copies, fills) of one call of fn, from
    torch.profiler; 0 if the tracer recorded none (see kernel_device_ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def fixture_ladder(path: str):
    """The exported day against tests/fixtures/1982-01-02_0000.nc through
    the rtol ladder of tests/test_speedy.py; returns {variable: largest
    relative difference}. Raises at the first rung a variable misses."""
    mine, ref = open_dataset(path), open_dataset(str(FIXTURE))
    rel = {}
    for v in ref.keys():
        x = np.asarray(mine[v].data, dtype=np.float64)
        y = np.asarray(ref[v].data, dtype=np.float64)
        if x.shape != y.shape or not np.isfinite(x).all():
            raise RuntimeError(f"API phase: {v} has shape {x.shape}, "
                               f"expected {y.shape}, or non-finite values")
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.abs(x - y) / np.abs(y)
        rel[v] = float(np.nanmax(np.where(x == y, 0.0, r)))
    for rtol in FIXTURE_LADDER:
        for v in ref.keys():
            np.testing.assert_allclose(
                np.asarray(mine[v].data, np.float64),
                np.asarray(ref[v].data, np.float64), rtol=rtol, atol=0.0,
                err_msg=f"API phase: {v} at rtol {rtol:g}")
    return rel


def check_state(state, n_members: int, what: str):
    for name in PROGNOSTICS:
        for lev in state[name]:
            if lev.shape[0] != n_members:
                raise RuntimeError(f"{what}: {name} lost its member axis")
            if not bool(torch.isfinite(lev).all()):
                raise RuntimeError(f"{what}: non-finite values in {name}")
    if bool(state["error_flag"].any()):
        raise RuntimeError(f"{what}: error_flag set")


def member_spread(state) -> float:
    """Largest difference of any member from member 0, relative to the
    field's largest value, over the prognostics."""
    worst = 0.0
    for name in PROGNOSTICS:
        x = state[name][0]
        worst = max(worst, float((x - x[:1]).abs().max() / x.abs().max()))
    return worst


def to_gpu(state):
    move = lambda v: (tuple(a.cuda() for a in v) if isinstance(v, tuple)
                      else v.cuda())
    return {k: move(v) for k, v in state.items()}


def report(n_members, n_steps, wall_s, dev_ms):
    step_ms = 1e3 * wall_s / n_steps
    dev = ("device time not measured" if dev_ms is None else
           f"device busy {dev_ms:.3f} ms/step = "
           f"{100 * dev_ms / step_ms:.1f}%")
    return (f"B={n_members}: {n_members * n_steps / wall_s:.1f} "
            f"member-steps/s ({step_ms:.3f} ms/step, {dev})")


def take_member(state: dict, m: int) -> dict:
    """Member m of a member-batched state, as a state of one member."""
    one = lambda a: a[m:m + 1]
    return {k: ((tuple(one(a) for a in v) if isinstance(v, tuple) else one(v))
                if k in M.CARRY_FIELDS else v) for k, v in state.items()}


def graph_evals(first: int, n_steps: int) -> list:
    """The steps whose body a fresh runner's graph run calls through the
    kernel wrappers: the first step of each graph key in the window (the
    shortwave kind by the parity of the leapfrog pair's buffers, which
    restarts at every run call) three times, its eager warm-up, its capture
    and its traced twin's capture (a capture calls every wrapper once and
    launches nothing; the replays call none)."""
    firsts = {}
    for s in range(first, first + n_steps):
        firsts.setdefault((s % 3 == 0, (s - first) % 2), s)
    return sorted(3 * list(firsts.values()))


def expected_path_launches(consts, first: int, n_steps: int, evals=None,
                           with_init: bool = True):
    """(kernel launches, transform fields) of n_steps of the batched runner
    from step `first`, through the wrappers of each step in `evals` (every
    step: the eager loop; graph_evals: a fresh runner's graphs), the daily
    forcing of each step that starts a day, and with_init an
    initialization (two bootstrap steps with shortwave, one forcing): one
    grid-dynamics and, with the physics on, one physics launch a step
    evaluation (the shortwave variant when stepno % 3 == 0), one spectral
    update a step evaluation on the semi-implicit branch and none on the
    explicit one, and the fused transforms on the kernel route (at T47 and
    T63 under their own counters, one launch a group for both of a
    direction's kernels). With bf16_tendencies the
    runner's evaluations take the bfloat16 instantiations (the spectral
    update, the inverse groups and the forcing's transforms stay float32),
    the initialization the float32 ones. With SPPT (and the physics) one
    noise launch a chunk of the run call at N_MEMBERS members, and with_init
    three: the stationary draw and each bootstrap step's own."""
    p = consts.params
    evals = list(range(first, first + n_steps)) if evals is None else evals
    n_sw = sum(1 for s in evals if s % 3 == 0)
    n_forcings = sum(1 for s in range(first, first + n_steps)
                     if s % p.nsteps == 0)
    bf = "_bf16" if consts.bf16_tendencies else ""
    semi = p.alph >= 0.5
    launches = dict.fromkeys(ck.launch_counts, 0)
    fields = dict.fromkeys(tk.field_counts, 0)

    def add(counts, name, n):
        counts[name] += n

    add(launches, "grid_dynamics" + bf, len(evals))
    add(launches, "spectral_update", len(evals) if semi else 0)
    if consts.physics_on:
        add(launches, "grid_physics_sw" + bf, n_sw)
        add(launches, "grid_physics_nosw" + bf, len(evals) - n_sw)
    if with_init:
        add(launches, "grid_dynamics", 2)
        add(launches, "spectral_update", 2 if semi else 0)
        if consts.physics_on:
            add(launches, "grid_physics_sw", 2)
    if p.sppt_on:
        if consts.physics_on and n_steps:
            add(launches, "sppt_noise",
                -(-n_steps // SP.chunk_steps(p, N_MEMBERS)))
        if with_init:
            add(launches, "sppt_noise", 3 if consts.physics_on else 1)
    if consts.sp.use_fused_kernels:
        hires = "" if consts.sp.use_dense_legendre else "_hires"
        g2s, s2g = "fused_grid2spec" + hires, "fused_spec2grid" + hires
        (dl, df), (il, inv_f) = expected_transforms(consts, len(evals), 0,
                                                    False)
        for counts, d, i in ((launches, dl, il), (fields, df, inv_f)):
            add(counts, g2s + bf, d)
            add(counts, g2s, 2 * n_forcings)
            add(counts, s2g, i)
        if with_init:
            (dl, df), (il, inv_f) = expected_transforms(consts, 2, 1, True)
            for counts, d, i in ((launches, dl, il), (fields, df, inv_f)):
                add(counts, g2s, d)
                add(counts, s2g, i)
    return launches, fields


def read_path_counts(what: str, consts, first: int, n_steps: int,
                     evals=None, with_init: bool = True) -> dict:
    """The launch and field counts of the path just run, held to
    expected_path_launches (the same `evals`, `with_init`), and no call of
    a plain version; raises otherwise. Returns the launch counts."""
    launches, fields = dict(ck.launch_counts), dict(tk.field_counts)
    plain = plain_calls()
    want, want_fields = expected_path_launches(consts, first, n_steps, evals,
                                               with_init)
    if launches != want or fields != want_fields or any(plain.values()):
        raise RuntimeError(f"{what}: launches {launches}, expected {want}; "
                           f"transform fields {fields}, expected "
                           f"{want_fields}; plain calls {plain}")
    return launches


def records_by_counter(by_kernel: dict, n_steps: int, sp) -> dict:
    """{launch counter: device records} of a profiled float32 window
    (utils.profiling.window_profile's by_kernel over n_steps): each
    kernel's records under its counter, the physics kernel's split by its
    shortwave template argument (grid_physics_kernel<T, NLEV, SW, ...>)."""
    out = dict.fromkeys(ck.launch_counts, 0)
    for key, (_, per_step) in by_kernel.items():
        for counter in KERNEL_OF_COUNTER:
            names = _kernel_names(counter, sp)
            kernel = names[0] if names else None
            if counter.endswith("_bf16") or kernel is None \
                    or kernel + "<" not in key:
                continue
            if kernel == "grid_physics_kernel":
                args = key.split(kernel + "<", 1)[1].split(",")
                if (args[2].strip() == "true") != (counter ==
                                                   "grid_physics_sw"):
                    continue
            out[counter] += round(n_steps * per_step)
    return out


def profiled_graph_day(consts, state0, cal, n_steps: int):
    """The main path's run call as a user makes it: a fresh runner's first
    call, n_steps from step 2 through its CUDA graphs (each step kind's
    eager warm-up and captures included), under the profiler
    (window_profile). The device's records of each kernel counter must be
    every step's (expected_path_launches without the initialization) and
    the wrappers' calls those of the warm-ups and captures (a graph and its traced twin a key) (graph_evals);
    a window the tracer did not record whole is run again through a fresh
    runner, three windows at most; then this raises. Returns (runner,
    state, calendar after, wall seconds under the profiler, device records
    by counter, wrapper calls by counter, transform fields of the wrapper
    calls)."""
    want = expected_path_launches(consts, 2, n_steps, with_init=False)[0]
    for attempt in range(3):
        reset_counts()
        run = make_run_steps_batched(consts, device="cuda")
        if run.graphs is None or not takes_graphs("cuda"):
            raise RuntimeError("the runner on the card must take the graphs")
        ctx, cal_day = M.build_step_ctx(dataclasses.replace(cal), 2, n_steps)
        out = {}
        t0 = time.perf_counter()
        prof = window_profile(lambda: out.update(state=run(state0, ctx)),
                              n_steps)
        secs = time.perf_counter() - t0
        calls = read_path_counts("main path, the graph day's wrapper calls",
                                 consts, 2, n_steps, graph_evals(2, n_steps),
                                 with_init=False)
        got = records_by_counter(prof["by_kernel"], n_steps, consts.sp)
        if got == want:
            return (run, out["state"], cal_day, secs, got, calls,
                    dict(tk.field_counts))
        print(f"  (profiled graph day {attempt + 1} is not whole: {got} "
              f"records of {want})")
        del run, out
        time.sleep(1.0)
    raise RuntimeError(f"main path: the profiler recorded {got} launches of "
                       f"the graph day, which makes {want}")


def _levels(v):
    return v if isinstance(v, tuple) else (v,)


def bitwise_states(got, want) -> tuple:
    """(every field of `want` bitwise in `got`, {field: largest difference
    relative to its largest value} of the fields that differ)."""
    diffs = {}
    for name in want:
        for a, b in zip(_levels(got[name]), _levels(want[name])):
            if a.shape != b.shape or a.dtype != b.dtype:
                diffs[name] = float("inf")
            elif not torch.equal(a, b):
                a64, b64 = a.double(), b.double()
                diffs[name] = max(diffs.get(name, 0.0), float(
                    (a64 - b64).abs().max() / (b64.abs().max() or 1.0)))
    return not diffs, diffs


TURNS = ("graph", "eager", "eager", "graph")


def graphs_phase(name: str, consts, run, state0, cal, n_steps: int,
                 out_graph, cal_day, captured: dict, card: str,
                 gate: bool = True,
                 prof_steps: int = N_STEPS_PROFILED) -> dict:
    """The graphs against the eager loop on one path. `out_graph` is the
    path's day (n_steps from step 2 from state0, calendar `cal`) just run
    through the runner's graphs, `captured` the graphs' stats before it.
    The eager day of the same runner from state0 with its launch counts
    held to every step's (read_path_counts), every field of the two days
    compared bitwise (a difference raises where `gate`); then windows of
    n_steps (at most N_STEPS) in turns, graph, eager, eager, graph,
    continuing from the graph day, and a profiled window of prof_steps in
    each mode (busy ms, device launches held to the window's, the host's
    enqueue calls, per step). Prints one line; returns the figures."""
    stats = run.graphs.stats
    cap = {k: stats[k] - captured[k] for k in
           ("captures", "capture_s", "pool_bytes", "buffer_bytes")}
    reset_counts()
    out_eager, _, secs_eager_day = run_window(run, state0, cal, 2, n_steps,
                                              eager=True)
    eager_launches = read_path_counts(f"{name}, eager day", consts, 2,
                                      n_steps, with_init=False)
    same, diffs = bitwise_states(out_graph, out_eager)
    del out_eager
    if gate and not same:
        raise RuntimeError(f"graphs, {name}: the graph day differs from the "
                           f"eager day: {diffs}")
    times = {"graph": [], "eager": []}
    state, c, first = out_graph, cal_day, 2 + n_steps
    n_turn = min(n_steps, N_STEPS)
    for mode in TURNS:
        state, c, secs = run_window(run, state, c, first, n_turn,
                                    eager=mode == "eager")
        times[mode].append(1e3 * secs / n_turn)
        first += n_turn
    check_state(state, state["vor"][0].shape[0], f"{name}, turns")
    # The profiled graph window's copies (StepGraphs.stats of its call):
    # its copy records may exceed the eager window's by these alone. The
    # tracer can lose a record of either window (a copy is not among the
    # kernels device_time_per_step holds whole): both windows are profiled
    # again, three pairs at most; then this raises.
    for attempt in range(3):
        prof = {mode: device_time_per_step(run, state, c, first, prof_steps,
                                           consts, eager=mode == "eager")
                for mode in ("graph", "eager")}
        g, e = prof["graph"], prof["eager"]
        count = dict(stats["copies"])
        copies = {"copies_per_step": stats["copies_per_step"],
                  "copied": stats["copied"], "count": count,
                  "records": {m: sum(n for _, n in x["copies"].values())
                              for m, x in (("graph", g), ("eager", e))}}
        allowed = sum(count[k] for k in COPY_KINDS) / count["steps"]
        copies["allowed"] = allowed
        excess = copies["records"]["graph"] - copies["records"]["eager"]
        if excess <= allowed + 1e-9:
            break
        print(f"  (profiled windows {attempt + 1}: {excess:.3f} copy "
              f"records a step over the eager window's, {allowed:.3f} "
              f"counted; graph {_copy_summary(g['copies'])}; eager "
              f"{_copy_summary(e['copies'])})")
    else:
        raise RuntimeError(
            f"graphs, {name}: {excess:.3f} copy records a step over the "
            f"eager window's, more than the {allowed:.3f} the runner "
            f"counted ({count}), in three pairs of windows: a copy it does "
            f"not count")
    print(f"graphs, {name}: graph day (CUDA graphs, {cap['captures']} "
          f"captures in {cap['capture_s']:.3f} s; pool "
          f"{cap['pool_bytes'] / 1e6:.1f} MB, static buffers "
          f"{cap['buffer_bytes'] / 1e6:.1f} MB) "
          + ("bitwise equal to" if same else "NOT bitwise equal to")
          + " the eager day" + ("" if same else f" (largest rel. difference "
                                 + ", ".join(f"{k} {v:.3e}" for k, v in
                                             diffs.items()) + ")")
          + f"; eager day's launches exact; wall ms/step in turns of "
          f"{n_turn}-step windows, graph "
          + ", ".join(f"{x:.3f}" for x in times["graph"]) + "; eager "
          + ", ".join(f"{x:.3f}" for x in times["eager"])
          + f"; {prof_steps}-step profiled windows: busy ms/step graph "
          f"{g['busy_ms']:.3f}, eager {e['busy_ms']:.3f} (in-graph copies "
          f"and buffers {g['busy_ms'] - e['busy_ms']:+.3f}); device "
          f"launches/step graph {g['launches']:.2f}, eager "
          f"{e['launches']:.2f}; the host's enqueue calls/step graph "
          f"{g['host_calls']:.2f}, eager {e['host_calls']:.2f}; busy ms "
          f"over the fastest window's wall ms "
          f"{100 * g['busy_ms'] / min(times['graph']):.1f} % (graph), "
          f"{100 * e['busy_ms'] / min(times['eager']):.1f} % (eager) "
          f"[{card}]")
    print(f"graphs, {name}: copies into buffers "
          f"{copies['copies_per_step']:.2f} a step in the profiled "
          f"{prof_steps}-step graph window; the call's copies by kind "
          f"{count}: {allowed:.3f} a step, against {excess:.3f} copy records "
          f"a step over the eager window's (the step graphs copy "
          f"{', '.join(copies['copied']['step']) or 'nothing'}; the daily "
          f"forcing {', '.join(copies['copied']['forcing']) or 'nothing'}); "
          f"copy records a step by name (ms a step), graph: "
          f"{_copy_summary(g['copies'])}; eager: "
          f"{_copy_summary(e['copies'])}")
    return {"bitwise": same, "diffs": diffs, "captures": cap,
            "copies": copies,
            "ms_per_step": times, "eager_day_s": secs_eager_day,
            "eager_launches": eager_launches,
            "profile": {m: {k: v for k, v in x.items() if k != "top"}
                        for m, x in prof.items()},
            "top": {m: x["top"] for m, x in prof.items()},
            "state": state, "cal": c, "first": first}


def card_vs_cpu(params, n_members: int, n_steps: int, what: str,
                bf16_tendencies: bool = False):
    """float64 from the same initial state (the card's initialization,
    copied to the host) through the card's kernels and through the CPU's
    plain versions, grid_phi on in both (and bf16_tendencies as given):
    the largest difference over the prognostics and six physics fields,
    relative to each field's largest value, and the card's kernel
    launches. Raises past 1e-9."""
    consts_g, state_g, cal = make_demo_model(
        params, device="cuda", grid_phi=True,
        bf16_tendencies=bf16_tendencies)
    consts_c, _ = M.build_consts(params, device="cpu", grid_phi=True,
                                 bf16_tendencies=bf16_tendencies)
    state_c = {k: (tuple(a.cpu() for a in v) if isinstance(v, tuple)
                   else v.cpu()) for k, v in state_g.items()}
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, n_steps)
    out_c = make_run_steps_batched(consts_c, device="cpu")(
        broadcast_state(state_c, n_members), ctx)
    ck.reset_launch_counts()
    GK.reset_plain_calls()
    out_g = make_run_steps_batched(consts_g, device="cuda")(
        broadcast_state(state_g, n_members), ctx)
    torch.cuda.synchronize()
    launches = dict(ck.launch_counts)
    check_state(out_g, n_members, what)
    fields = [(n, out_g[n][0], out_c[n][0]) for n in PROGNOSTICS]
    fields += [(n, out_g[n], out_c[n]) for n in
               ("phi", "hfluxn", "precnv", "precls", "olr", "tsr")]
    worst, worst_name = 0.0, ""
    for name, a, b in fields:
        err = float((a.cpu() - b).abs().max() / (b.abs().max() or 1.0))
        if err > worst:
            worst, worst_name = err, name
    if not worst <= 1e-9 or any(GK.plain_calls.values()):
        raise RuntimeError(f"{what}: float64 card vs CPU {worst:.3e} in "
                           f"{worst_name} (limit 1e-9), plain calls "
                           f"{GK.plain_calls}")
    return worst, worst_name, launches


def glue_plan(libs, params) -> dict:
    """Row 6's launch plan at params' (kx, ntr, nx) for N_MEMBERS members
    on this card, from the kernel's own planner, held to its model
    (GK.update_launch_plan), and the CUDA runtime's occupancy of it: members
    a unit, threads and dynamic shared memory a block, blocks per SM (the
    plan's, which the runtime must allow), registers, local memory, blocks,
    members a block (the tile) and the waves of the grid."""
    import ctypes
    out = (ctypes.c_int * 7)()
    fn = ctypes.CDLL(str(libs["spectral_update"])) \
        .pyspeedy_spectral_update_occupancy
    size = 4 if params.precision == "f32" else 8
    rc = fn(size, params.kx, params.ntr, params.nx, out)
    if rc != 0:
        raise RuntimeError(f"spectral_update launch plan at nx={params.nx} "
                           f"failed with {rc}")
    resident, threads, smem, regs, local, _, _ = out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = GK.library_launch_plan(size, params.kx, params.ntr, params.nx,
                                 params.mx, N_MEMBERS, sms)
    model = GK.update_launch_plan(params.nx, params.mx, params.kx,
                                  params.ntr, size, N_MEMBERS, sms)
    if any(lib[k] != model[k] for k in lib) or resident < lib[
            "blocks_per_sm"] or local:
        raise RuntimeError(f"spectral_update plan at nx={params.nx}: the "
                           f"library's {lib}, the model's {model}, the "
                           f"runtime's {resident} blocks an SM, {local} "
                           f"bytes of local memory")
    return {"nx": params.nx, "lanes": lib["lanes"], "threads": threads,
            "smem_bytes": smem, "blocks_per_sm": lib["blocks_per_sm"],
            "registers": regs, "blocks": lib["blocks"], "tile": lib["tile"],
            "waves": lib["blocks"] / (sms * lib["blocks_per_sm"]),
            "busy_lanes": lib["lanes"] * 2 * params.nx / threads}


def explicit_path(card: str, phases) -> dict:
    """The explicit gravity-wave branch at full width: T30L8 f32 with
    alph = 0 and 144 steps a day, the full physics, initialization (both
    bootstrap steps through the branch) and one model day of N_MEMBERS
    members. Exact launches of rows 1-4 and none of the spectral update or
    of a plain version; busy ms and launches a step; a member run alone
    equal bitwise to that member of B=8 (distinct members); float64 on the
    card against the CPU at B=4."""
    p32 = dataclasses.replace(T30L8, precision="f32", fft_mode="matmul",
                              **EXPLICIT)
    n_steps = p32.nsteps
    reset_counts()
    consts, state1, cal = make_demo_model(p32, device="cuda")
    run = make_run_steps_batched(consts, device="cuda")
    state0 = broadcast_state(state1, N_MEMBERS)
    captured = dict(run.graphs.stats)
    state, cal_day, secs = run_window(run, state0, cal, 2, n_steps)
    launches = read_path_counts("explicit path", consts, 2, n_steps,
                                graph_evals(2, n_steps))
    check_state(state, N_MEMBERS, "explicit path")
    print(f"explicit path: T30L8 f32 alph=0.0, {n_steps} steps a day (dt "
          f"{p32.delt:.0f} s), full physics, {N_MEMBERS} members x {n_steps} "
          f"steps + initialization through the CUDA graphs: finite, "
          f"error_flag false; launches {launches} (the initialization and "
          f"each step kind's warm-up and captures; spectral_update 0: the "
          f"branch runs plain PyTorch after the transforms and the column "
          f"kernels), no plain version called; first graph day "
          f"{1e3 * secs / n_steps:.3f} ms/step [{card}]")
    gph = graphs_phase("explicit path", consts, run, state0, cal, n_steps,
                       state, cal_day, captured, card)
    gph.pop("state")
    del state0
    g = gph["profile"]["graph"]
    print(f"explicit path, by kernel ({N_STEPS_PROFILED}-step graph window), "
          f"ms/step "
          f"(launches/step): " + "; ".join(
              f"{k} {ms:.3f} ({n:.2f})" for k, ms, n in gph["top"]["graph"]))

    # A member alone against the same member of B=8, each member's
    # temperature perturbed apart: the bits may not depend on the batch.
    rng = np.random.default_rng(12)
    pert = broadcast_state(state1, 8)
    tri = (np.arange(p32.mx)[:, None] + np.arange(p32.nx)[None, :]
           <= p32.trunc)
    noise = 0.01 * rng.standard_normal(tuple(pert["t"][0].shape)) * tri
    noise[:, 1, :, 0, :] = 0.0          # m = 0 coefficients are real
    noise = torch.from_numpy(noise).to("cuda", p32.dtype)
    pert["t"] = (pert["t"][0] + noise, pert["t"][1] + noise)
    who = 5
    phases.start("explicit path, B=1 against B=8")
    out8, _, _ = run_window(run, pert, cal, 2, 12)
    out1, _, _ = run_window(run, take_member(pert, who), cal, 2, 12)
    check_state(out8, 8, "explicit path, B=8")
    names = PROGNOSTICS + ("phi", "precnv", "precls", "hfluxn")
    levels = lambda x: x if isinstance(x, tuple) else (x,)
    same = all(torch.equal(a[who:who + 1], b)
               for n in names
               for a, b in zip(levels(out8[n]), levels(out1[n])))
    spread = member_spread(out8)
    if not same or not spread > 1e-6:
        raise RuntimeError(f"explicit path: member {who} alone differs from "
                           f"that member of B=8 (or members do not differ: "
                           f"{spread:.3e})")
    # The hazard the level sum of spectral_linear_tendencies was repaired
    # for: as an einsum (a matrix product), a member's sum may follow the
    # batch width; as a product and a sum over the level axis it may not.
    div = state["div"][0]
    dhs = consts.col.dhs
    dep = {}
    for form, fn in (("einsum", lambda x: torch.einsum(
            "k,bckmn->bcmn", dhs[:, 0, 0], x)),
                     ("product and sum", lambda x: torch.sum(dhs * x, dim=2))):
        whole = fn(div)
        dep[form] = max(float((whole[m:m + 1] - fn(div[m:m + 1])).abs().max())
                        for m in range(0, N_MEMBERS, 9))
    if dep["product and sum"] != 0.0:
        raise RuntimeError(f"explicit path: the level sum depends on the "
                           f"batch: {dep}")
    phases.start("explicit path, f64 card vs CPU")
    p64 = dataclasses.replace(T30L8, fft_mode="matmul", **EXPLICIT)
    worst, worst_name, launches64 = card_vs_cpu(
        p64, 4, N_STEPS_F64_EXPLICIT, "explicit path f64")
    if launches64["spectral_update"] != 0:
        raise RuntimeError("the explicit f64 run launched the spectral update")
    print(f"explicit path: member {who} alone (B=1) equals member {who} of "
          f"B=8 bitwise after 12 steps ({', '.join(names)}; members differ "
          f"by {spread:.3e}); f64 B=4 {N_STEPS_F64_EXPLICIT} steps card vs "
          f"CPU: max rel err {worst:.3e} in {worst_name} (limit 1e-9); the "
          f"level sum of the linear terms on the day's divergence, member "
          f"alone against B={N_MEMBERS}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in dep.items()))
    return {"launches": launches, "busy_ms": g["busy_ms"],
            "launches_per_step": g["launches"], "graphs": gph,
            "f64_max_rel_err": worst}


def preset_path(name: str, base, libs, card: str, phases) -> dict:
    """A preset beyond T30 (T47L8, T63L8) at full width in f32: rows 1, 2
    and 6 against their plain versions at its shapes, row 6's launch plan,
    rows 3-4 (csrc/fused_transform_hires.cu) against the einsum chain in
    f32 and f64 (check_transforms_hires), then initialization and one model
    day of N_MEMBERS members with the full physics through the T47/T63
    transform kernels (their own counters, no einsum chain), busy ms and
    launches a step, member 0 of B=N_MEMBERS bitwise the same member run
    alone, the graph day bitwise the eager day, and float64 at B=1 on the
    card against the CPU (the einsum chain there)."""
    p32 = dataclasses.replace(base, precision="f32", fft_mode="matmul")
    phases.start(f"{name} kernels against their plain versions")
    res = {"transforms": check_transforms_hires(p32, 1e-5, card, libs),
           "transforms_f64": check_transforms_hires(
               dataclasses.replace(base, fft_mode="matmul"), 1e-12, card,
               libs),
           "dyn": check_kernel(p32, N_MEMBERS, 1e-5, card),
           "phys": check_physics(p32, N_MEMBERS, 1e-5, card, ("grid_phi",),
                                 timed=True),
           "glue": check_spectral_update(p32, 1e-5, card, startup=False),
           "glue_f64": check_spectral_update(
               dataclasses.replace(base, fft_mode="matmul"), 1e-12, card,
               startup=False),
           "plan": glue_plan(libs, p32), "plan_f64": glue_plan(libs, base)}
    print(f"spectral_update launch plan at {name} (nx = {base.nx}), "
          f"B={N_MEMBERS}: "
          + "; ".join(f"{prec} {r['lanes']} member lanes, {r['threads']} "
                      f"threads ({100 * r['busy_lanes']:.1f} % on points) "
                      f"and {r['smem_bytes'] / 1024:.1f} KB shared "
                      f"memory a block, {r['blocks_per_sm']} blocks per SM, "
                      f"{r['registers']} registers, {r['blocks']} blocks of "
                      f"{r['tile']} members = {r['waves']:.3f} waves"
                      for prec, r in (("f32", res["plan"]),
                                      ("f64", res["plan_f64"]))))
    n_steps = p32.nsteps
    phases.start(f"{name} path, a day")
    reset_counts()
    consts, state1, cal = make_demo_model(p32, device="cuda")
    run = make_run_steps_batched(consts, device="cuda")
    state0 = broadcast_state(state1, N_MEMBERS)
    captured = dict(run.graphs.stats)
    state, cal_day, secs = run_window(run, state0, cal, 2, n_steps)
    res["launches"] = read_path_counts(f"{name} path", consts, 2, n_steps,
                                       graph_evals(2, n_steps))
    check_state(state, N_MEMBERS, f"{name} path")
    reset_counts()
    alone, _, _ = run_window(run, broadcast_state(state1, 1), cal, 2, n_steps)
    res["launches_b1"] = dict(ck.launch_counts)
    if (not all(res["launches_b1"][k] > 0 for k in (
            "fused_grid2spec_hires", "fused_spec2grid_hires"))
            or any(plain_calls().values())):
        raise RuntimeError(f"{name} path, B=1: launches {res['launches_b1']}"
                           f", plain calls {plain_calls()}")
    names = PROGNOSTICS + ("phi", "precnv", "precls", "hfluxn")
    first = lambda x: (tuple(a[:1] for a in x) if isinstance(x, tuple)
                       else x[:1])
    same, diffs = bitwise_states({n: first(state[n]) for n in names},
                                 {n: alone[n] for n in names})
    res["member0_b128_vs_b1_bitwise"] = same
    res["f32_model"] = (run, state1, cal)
    del alone
    if not same:
        raise RuntimeError(f"{name} path: member 0 of B={N_MEMBERS} differs "
                           f"from it alone after the day: {diffs}")
    print(f"{name} path: f32, full physics, {N_MEMBERS} members x {n_steps} "
          f"steps (a model day) + initialization through the CUDA graphs: "
          f"finite, error_flag false; launches {res['launches']} (the "
          f"initialization and each step kind's warm-up and captures; the "
          f"T47/T63 transform kernels, one launch a group), no plain version "
          f"and no einsum chain called; first graph day "
          f"{1e3 * secs / n_steps:.3f} ms/step; member 0 of B={N_MEMBERS} "
          f"bitwise equal to it alone after the day ({', '.join(names)}) "
          f"[{card}]")
    # The physics kernel on the path's own columns after the day (float32,
    # the path's grid_phi mode), the inverse transforms' bits in its inputs.
    check_physics(p32, N_MEMBERS, 1e-5, card, ("grid_phi",),
                  inputs=state_physics_inputs(consts, state))
    gph = graphs_phase(f"{name} path", consts, run, state0, cal, n_steps,
                       state, cal_day, captured, card)
    gph.pop("state")
    del state0, state
    g, e = gph["profile"]["graph"], gph["profile"]["eager"]
    res.update(busy_ms=g["busy_ms"], launches_per_step=g["launches"],
               ms_per_step=min(gph["ms_per_step"]["graph"]), graphs=gph)
    print(f"{name} path ({N_STEPS_PROFILED}-step windows): busy ms/step "
          f"graph {g['busy_ms']:.3f} against eager {e['busy_ms']:.3f} "
          f"({g['busy_ms'] - e['busy_ms']:+.3f}); launches/step graph "
          f"{g['launches']:.2f} against eager {e['launches']:.2f}; wall "
          f"ms/step graph {min(gph['ms_per_step']['graph']):.3f} against "
          f"eager {min(gph['ms_per_step']['eager']):.3f} (fastest windows) "
          f"[{card}]")
    print(f"{name} path ({N_STEPS_PROFILED}-step graph window): by group, "
          f"ms/step: "
          + "; ".join(f"{k} {v:.3f}" for k, v in g["groups"].items())
          + "; by kernel, ms/step (launches/step): "
          + "; ".join(f"{k} {ms:.3f} ({n:.2f})"
                      for k, ms, n in gph["top"]["graph"]))
    phases.start(f"{name} path, f64 card vs CPU")
    worst, worst_name, launches64 = card_vs_cpu(
        dataclasses.replace(base, fft_mode="matmul"), 1, N_STEPS_F64_PRESET,
        f"{name} f64")
    if not all(launches64[k] > 0 for k in ("fused_grid2spec_hires",
                                           "fused_spec2grid_hires")):
        raise RuntimeError(f"{name} f64 card run: launches {launches64}")
    res["f64_max_rel_err"] = worst
    print(f"{name} f64 B=1 {N_STEPS_F64_PRESET} steps card vs CPU: max rel "
          f"err {worst:.3e} in {worst_name} (limit 1e-9)")
    return res


def bf16_preset_path(name: str, base, libs, card: str, phases,
                     f32_model) -> dict:
    """The bf16_tendencies configuration at a preset beyond T30 (T47L8,
    T63L8), as the JAX package runs it there (the bfloat16 grid widened
    before the ordinary transform): row 3 with a bfloat16 grid in float32
    and float64 (check_transforms_hires_bf16), rows 1 and 2 with bfloat16
    outputs in float32 and from float64 (check_bf16_outputs); then one
    model day of N_MEMBERS members with the flag through the CUDA graphs,
    its launch counts (the bfloat16 instantiations on the steps, the
    einsum chain and every plain version never called), the graph day
    bitwise the eager day, member 0 bitwise the same member run alone;
    N_STEPS_BF16 steps from the same state against preset_path's float32
    model (`f32_model`: its runner, state and calendar), the prognostics
    within the JAX package's bounds of its own short bfloat16 runs and
    moved by more than 1e-8; and a float64 day with the flag at B=1, the
    card against the CPU."""
    p32 = dataclasses.replace(base, precision="f32", fft_mode="matmul")
    p64 = dataclasses.replace(base, fft_mode="matmul")
    phases.start(f"{name} bf16_tendencies kernels")
    res = {"transform": check_transforms_hires_bf16(p32, 1e-5, card, libs),
           "transform_f64": check_transforms_hires_bf16(p64, 1e-12, card,
                                                        libs),
           "outputs": check_bf16_outputs(p32, card),
           "outputs_f64": check_bf16_outputs(p64, card)}
    n_steps = p32.nsteps
    phases.start(f"{name} bf16_tendencies path, a day")
    reset_counts()
    consts, state1, cal = make_demo_model(p32, device="cuda",
                                          bf16_tendencies=True)
    run = make_run_steps_batched(consts, device="cuda")
    state0 = broadcast_state(state1, N_MEMBERS)
    captured = dict(run.graphs.stats)
    state, cal_day, secs = run_window(run, state0, cal, 2, n_steps)
    res["launches"] = read_path_counts(f"{name} bf16_tendencies path",
                                       consts, 2, n_steps,
                                       graph_evals(2, n_steps))
    fields = dict(tk.field_counts)
    check_state(state, N_MEMBERS, f"{name} bf16_tendencies path")
    reset_counts()
    alone, _, _ = run_window(run, broadcast_state(state1, 1), cal, 2, n_steps)
    if (ck.launch_counts["fused_grid2spec_hires_bf16"] == 0
            or any(plain_calls().values())):
        raise RuntimeError(f"{name} bf16_tendencies path, B=1: launches "
                           f"{ck.launch_counts}, plain calls {plain_calls()}")
    names = PROGNOSTICS + ("phi", "precnv", "precls", "hfluxn")
    first = lambda x: (tuple(a[:1] for a in x) if isinstance(x, tuple)
                       else x[:1])
    same, diffs = bitwise_states({n: first(state[n]) for n in names},
                                 {n: alone[n] for n in names})
    res["member0_b128_vs_b1_bitwise"] = same
    del alone
    if not same:
        raise RuntimeError(f"{name} bf16_tendencies path: member 0 of "
                           f"B={N_MEMBERS} differs from it alone: {diffs}")
    print(f"{name} bf16_tendencies path: f32, full physics, {N_MEMBERS} "
          f"members x {n_steps} steps (a model day) + initialization through "
          f"the CUDA graphs: finite, error_flag false; launches "
          f"{res['launches']} (the bfloat16 instantiations on each step "
          f"kind's warm-up and captures, the float32 ones on the two "
          f"bootstrap steps and the forcing), transform fields {fields}, no "
          f"plain version and no einsum chain called; first graph day "
          f"{1e3 * secs / n_steps:.3f} ms/step; member 0 of B={N_MEMBERS} "
          f"bitwise equal to it alone after the day ({', '.join(names)}) "
          f"[{card}]")
    gph = graphs_phase(f"{name} bf16_tendencies path", consts, run, state0,
                       cal, n_steps, state, cal_day, captured, card)
    gph.pop("state")
    del state0, state
    # The flag against float32 from the same state, N_STEPS_BF16 steps of
    # each runner's eager loop (the graph day is bitwise its eager day).
    run32, state32, cal32 = f32_model
    out_f, _, _ = run_window(run32, broadcast_state(state32, N_MEMBERS),
                             cal32, 2, N_STEPS_BF16, eager=True)
    out_b, _, _ = run_window(run, broadcast_state(state1, N_MEMBERS), cal, 2,
                             N_STEPS_BF16, eager=True)
    moved, rels = 0.0, {}
    for field, bound in (("t", 1e-3), ("ps", 1e-3), ("vor", 5e-2),
                         ("div", 5e-2)):
        a, b = out_f[field][0], out_b[field][0]
        if b.dtype != torch.float32:
            raise RuntimeError(f"{field} left float32 with bf16_tendencies")
        rels[field] = _rel(b, a)
        moved = max(moved, rels[field])
        if not rels[field] < bound:
            raise RuntimeError(f"{name} bf16_tendencies: {field} differs "
                               f"from the float32 run by {rels[field]:.3e} "
                               f"after {N_STEPS_BF16} steps (bound {bound:g})")
    if not moved > 1e-8:
        raise RuntimeError(f"{name} bf16_tendencies had no effect")
    del out_f, out_b
    print(f"{name} bf16_tendencies path: prognostics vs the float32 run after "
          f"{N_STEPS_BF16} steps from the same state, B={N_MEMBERS}, rel. to "
          f"each field's largest value: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + " (bounds t, ps 1e-3; vor, div 5e-2; and more than 1e-8)")
    g = gph["profile"]["graph"]
    res.update(busy_ms=g["busy_ms"], launches_per_step=g["launches"],
               ms_per_step=min(gph["ms_per_step"]["graph"]), graphs=gph,
               rel_vs_f32=rels, fields=fields)
    print(f"{name} bf16_tendencies path ({N_STEPS_PROFILED}-step graph "
          f"window): busy ms/step {g['busy_ms']:.3f}; by group, ms/step: "
          + "; ".join(f"{k} {v:.3f}" for k, v in g["groups"].items())
          + "; by kernel, ms/step (launches/step): "
          + "; ".join(f"{k} {ms:.3f} ({n:.2f})"
                      for k, ms, n in gph["top"]["graph"]) + f" [{card}]")
    phases.start(f"{name} bf16_tendencies path, f64 card vs CPU")
    worst, worst_name, launches64 = card_vs_cpu(
        p64, 1, N_STEPS_F64_PRESET, f"{name} f64 bf16_tendencies",
        bf16_tendencies=True)
    if not all(launches64[k] > 0 for k in (
            "fused_grid2spec_hires_bf16", "grid_dynamics_bf16",
            "fused_spec2grid_hires")):
        raise RuntimeError(f"{name} f64 bf16_tendencies card run: launches "
                           f"{launches64}")
    res["f64_max_rel_err"] = worst
    res["launches_f64"] = launches64
    print(f"{name} f64 bf16_tendencies B=1 {N_STEPS_F64_PRESET} steps card "
          f"vs CPU: max rel err {worst:.3e} in {worst_name} (limit 1e-9); "
          f"launches {launches64}")
    return res


# ---------------------------------------------------------------------------
# The multi-device phase: the ("ensemble", "space") mesh in four processes
# ---------------------------------------------------------------------------

MD_WORLD = 4
MD_STATE_FIELDS = PROGNOSTICS + ("land_temp", "sst_om")
MD_DIAG_FIELDS = ("tt_rsw", "precnv", "hfluxn")
MD_FIELDS = MD_STATE_FIELDS + MD_DIAG_FIELDS
# The 2x2 mesh's float32 day against the unsharded day. Bands change the
# order of the Legendre sums only (the all_reduce of partial sums); a day of
# float32 steps carries such last-bit differences along, and where one puts
# a column on the other side of a threshold of the physics (a cloud, a
# convection top) that column's physics diagnostics differ by their own
# size. So: the prognostic and surface state within MD_F32_LIMIT of each
# field's largest value; of the physics diagnostics at most MD_DIAG_SHARE
# of the values beyond that.
MD_F32_LIMIT = 1e-3
MD_DIAG_SHARE = 1e-2
MD_F64_LIMIT = 1e-9
N_STEPS_MD64 = 6
N_MEMBERS_MD64 = 8


def _cpu_fields(state, names):
    return {k: (tuple(a.cpu() for a in state[k])
                if isinstance(state[k], tuple) else state[k].cpu())
            for k in names}


def _field_diffs(got, want) -> dict:
    """{field: largest |difference| relative to the field's largest value}."""
    out = {}
    for name, w in want.items():
        g = got[name]
        pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
        out[name] = max(float((a.cpu().double() - b.double()).abs().max()
                              / (float(b.abs().max()) or 1.0))
                        for a, b in pairs)
    return out


def _share_over(got, want, limit) -> dict:
    """{field: share of values differing by more than `limit` of the
    field's largest value}."""
    out = {}
    for name, w in want.items():
        g = got[name].cpu().double()
        w = w.double()
        out[name] = float(((g - w).abs() > limit * float(w.abs().max()))
                          .double().mean())
    return out


def f32_agreement(got, want) -> tuple:
    """(largest rel. differences by field, shares over MD_F32_LIMIT of the
    physics diagnostics, whether both are within their limits)."""
    diffs = _field_diffs(got, want)
    shares = _share_over(got, {k: want[k] for k in MD_DIAG_FIELDS},
                         MD_F32_LIMIT)
    ok = (all(diffs[k] <= MD_F32_LIMIT for k in MD_STATE_FIELDS)
          and all(v <= MD_DIAG_SHARE for v in shares.values()))
    return diffs, shares, ok


def _bitwise(got, want) -> bool:
    return all(torch.equal(a.cpu(), b) for name, w in want.items()
               for a, b in (zip(got[name], w) if isinstance(w, tuple)
                            else [(got[name], w)]))


def multidevice_rank(rank: int, world: int, init: str, backend: str,
                     tmp: str) -> None:
    """One rank of the multi-device phase, on its own card or on the card
    that the ranks share: the main path's day on the 4x1 mesh and on the 2x2
    mesh (bands of 24 latitudes), 6 float64 steps on the 2x2 mesh; each held
    to its launch and collective counts; rank 0 compares the gathered states
    with the unsharded runs the parent made. Writes rank{rank}.json; raises
    on a failed check."""
    import torch.distributed as dist
    tmp = Path(tmp)
    PDIST.initialize_distributed(init, world, rank, backend, "cuda")
    dev = PDIST.rank_device()
    meshes = {"4x1": PMESH.make_mesh(4, 1), "2x2": PMESH.make_mesh(2, 2)}
    res = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "group_backends": {k: {d: dist.get_backend(m.get_group(d))
                                  for d in PMESH.AXES}
                              for k, m in meshes.items()}}
    ref = torch.load(tmp / "ref.pt", weights_only=False)

    # 4x1: the main path as a user runs it, initialization included: every
    # rank builds the same single-member state and keeps its 32 members.
    reset_counts()
    consts, state1, cal = make_demo_model(T30L8, device=dev, precision="f32",
                                          fft_mode="matmul")
    mesh = meshes["4x1"]
    run = make_run_steps_batched(consts, device=dev, mesh=mesh)
    if run.graphs is not None:
        raise RuntimeError("a mesh must keep the runner's eager loop")
    local = PDIST.make_global_ensemble(state1, N_MEMBERS, mesh)
    local, cal_day, secs = run_window(run, local, cal, 2, N_STEPS)
    launches = read_path_counts(f"mesh 4x1, rank {rank}", consts, 2, N_STEPS)
    whole = PMESH.gather_state(mesh, local, names=MD_FIELDS + ("error_flag",))
    if bool(whole["error_flag"].any()):
        raise RuntimeError("mesh 4x1: error_flag set")
    _, _, warm = run_window(run, local, cal_day, 2 + N_STEPS, N_STEPS)
    res["4x1"] = {"launches": launches, "first_window_s": secs,
                  "ms_per_step": 1e3 * warm / N_STEPS,
                  "members": N_MEMBERS // 4}
    if rank == 0:
        res["4x1"]["initial_state_bitwise"] = _bitwise(
            _cpu_fields(state1, PROGNOSTICS), ref["state1"])
        res["4x1"]["bitwise"] = _bitwise(whole, ref["day"])
        (res["4x1"]["diffs"], res["4x1"]["shares"],
         res["4x1"]["within_f32_limits"]) = f32_agreement(whole, ref["day"])
    del local, whole

    # 2x2: the same day on bands of 24 latitudes, 64 members a rank.
    mesh = meshes["2x2"]
    run = make_run_steps_batched(consts, device=dev, mesh=mesh)
    local = PDIST.make_global_ensemble(state1, N_MEMBERS, mesh)
    reset_counts()
    PST.reset_counts()
    local, cal_day, secs = run_window(run, local, cal, 2, N_STEPS)
    launches = dict(ck.launch_counts)
    fields = dict(tk.field_counts)
    plain = plain_calls()
    coll = dict(PST.counts)
    steps = range(2, 2 + N_STEPS)
    n_sw = sum(1 for s in steps if s % 3 == 0)
    n_forc = sum(1 for s in steps if s % T30L8.nsteps == 0)
    want = dict.fromkeys(ck.launch_counts, 0)
    want.update(grid_dynamics=N_STEPS, spectral_update=N_STEPS,
                grid_physics_sw=n_sw, grid_physics_nosw=N_STEPS - n_sw)
    groups = N_STEPS + 2 * n_forc
    if (launches != want or any(fields.values()) or any(plain.values())
            or coll["direct_calls"] != groups
            or coll["all_reduce"] != groups
            or coll["inverse_calls"] != 2 * N_STEPS):
        raise RuntimeError(
            f"mesh 2x2, rank {rank}: launches {launches}, expected {want}; "
            f"fused transform fields {fields}; plain calls {plain}; band "
            f"transform counts {coll}, expected {groups} direct groups with "
            f"one all_reduce each and {2 * N_STEPS} inverse groups with none")
    if not PMESH.replicas_agree(mesh, local, PROGNOSTICS):
        raise RuntimeError("mesh 2x2: the bands of a row hold different "
                           "spectral states")
    whole = PMESH.gather_state(mesh, local, names=MD_FIELDS + ("error_flag",))
    if bool(whole["error_flag"].any()):
        raise RuntimeError("mesh 2x2: error_flag set")
    PST.reset_counts()
    _, _, warm = run_window(run, local, cal_day, 2 + N_STEPS, N_STEPS)
    warm_coll = dict(PST.counts)
    # One all_reduce of a step's bytes, alone, between synchronizations.
    step_bytes = warm_coll["all_reduce_bytes"] // N_STEPS
    buf = torch.zeros(step_bytes // 4, dtype=torch.float32, device=dev)
    group = mesh.get_group("space")
    times = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=group)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - t0))
    res["2x2"] = {"launches": launches, "collectives": coll,
                  "first_window_s": secs,
                  "ms_per_step": 1e3 * warm / N_STEPS,
                  "all_reduce_per_step": warm_coll["all_reduce"] / N_STEPS,
                  "all_reduce_bytes_per_step": step_bytes,
                  "all_reduce_ms_per_step": statistics.median(times),
                  "members": N_MEMBERS // 2, "il": consts.sp.il // 2}
    if rank == 0:
        diffs, shares, ok = f32_agreement(whole, ref["day"])
        res["2x2"]["diffs"], res["2x2"]["shares"] = diffs, shares
        if not ok:
            raise RuntimeError(f"mesh 2x2 float32 day differs from the "
                               f"unsharded day: largest {diffs}, shares "
                               f"over {MD_F32_LIMIT:g} {shares}")
    del local, whole, buf

    # 2x2 in float64, 6 steps, against the unsharded float64 run.
    consts64, s64, cal64 = make_demo_model(T30L8, device=dev,
                                           fft_mode="matmul")
    run64 = make_run_steps_batched(consts64, device=dev, mesh=mesh)
    local = PDIST.make_global_ensemble(s64, N_MEMBERS_MD64, mesh)
    local, _, _ = run_window(run64, local, cal64, 2, N_STEPS_MD64)
    whole = PMESH.gather_state(mesh, local, names=MD_FIELDS)
    if rank == 0:
        diffs = _field_diffs(whole, ref["f64"])
        res["2x2_f64"] = {"diffs": diffs}
        if not max(diffs.values()) <= MD_F64_LIMIT:
            raise RuntimeError(f"mesh 2x2 float64 run differs from the "
                               f"unsharded run: {diffs}")
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))


def multidevice_phase(card: str, state1, day, main_launches) -> dict:
    """The multi-device phase: rows 1 and 2 against their plain versions at
    the band shapes (24 latitudes, the 2x2 mesh's 64 members a rank; 12, a
    1x4 mesh's 128), then four ranks (gloo on one shared card, nccl with a
    card each) through multidevice_rank, held to the main path's day (`day`,
    from `state1`) and its launches."""
    f32 = dataclasses.replace(T30L8, precision="f32", fft_mode="matmul")
    f64 = dataclasses.replace(T30L8, fft_mode="matmul")
    bands = {"il24": {}, "il12": {}}
    bands["il24"]["grid_dynamics"] = check_kernel(f32, N_MEMBERS // 2, 1e-5,
                                                  card, n_space=2)
    check_kernel(f64, N_MEMBERS // 2, 1e-12, card, n_space=2)
    bands["il12"]["grid_dynamics"] = check_kernel(f32, N_MEMBERS, 1e-5, card,
                                                  n_space=4)
    bands["il24"].update(check_physics(f32, N_MEMBERS // 2, 1e-5, card,
                                       ("grid_phi",), timed=True, n_space=2))
    check_physics(f64, N_MEMBERS // 2, 1e-12, card, ("grid_phi",),
                  n_space=2)
    bands["il12"].update(check_physics(f32, N_MEMBERS, 1e-5, card,
                                       ("grid_phi",), timed=True, n_space=4))

    # The unsharded float64 reference, then the ranks.
    consts64, s64, cal64 = make_demo_model(T30L8, device="cuda",
                                           fft_mode="matmul")
    out64, _, _ = run_window(make_run_steps_batched(consts64, device="cuda"),
                             broadcast_state(s64, N_MEMBERS_MD64), cal64, 2,
                             N_STEPS_MD64)
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MD_WORLD else "gloo"
    sharing = (f"{MD_WORLD} ranks on one card over gloo" if n_cards == 1 else
               f"{MD_WORLD} ranks on {min(n_cards, MD_WORLD)} cards over "
               f"{backend}")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"state1": _cpu_fields(state1, PROGNOSTICS), "day": day,
                    "f64": _cpu_fields(out64, MD_FIELDS)},
                   Path(tmp) / "ref.pt")
        del out64
        t0 = time.perf_counter()
        codes = run_workers(multidevice_rank, MD_WORLD,
                            (MD_WORLD, f"tcp://127.0.0.1:{free_port()}",
                             backend, tmp), timeout_s=600)
        wall = time.perf_counter() - t0
        if codes != [0] * MD_WORLD:
            raise RuntimeError(f"multi-device phase: rank exit codes {codes}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(MD_WORLD)]
    for r in ranks:
        if r["4x1"]["launches"] != main_launches:
            raise RuntimeError(f"mesh 4x1 rank {r['rank']}: launches "
                               f"{r['4x1']['launches']}, the main path's "
                               f"{main_launches}")
    r0 = ranks[0]
    print(f"multi-device: {sharing} ({wall:.1f} s for the ranks, spawn "
          f"included), the runner's eager loop on every rank (a mesh keeps "
          f"it: the band route's all_reduce is not captured); default group "
          f"{r0['backend']}, sub-groups "
          + "; ".join(f"{k} {v}" for k, v in r0["group_backends"].items()))
    bit = r0["4x1"]["bitwise"]
    print(f"mesh 4x1 (ensemble only): T30L8 f32 with physics, {N_MEMBERS} "
          f"members ({N_MEMBERS // 4} a rank) x {N_STEPS} steps + "
          f"initialization, each rank's launches equal the main path's in "
          f"the eager loop {main_launches}; the gathered day "
          + ("bitwise equal to" if bit else "NOT bitwise equal to")
          + f" the main path's unsharded day (initial state bitwise: "
          f"{r0['4x1']['initial_state_bitwise']}); largest rel. difference "
          "by field " + ", ".join(f"{k} {v:.3e}" for k, v in
                                 r0["4x1"]["diffs"].items()))
    if not bit:
        print(f"  mesh 4x1: shares of the physics diagnostics over "
              f"{MD_F32_LIMIT:g}: {r0['4x1']['shares']} (a ROADMAP Queue 3 "
              f"finding)")
        if not r0["4x1"]["within_f32_limits"]:
            raise RuntimeError("mesh 4x1 differs from the unsharded day "
                               "beyond the float32 limits")
    c = r0["2x2"]["collectives"]
    print(f"mesh 2x2 (bands of {r0['2x2']['il']} latitudes, "
          f"{r0['2x2']['members']} members a rank): per rank launches "
          f"{r0['2x2']['launches']} (rows 1, 2 and 6 once a step, no fused "
          f"transform, no plain chain), band transforms {c} (one all_reduce "
          f"per direct group, none for the {c['inverse_calls']} inverse "
          f"groups); the bands of a row hold the same spectral state, "
          f"bitwise; f32 day vs unsharded, largest rel. difference by field "
          + ", ".join(f"{k} {v:.3e}" for k, v in r0["2x2"]["diffs"].items())
          + f" (limit {MD_F32_LIMIT:g} on {', '.join(MD_STATE_FIELDS)}); "
          f"share of values over it "
          + ", ".join(f"{k} {v:.2e}" for k, v in r0["2x2"]["shares"].items())
          + f" (limit {MD_DIAG_SHARE:g}); f64 {N_STEPS_MD64} steps of "
          f"{N_MEMBERS_MD64} members vs the unsharded f64 run on the card "
          + ", ".join(f"{k} {v:.3e}" for k, v in
                      r0["2x2_f64"]["diffs"].items())
          + f" (limit {MD_F64_LIMIT:g})")
    for mesh in ("4x1", "2x2"):
        print(f"mesh {mesh} timings, {sharing}: ms/step by rank (a warm "
              f"{N_STEPS}-step window) "
              + ", ".join(f"{r[mesh]['ms_per_step']:.2f}" for r in ranks)
              + (f"; all_reduce {r0['2x2']['all_reduce_per_step']:.3f} a "
                 f"step, {r0['2x2']['all_reduce_bytes_per_step'] / 1e6:.2f} "
                 f"MB a step, one all_reduce of a step's bytes alone "
                 f"{r0['2x2']['all_reduce_ms_per_step']:.2f} ms (rank 0)"
                 if mesh == "2x2" else "")
              + f" [{card}]")
    return {"bands": bands, "ranks": ranks, "sharing": sharing,
            "backend": backend}


def climatology_phase(card: str) -> dict:
    """The climatology check on the card through the port's own script
    (pyspeedy_tpu_torch/validate_climatology.py): T30 f32 through Speedy,
    one 30-day month of spin-up and one used. Its three checks must pass,
    through the kernels, with no plain version called."""
    import contextlib
    import io
    from pyspeedy_tpu_torch import validate_climatology as VC
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = VC.main(CLIMATE_ARGS)
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    report = json.loads(text[text.index("\n{") + 1:])
    launches = dict(ck.launch_counts)
    plain = plain_calls()
    print(f"climatology phase: python -m pyspeedy_tpu_torch."
          f"validate_climatology {' '.join(CLIMATE_ARGS)} in {secs:.1f} s "
          f"[{card}]:")
    for line in text.strip().splitlines():
        print("  " + line)
    if (rc != 0 or not report["ok"] or any(plain.values())
            or not all(launches[k] > 0 for k in (
                "grid_dynamics", "grid_physics_sw", "grid_physics_nosw",
                "fused_grid2spec", "fused_spec2grid", "spectral_update"))):
        raise RuntimeError(f"climatology phase: exit code {rc}, report "
                           f"{report}, launches {launches}, plain calls "
                           f"{plain}")
    return {"report": report, "seconds": secs}


TRACE_KERNELS = ("grid_dynamics_kernel", "grid_physics_kernel",
                 "spectral_update_kernel", "grid2spec_fold_kernel",
                 "spec2grid_fold_kernel")


def trace_phase(run, state, cal, first_step: int) -> dict:
    """utils.profiling.trace around a 3-step window of the main path: the
    trace file exists and names every kernel of the step. The tracer can
    lose every record for a while (see kernel_device_ms): a trace that
    misses a kernel is taken again a second later, three at most."""
    from pyspeedy_tpu_torch.utils.profiling import (SPANS_FILE, TRACE_FILE,
                                                    reset_spans, trace)
    for attempt in range(3):
        with tempfile.TemporaryDirectory() as log_dir:
            ctx, _ = M.build_step_ctx(dataclasses.replace(cal), first_step, 3)
            reset_spans()
            with trace(log_dir):
                run(state, ctx)
            path = Path(log_dir) / TRACE_FILE
            size = path.stat().st_size
            text = path.read_text()
            spans = json.loads((Path(log_dir) / SPANS_FILE).read_text())
        if spans["steps"] != 3 or spans["spans"]["step"]["count"] != 3:
            raise RuntimeError(f"profiling: {SPANS_FILE} counts "
                               f"{spans['steps']} steps, not 3")
        counts = {k: text.count(k) for k in TRACE_KERNELS}
        if all(counts.values()):
            print(f"profiling: trace() of a 3-step window of the main path "
                  f"wrote {TRACE_FILE} ({size / 1e6:.1f} MB); mentions of "
                  + ", ".join(f"{k} {n}" for k, n in counts.items()))
            return {"bytes": size, "mentions": counts}
        print(f"  (trace {attempt + 1} misses a kernel: {counts})")
        time.sleep(1.0)
    raise RuntimeError(f"profiling: the trace does not name every kernel of "
                       f"the step: {counts}")


class Phases:
    """Consecutive phases of this script on a PhaseTimer: start() ends the
    phase before it."""

    def __init__(self, timer):
        self.timer, self.current = timer, None

    def start(self, name):
        self.stop()
        self.current = self.timer.phase(name)
        self.current.__enter__()

    def stop(self):
        if self.current is not None:
            self.current.__exit__(None, None, None)
            self.current = None



def main() -> None:
    t_start = time.perf_counter()
    timer = PhaseTimer()
    phases = Phases(timer)
    # 1. device
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([ck.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"device: {card}; python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}, "
          f"nvcc {nvcc.strip().splitlines()[-2].strip()}")

    # Matrix products of the plain versions in full precision: no TF32, no
    # reduced-precision sums of bfloat16 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"matmul flags: allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    phases.start("build")
    # 2. build: one nvcc process per source, started together
    t0 = time.perf_counter()
    libs = ck.build_kernels()
    print(f"build: {len(libs)} kernel libraries with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs.values()))
    for row in build_report():
        print("  " + row)
    print("occupancy of the two column-parallel kernels, the DFT chain and "
          "the probes (CUDA runtime):")
    occupancy = occupancy_report(libs)
    for name, (blocks, threads, smem, regs, local) in occupancy.items():
        print(f"  {name}: {regs} registers, {local} B local memory, "
              f"{threads} threads and {smem / 1024:.1f} KB shared memory a "
              f"block, {blocks} blocks = {blocks * threads // 32} warps per SM")
    for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        blocks, threads, smem, regs, local = dft_chain_occupancy(
            libs["dft_chain"], dtype)
        print(f"  dft_chain_fold_kernel<{'float' if prec == 'f32' else 'double'}>"
              f": {regs} registers, {local} B local memory, {threads} threads "
              f"and {smem / 1024:.1f} KB shared memory a block, {blocks} "
              f"blocks = {blocks * threads // 32} warps per SM")
        for stage, (blocks, threads, smem, regs, local) in probe_occupancy(
                libs["fused_transform"], prec).items():
            print(f"  probe p{stage} {PROBE_KERNELS[stage]} {prec}: {regs} "
                  f"registers, {local} B local memory, {threads} threads and "
                  f"{smem / 1024:.1f} KB shared memory a block, {blocks} "
                  f"blocks = {blocks * threads // 32} warps per SM")
    print("SASS of the two column-parallel kernels, of row 5 and of rows 3 "
          "and 7 (cuobjdump): conversions between float and double, all F2F, "
          "instructions")
    for row in sass_report([libs["grid_physics"], libs["spectral_update"],
                            libs["dft_chain"], libs["fused_transform"]],
                           ("grid_physics_kernel", "spectral_update_kernel",
                            "dft_chain_fold_kernel", "grid2spec_fold_kernel",
                            "split_probe_kernel")):
        print("  " + row)
    f2f = {k: v[0] for lib in (libs["grid_physics"], libs["spectral_update"])
           for k, v in sass_counts(lib).items()}
    f2f_float = lambda base: sum(
        v for k, v in f2f.items() if base + "If" in k)

    phases.start("kernels against their plain versions")
    # 3. grid-dynamics kernel vs plain at the main path's shapes
    f32 = dataclasses.replace(T30L8, precision="f32", fft_mode="matmul")
    f64 = dataclasses.replace(T30L8, fft_mode="matmul")
    res32 = check_kernel(f32, N_MEMBERS, 1e-5, card)
    check_kernel(T30L8, N_MEMBERS, 1e-12, card)
    check_kernel(T30L5, N_MEMBERS, 1e-12, card)

    # 4. physics kernel vs plain on seeded random columns: float32 and
    # float64, both shortwave variants, geopotential read and integrated in
    # the kernel, an SPPT pattern, the coupled-sea second evaluation, T30L5.
    phys32 = check_physics(f32, N_MEMBERS, 1e-5, card,
                           ("phig", "sppt", "grid_phi"), timed=True)
    phys64 = check_physics(f64, N_MEMBERS, 1e-12, card,
                           ("phig", "sppt", "grid_phi"), timed=True)
    check_physics(f32, N_MEMBERS, 1e-5, card, ("grid_phi",), sea=1)
    check_physics(f64, N_MEMBERS, 1e-12, card, ("phig",), sea=1)
    check_physics(dataclasses.replace(T30L5, fft_mode="matmul"), N_MEMBERS,
                  1e-12, card, ("phig", "grid_phi"))

    # 4b. the fused transform kernels vs their plain versions (the dense
    # matmul chain): float32, float64, the 2-byte operand mode, the probe
    # stages; and the bfloat16-output instantiations of both column kernels.
    tr32 = check_transforms(f32, 1e-5, card)
    tr64 = check_transforms(f64, 1e-12, card)
    tr_bf16 = check_bf16_operands(f32, card)
    tr_bf16_64 = check_bf16_operands(f64, card)
    probes32 = check_probes(
        f32, 1e-5, card, libs,
        tr32["fused_grid2spec"]["groups"]["direct"]["ms"])
    probes64 = check_probes(
        f64, 1e-12, card, libs,
        tr64["fused_grid2spec"]["groups"]["direct"]["ms"])
    bf16_out = check_bf16_outputs(f32, card)
    bf16_out64 = check_bf16_outputs(f64, card)

    # 4c. the spectral-update kernel vs plain (the three time steps of the
    # start-up sequence, dense and stride-0 member axes; float32, float64,
    # T30L5) and the DFT chain at the JAX tool's shapes.
    glue32 = check_spectral_update(f32, 1e-5, card)
    glue64 = check_spectral_update(f64, 1e-12, card)
    check_spectral_update(dataclasses.replace(T30L5, fft_mode="matmul"),
                          1e-12, card)
    dft32 = check_dft_chain(torch.float32, 1e-5, card, libs)
    dft64 = check_dft_chain(torch.float64, 1e-12, card, libs)

    phases.start("dynamics-only path")
    # 5. the dynamics-only path, at a reduced depth: initialization (two
    # bootstrap steps at B=1), then 12 steps of 128 members through the
    # runner's CUDA graphs (the wrappers are called by each step kind's
    # warm-up and captures; the replays launch the same kernels).
    reset_counts()
    consts_d, state_d, cal_d = make_demo_model(
        T30L8, device="cuda", physics_on=False, precision="f32",
        fft_mode="matmul")
    run_d = make_run_steps_batched(consts_d, device="cuda")
    out_d, _, _ = run_window(run_d, broadcast_state(state_d, N_MEMBERS),
                             cal_d, 2, N_STEPS_DYN)
    launches_dyn = read_path_counts("dynamics-only path", consts_d, 2,
                                    N_STEPS_DYN, graph_evals(2, N_STEPS_DYN))
    fields_dyn = dict(tk.field_counts)
    check_state(out_d, N_MEMBERS, "dynamics-only path")
    prof_d = device_time_per_step(run_d, out_d, cal_d, 2 + N_STEPS_DYN,
                                  N_STEPS_DYN, consts_d)
    print(f"dynamics-only path: T30L8 f32, {N_MEMBERS} members x "
          f"{N_STEPS_DYN} steps + initialization through the CUDA graphs, "
          f"finite, error_flag false, launches {launches_dyn} (the "
          f"initialization and each step kind's warm-up and captures), "
          f"transform fields {fields_dyn}, none of the physics, of the plain "
          f"chain or of the plain spectral update; a {N_STEPS_DYN}-step "
          f"graph window launches on the card {prof_d['kernels']} (one "
          f"grid_dynamics and one spectral_update a step); unperturbed "
          f"members differ from member 0 by {member_spread(out_d):.1e}")
    del out_d

    phases.start("main path")
    # 6. the main path at full width: the full-physics model (grid_phi on,
    # the default on the card). Initialization runs both bootstrap steps
    # with shortwave at B=1 (eager: its wrapper counts are its launches);
    # then one model day of 128 members from step 2, shortwave on steps 3,
    # 6, ..., 36, the daily forcing at step 36, through a fresh runner's
    # CUDA graphs, as a user's first run call takes them, under the
    # profiler: the kernels' launches on the card are its records (the
    # wrappers count only the initialization and each step kind's warm-up
    # and capture); the day is held below to the eager loop's, bitwise.
    reset_counts()
    consts, state1, cal = make_demo_model(T30L8, device="cuda",
                                          precision="f32", fft_mode="matmul")
    init_launches = read_path_counts("main path, initialization", consts, 2,
                                     0, [])
    init_fields = dict(tk.field_counts)
    state0 = broadcast_state(state1, N_MEMBERS)
    (run, state, cal_day, secs_first, day_records, wrapper_calls,
     day_fields) = profiled_graph_day(consts, state0, cal, N_STEPS)
    captured = {"captures": 0, "capture_s": 0.0, "pool_bytes": 0,
                "buffer_bytes": 0}
    launches = {k: init_launches[k] + day_records[k] for k in init_launches}
    if launches != expected_path_launches(consts, 2, N_STEPS)[0]:
        raise RuntimeError(f"main path: launches {launches}")
    fields_main = {k: init_fields[k] + day_fields[k] for k in init_fields}
    day_ref = _cpu_fields(state, MD_FIELDS)
    main_plain = plain_calls()
    check_state(state, N_MEMBERS, "main path")
    if not (consts.physics_on and consts.grid_phi):
        raise RuntimeError("the card's defaults are physics and grid_phi on")
    spread = member_spread(state)
    if not spread <= 1e-6:
        raise RuntimeError(f"unperturbed members differ: {spread:.3e}")
    for name in M.EPHEMERAL_FIELDS | set(PD.CACHE_FIELDS):
        x = state[name]
        if x.shape[0] != N_MEMBERS or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"main path: {name} not member-batched or "
                               f"not finite")
    print(f"main path: T30L8 f32 with physics, {N_MEMBERS} members x "
          f"{N_STEPS} steps + initialization through the CUDA graphs, "
          f"finite, error_flag false, launches {launches} (the "
          f"initialization's wrapper counts {init_launches} and the graph "
          f"day's device records, every step's: {day_records}); the graph "
          f"day's wrapper calls {wrapper_calls} (steps 2, 3, 5 and 6 three "
          f"times: the warm-up, the capture and the traced twin's capture of "
          f"each graph key, the shortwave "
          f"kind by the pair buffers' parity), transform fields "
          f"{fields_main}, plain chain and plain spectral update calls "
          f"{main_plain}; unperturbed members differ from member 0 by "
          f"{spread:.1e}; first graph day {secs_first:.3f} s under the "
          f"profiler")
    main_graphs = graphs_phase("T30 B=128", consts, run, state0, cal,
                               N_STEPS, state, cal_day, captured, card)
    # What a graph step still copies into the buffers: the fields named in
    # coupling/coupler.py::STEP_COPIES, and the daily forcing's fields on a
    # step that starts a day; every kernel's output, the slab models' fields
    # and the coupler's planes are written in place.
    copied = main_graphs["copies"]
    count = copied["count"]
    ctx_prof, _ = M.build_step_ctx(dataclasses.replace(main_graphs["cal"]),
                                   main_graphs["first"], count["steps"])
    want = (len(STEP_COPIES) * count["steps"]
            + int(sum(ctx_prof["do_forcing"])) * len(FORCING_FIELDS))
    if (set(copied["copied"]["step"]) != STEP_COPIES
            or set(copied["copied"]["forcing"]) - FORCING_FIELDS
            or count["step"] + count["forcing"] != want):
        raise RuntimeError(
            f"main path: the graph steps copy {copied} into their buffers, "
            f"not the {want} copies of STEP_COPIES each step and the daily "
            f"forcing's fields each day")
    launches_eager_day = main_graphs["eager_launches"]
    direct, inverse = expected_transforms(consts, N_STEPS, 1, False)
    print(f"main path, eager day: launches {launches_eager_day} "
          f"(grid_dynamics = spectral_update = {N_STEPS} steps; physics 12 "
          f"with shortwave + 24 without; fused_spec2grid = {N_STEPS} "
          f"evaluations x 2 groups, {inverse[1]} fields; fused_grid2spec = "
          f"{N_STEPS} x 1 group + 2 of the forcing, {direct[1]} fields)")
    del state0

    # The physics kernel once more, on the model's own columns after that
    # day (float32, both variants, the main path's grid_phi mode and an SPPT
    # pattern).
    state_in = state_physics_inputs(consts, state)
    phys_state = check_physics(f32, N_MEMBERS, 1e-5, card, ("grid_phi",),
                               inputs=state_in, timed=True)
    check_physics(f32, N_MEMBERS, 1e-5, card, ("sppt",), inputs=state_in)
    # The spectral-update kernel on the model's own state after that day,
    # and the step's transform groups as its call sites build them there.
    glue_state = check_spectral_update_on_state(consts, state, 1e-5)
    sites_err, _ = check_call_site_groups(consts, state, 1e-5)

    # Member independence through the kernels and the coupler: one member's
    # initial temperature perturbed, only that member may differ.
    pert, who = broadcast_state(state1, 8), 5
    noise = torch.zeros_like(pert["t"][0])
    noise[who, 0, :, 1:6, 1:6] = 0.05
    pert["t"] = (pert["t"][0] + noise, pert["t"][1] + noise)
    out_p, _, _ = run_window(run, pert, cal, 2, 6)
    check_state(out_p, 8, "perturbed run")
    t_out = out_p["t"][0]
    others = [m for m in range(8) if m != who]
    same = float((t_out[others] - t_out[:1]).abs().max())
    diff = float((t_out[who] - t_out[0]).abs().max())
    hf = out_p["hfluxn"]
    same_flux = float((hf[others] - hf[:1]).abs().max())
    if same != 0.0 or same_flux != 0.0 or not diff > 1e-3:
        raise RuntimeError(
            f"member independence: unperturbed members differ by {same:.3e} "
            f"(hfluxn {same_flux:.3e}), the perturbed one by {diff:.3e}")
    print(f"member independence (CUDA graphs): B=8, member {who} perturbed "
          f"by 0.05 in T, 6 steps: it differs by {diff:.3e} K (spectral), "
          f"all others equal member 0 bitwise (T and hfluxn)")

    # Throughput: the graphs phase's windows, everything warm, and B=1.
    state, cal_day2 = main_graphs.pop("state"), main_graphs.pop("cal")
    first_main = main_graphs.pop("first")
    s1_0 = broadcast_state(state1, 1)
    captured = dict(run.graphs.stats)
    s1, cal1, _ = run_window(run, s1_0, cal, 2, N_STEPS)
    b1_graphs = graphs_phase("T30 B=1", consts, run, s1_0, cal, N_STEPS, s1,
                             cal1, captured, card)
    b1_graphs.pop("state")
    check_state(s1, 1, "B=1")
    g128, g1 = main_graphs["profile"]["graph"], b1_graphs["profile"]["graph"]
    secs = min(main_graphs["ms_per_step"]["graph"]) * N_STEPS / 1e3
    secs1 = min(b1_graphs["ms_per_step"]["graph"]) * N_STEPS / 1e3
    print(f"throughput, full physics, the runner's CUDA graphs: "
          f"{report(N_MEMBERS, N_STEPS, secs, g128['busy_ms'])}; "
          f"{report(1, N_STEPS, secs1, g1['busy_ms'])}; device launches per "
          f"step {g128['launches']:.2f} (a {N_STEPS_PROFILED}-step window), "
          f"the step's kernels in it {g128['kernels']} [{card}]")
    print(f"device time by kernel, B={N_MEMBERS}, graphs, ms/step "
          f"(launches/step): " + "; ".join(
              f"{name} {ms:.3f} ({n:.2f})"
              for name, ms, n in main_graphs["top"]["graph"]))
    print(f"device time by group, B={N_MEMBERS}, graphs, ms/step: "
          + "; ".join(f"{k} {v:.3f}" for k, v in g128["groups"].items()))
    # The dynamics-only path beside it, warm, same depth as its first run.
    state_dd = broadcast_state(state_d, N_MEMBERS)
    state_dd, cal_dd, _ = run_window(run_d, state_dd, cal_d, 2, N_STEPS_DYN)
    _, _, secs_dd = run_window(run_d, state_dd, cal_dd, 2 + N_STEPS_DYN,
                               N_STEPS_DYN)
    print(f"throughput, dynamics only, the runner's CUDA graphs: "
          f"{report(N_MEMBERS, N_STEPS_DYN, secs_dd, None)}")
    del state_dd

    phases.start("multi-device phase")
    # 6a. the ("ensemble", "space") mesh: rows 1 and 2 at the band shapes,
    # then four ranks (their own process each) on the 4x1 and 2x2 meshes,
    # held to the main path's day. A mesh keeps the runner's eager loop: its
    # launches are every step's.
    md = multidevice_phase(card, state1, day_ref,
                           expected_path_launches(consts, 2, N_STEPS)[0])
    del day_ref

    phases.start("bf16_tendencies path")
    # 6b. the bf16_tendencies configuration at a reduced depth: the
    # initialization strips the flag (float32 instantiations, two bootstrap
    # steps), the runner keeps it (bfloat16 instantiations on every step).
    reset_counts()
    consts_b, state_b1, cal_b = make_demo_model(
        T30L8, device="cuda", precision="f32", fft_mode="matmul",
        bf16_tendencies=True)
    run_b = make_run_steps_batched(consts_b, device="cuda")
    state_b0 = broadcast_state(state_b1, N_MEMBERS)
    captured = dict(run_b.graphs.stats)
    out_b, cal_b2, _ = run_window(run_b, state_b0, cal_b, 2, N_STEPS_BF16)
    launches_b = read_path_counts("bf16_tendencies path", consts_b, 2,
                                  N_STEPS_BF16, graph_evals(2, N_STEPS_BF16))
    fields_b = dict(tk.field_counts)
    plain_b = plain_calls()
    check_state(out_b, N_MEMBERS, "bf16_tendencies path")
    bf16_graphs = graphs_phase("bf16_tendencies path", consts_b, run_b,
                               state_b0, cal_b, N_STEPS_BF16, out_b, cal_b2,
                               captured, card)
    bf16_graphs.pop("state")
    del state_b0
    if not consts_b.bf16_tendencies:
        raise RuntimeError("make_demo_model dropped bf16_tendencies")
    for name in PROGNOSTICS:
        if not all(torch.equal(a, b) for a, b in zip(state_b1[name],
                                                     state1[name])):
            raise RuntimeError(f"bf16_tendencies changed the initial {name}")
    out_f, cal_f2, _ = run_window(run, broadcast_state(state1, N_MEMBERS),
                                  cal, 2, N_STEPS_BF16)
    moved, rels = 0.0, {}
    for name, bound in (("t", 1e-3), ("ps", 1e-3), ("vor", 5e-2),
                        ("div", 5e-2)):
        a, b = out_f[name][0], out_b[name][0]
        if b.dtype != torch.float32:
            raise RuntimeError(f"{name} left float32 with bf16_tendencies")
        rels[name] = float((a - b).abs().max() / a.abs().max())
        moved = max(moved, rels[name])
        if not rels[name] < bound:
            raise RuntimeError(
                f"bf16_tendencies: {name} differs from the float32 run by "
                f"{rels[name]:.3e} (bound {bound:g})")
    if not moved > 1e-8:
        raise RuntimeError("bf16_tendencies had no effect: a dead flag")
    # Throughput of both, warm, in turns within this one run.
    secs_bf, secs_ff = [], []
    for _ in range(2):
        out_b, cal_b2, sb = run_window(run_b, out_b, cal_b2,
                                       2 + N_STEPS_BF16, N_STEPS_BF16)
        out_f, cal_f2, sf = run_window(run, out_f, cal_f2, 2 + N_STEPS_BF16,
                                       N_STEPS_BF16)
        secs_bf.append(sb)
        secs_ff.append(sf)
    prof_b = bf16_graphs["profile"]["graph"]
    dev_ms_b, launches_per_step_b = prof_b["busy_ms"], prof_b["launches"]
    groups_b = prof_b["groups"]
    check_state(out_b, N_MEMBERS, "bf16_tendencies path, warm")
    rate = lambda secs: N_MEMBERS * N_STEPS_BF16 / secs
    print(f"bf16_tendencies path: T30L8 f32, {N_MEMBERS} members x "
          f"{N_STEPS_BF16} steps + initialization through the CUDA graphs, "
          f"finite, error_flag false, launches {launches_b} (the bfloat16 "
          f"instantiations on each step kind's warm-up and captures, the "
          f"float32 ones on the two bootstrap steps; the spectral update, "
          f"float32 on every step, {launches_b['spectral_update']}; the "
          f"eager day's {bf16_graphs['eager_launches']}), transform fields "
          f"{fields_b}, "
          f"plain chain and plain spectral "
          f"update calls {plain_b}; same initial state bitwise; "
          f"prognostics vs the float32 run after {N_STEPS_BF16} steps, rel. "
          f"to each field's largest value: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + " (bounds t, ps 1e-3; vor, div 5e-2; and more than 1e-8)")
    print(f"throughput, bf16_tendencies beside float32, {N_STEPS_BF16}-step "
          f"windows in turns, the runner's CUDA graphs: bf16 "
          + ", ".join(f"{rate(x):.1f}" for x in secs_bf)
          + " member-steps/s; float32 "
          + ", ".join(f"{rate(x):.1f}" for x in secs_ff)
          + f" member-steps/s; bf16 device busy {dev_ms_b:.3f} ms/step, "
          f"{launches_per_step_b:.0f} launches per step; by group "
          + "; ".join(f"{k} {v:.3f}" for k, v in groups_b.items())
          + f" [{card}]")
    del out_b, out_f

    phases.start("probe and DFT-chain paths")
    # 6c. the probe stages through their entry point, on the model's own
    # temperature after a day (B*kx rows): each stage finite and of its
    # shape, p1 the same values as p0, p2 the real part of the whole direct
    # transform of the same field, p3 twice the field's leading il*mx values.
    tg = S.spec2grid_p(consts.sp, state["t"][0], 1, 1)
    tg_rows = tg.reshape(-1, consts.sp.il, consts.sp.ix)
    ck.reset_launch_counts()
    p0, p1, p2, p3 = (tk.fused_probe(stage, consts.sp, tg_rows)
                      for stage in tk.PROBE_STAGES)
    launches_probe = dict(ck.launch_counts)
    whole = S.grid2spec_p(consts.sp, tg_rows, 0)[0]
    n_rows, sp_ = tg_rows.shape[0], consts.sp
    probe_ok = (
        torch.equal(p0.reshape(p1.shape), p1)
        and _rel(p2.reshape(whole.shape), whole) <= 1e-5
        and torch.equal(p3, 2.0 * tg_rows.reshape(n_rows, -1)[
            :, :sp_.il * sp_.mx].reshape(p3.shape))
        and all(bool(torch.isfinite(x).all()) for x in (p0, p1, p2, p3)))
    if not probe_ok or launches_probe["fused_probe"] != len(tk.PROBE_STAGES):
        raise RuntimeError(f"probe path: stages inconsistent or launches "
                           f"{launches_probe}")
    print(f"probe path: fused_probe stages p0..p3 on the model's temperature "
          f"({n_rows} rows): consistent with each other and with "
          f"grid2spec_p, launches {launches_probe['fused_probe']}")

    # 6d. the DFT-chain path: the row-5 kernel through its entry point on the
    # card, once, at the JAX tool's shapes.
    ck.reset_launch_counts()
    DC.reset_plain_calls()
    tabs, fre, fim = dft_chain_inputs(torch.float32, seed=41)
    ore, oim = DC.dft_chain(tabs, fre, fim)
    launches_dft = dict(ck.launch_counts)
    plain_dft = dict(DC.plain_calls)
    expected_dft = dict.fromkeys(ck.launch_counts, 0)
    expected_dft["dft_chain"] = 1
    again = DC.dft_chain_cuda(tabs, fre, fim)
    dft_ok = (ore.shape == fre.shape and oim.shape == fim.shape
              and bool(torch.isfinite(ore).all())
              and bool(torch.isfinite(oim).all())
              and torch.equal(ore, again[0]) and torch.equal(oim, again[1]))
    if launches_dft != expected_dft or any(plain_dft.values()) or not dft_ok:
        raise RuntimeError(f"DFT-chain path: launches {launches_dft}, plain "
                           f"calls {plain_dft}, outputs consistent {dft_ok}")
    print(f"DFT-chain path: dft_chain on {N_DFT_MEMBERS} members of "
          f"{DC.NFIELDS} fields x {DC.KX} levels, f32: finite, of the input's "
          f"shape, the same bits on a second launch; launches "
          f"{launches_dft['dft_chain']}, plain calls {plain_dft['dft_chain']}")
    del tabs, fre, fim, ore, oim, again

    phases.start("SPPT path")
    # 6e. the SPPT path at full width: the full-physics model with SPPT
    # (T30L8 f32, grid_phi on); initialization (the stationary spectrum and
    # both bootstrap steps with their own one-step draws, B=1), then one
    # model day of 128 members from one broadcast state (each member its own
    # key): the noise of the 36 steps drawn in one pass, each step's AR(1)
    # update, the pattern in the physics' transform group, the multiply in
    # the physics kernel.
    reset_counts()
    p_sppt = dataclasses.replace(f32, sppt_on=True)
    consts_s, state_s1, cal_s = make_demo_model(p_sppt, device="cuda")
    run_s = make_run_steps_batched(consts_s, device="cuda")
    state_s0 = broadcast_state(state_s1, N_MEMBERS)
    captured = dict(run_s.graphs.stats)
    state_s, cal_s1, secs_s = run_window(run_s, state_s0, cal_s, 2, N_STEPS)
    launches_s = read_path_counts("SPPT path", consts_s, 2, N_STEPS,
                                  graph_evals(2, N_STEPS))
    fields_s = dict(tk.field_counts)
    plain_s = plain_calls()
    check_state(state_s, N_MEMBERS, "SPPT path")
    direct_s, inverse_s = expected_transforms(consts_s, N_STEPS, 1, False)
    if inverse_s[1] != inverse[1] + N_STEPS:
        raise RuntimeError("the SPPT path's physics group is not one field "
                           "wider than the main path's")
    t_s = state_s["t"][0]
    spread_s = float((t_s - t_s[:1]).abs().max() / t_s.abs().max())
    if not spread_s > 1e-6:
        raise RuntimeError(f"SPPT members did not diverge: {spread_s:.3e}")
    keys_s = state_s["sppt_key"]
    if len({tuple(k) for k in keys_s.tolist()}) != N_MEMBERS:
        raise RuntimeError("SPPT members share a noise key")
    print(f"SPPT path: T30L8 f32 with physics and SPPT, {N_MEMBERS} members "
          f"x {N_STEPS} steps + initialization through the CUDA graphs, "
          f"finite, error_flag false, launches {launches_s} (the main "
          f"path's), transform fields {fields_s}, plain calls {plain_s}; the "
          f"eager day's inverse fields {inverse_s[1]} = the main path's "
          f"{inverse[1]} + one pattern spectrum in each of the {N_STEPS} "
          f"physics groups; members from one broadcast state differ in t by "
          f"{spread_s:.3e} (rel., more than 1e-6), {N_MEMBERS} distinct "
          f"keys; first graph day {secs_s:.3f} s")
    sppt_graphs = graphs_phase("SPPT path", consts_s, run_s, state_s0, cal_s,
                               N_STEPS, state_s, cal_s1, captured, card)
    if sppt_graphs["eager_launches"] != {
            **launches_eager_day, "sppt_noise": 1}:
        raise RuntimeError(f"SPPT path, eager day: launches "
                           f"{sppt_graphs['eager_launches']} against the main "
                           f"path's {launches_eager_day} and one noise "
                           f"launch")
    del state_s0
    # Launches and device time per step of the eager loop, a whole 36-step
    # run call of each path from warm states, in turns; the noise draw of
    # one run call alone.
    state_s, cal_s2 = sppt_graphs.pop("state"), sppt_graphs.pop("cal")
    first_s = sppt_graphs.pop("first")
    prof_main = device_time_per_step(run, state, cal_day2, first_main,
                                     N_STEPS, consts, eager=True)
    prof_s = device_time_per_step(run_s, state_s, cal_s2, first_s, N_STEPS,
                                  consts_s, eager=True)
    draw = lambda: list(SP.draw_run_noise(consts_s, state_s["sppt_key"],
                                          first_s, N_STEPS))
    before = ck.launch_counts["sppt_noise"]
    draw()
    if ck.launch_counts["sppt_noise"] != before + 1:
        raise RuntimeError("the noise of a 36-step run call at B=128 is not "
                           "one kernel launch")
    draw_records = device_launches(draw)
    draw_ms = time_ms(draw, reps=3, warmup=1, windows=3)
    sppt_extra = prof_s["launches"] - prof_main["launches"]
    print(f"SPPT path, warm, {N_STEPS}-step run calls at B={N_MEMBERS}, the "
          f"eager loop: device launches per step {prof_s['launches']:.1f} "
          f"with SPPT, {prof_main['launches']:.1f} without: SPPT adds "
          f"{sppt_extra:.1f} a step (the noise draw one kernel launch a run "
          f"call by its wrapper's count, {draw_records} device records by "
          f"the profiler's, its table's copy and the kernel, or 0 where the "
          f"profiler lost them; the rest the AR(1) update and the clip of "
          f"each step); "
          f"device busy {prof_s['busy_ms']:.3f} ms/step with SPPT, "
          f"{prof_main['busy_ms']:.3f} without; the noise draw of one run "
          f"call {draw_ms:.3f} ms; wall ms/step through the graphs "
          f"{min(sppt_graphs['ms_per_step']['graph']):.3f} with SPPT, "
          f"{min(main_graphs['ms_per_step']['graph']):.3f} without [{card}]")
    # The physics' transform group with the pattern and the physics kernel
    # fed the model's own pattern, against their plain versions, on the
    # SPPT state after a day.
    se = next(SP.draw_run_noise(consts_s, state_s["sppt_key"], 2 + N_STEPS,
                                1))
    sites_err_s, groups_s = check_call_site_groups(consts_s, state_s, 1e-5,
                                                   {"sppt_se": se})
    _, phys_fields, phys_kcos, _ = groups_s[1]
    sp_fft = S.build_spectral(f32, M.build_geometry(f32), use_matmul_fft=False,
                              device="cuda")
    group_s = time_group(consts_s.sp, sp_fft, "inverse, physics + SPPT",
                         "inverse", phys_fields, phys_kcos, card,
                         "T30L8 f32, the SPPT state after a day")
    del phys_fields, groups_s, sp_fft
    spec_s = SP.advance(consts_s.sppt, state_s["sppt_spec"], se[0])
    args_s, kw_s = PD.physics_grid_inputs(consts_s, state_s, True, spec_s)
    pattern = kw_s["sppt_pattern"]
    pat_plain = torch.clamp(tk.spec2grid_plain(consts_s.sp, spec_s, 1, 1),
                            -1.0, 1.0)
    pattern_err = _rel(pattern, pat_plain)
    if not pattern_err <= 1e-5:
        raise RuntimeError(f"the SPPT pattern from the group differs from "
                           f"its plain transform: {pattern_err:.3e}")
    print(f"SPPT pattern of the model's spectrum after a day: from the "
          f"physics group {pattern_err:.3e} rel. from the plain transform "
          f"(limit 1e-5); std {float(pattern.std()):.4f}, largest "
          f"{float(pattern.abs().max()):.4f}")
    phys_sppt = check_physics(
        f32, N_MEMBERS, 1e-5, card, ("sppt",), timed=True,
        inputs={"args": args_s, "phisg": kw_s["phisg"],
                "m0corr": kw_s["m0corr"], "sppt": pattern,
                "source": "SPPT model state after a day, its own pattern"})
    del args_s, kw_s, pattern, pat_plain, spec_s, se
    noise = check_sppt_noise(consts_s.sp.el2.cpu().numpy(), card,
                             libs["sppt_noise"])

    phases.start("API phase")
    # 6f. the API phase: Speedy on the card in float64 (the fixtures'
    # precision), from the bundled boundary conditions, one day exported by
    # XarrayExporter and held against the golden fixture.
    reset_counts()
    t0 = time.perf_counter()
    api = Speedy(start_date=datetime(1982, 1, 1),
                 end_date=datetime(1982, 1, 2))
    api.set_bc()
    t_init = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        api.run(callbacks=[XarrayExporter(output_dir=out_dir)])
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches_api = dict(ck.launch_counts)
        plain_api = plain_calls()
        rel_api = fixture_ladder(str(Path(out_dir) / "1982-01-02_0000.nc"))
    api_mode = ("CUDA graphs" if api._run.graphs is not None
                else "eager loop")
    if (api._consts.device.type != "cuda" or api._run.graphs is None
            or api._consts.params.precision != "f64"
            or any(plain_api.values())
            or not all(launches_api[k] > 0 for k in (
                "grid_dynamics", "grid_physics_sw", "grid_physics_nosw",
                "fused_grid2spec", "fused_spec2grid", "spectral_update"))):
        raise RuntimeError(f"API phase: launches {launches_api}, plain calls "
                           f"{plain_api}")
    print(f"API phase: Speedy T30L8 f64 on the card ({api_mode}: "
          f"{api._run.graphs.stats['captures']} captures), set_bc from the "
          f"bundled files {t_init:.2f} s, 1982-01-01 -> 01-02 "
          f"({api.get_current_step()} steps) {t_run:.2f} s = "
          f"{1e3 * t_run / api.get_current_step():.2f} ms/step wall; "
          f"launches {launches_api} (the initialization and each step "
          f"kind's warm-up and captures), no plain call; against "
          f"tests/fixtures/1982-01-02_0000.nc through rtol "
          + ", ".join(f"{r:g}" for r in FIXTURE_LADDER)
          + ": largest rel. difference "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel_api.items())
          + f" [{card}]")
    del api

    phases.start("SpeedyEns phase")
    # 6g. SpeedyEns on the card: 16 members with SPPT, float32, one day
    # advanced as one member-batched run; members 0 and 1 again in a
    # two-member ensemble stepped one member at a time, bitwise the same.
    reset_counts()
    p_ens = dataclasses.replace(T30L8, precision="f32", sppt_on=True)
    t0 = time.perf_counter()
    ens = SpeedyEns(N_ENS, start_date=datetime(1982, 1, 1),
                    end_date=datetime(1982, 1, 2), params=p_ens)
    for member in ens:
        member.set_bc()
    t_ens_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    ens.run()
    torch.cuda.synchronize()
    t_ens = time.perf_counter() - t0
    launches_ens = dict(ck.launch_counts)
    seq = SpeedyEns(2, start_date=datetime(1982, 1, 1),
                    end_date=datetime(1982, 1, 2), params=p_ens)
    for member in seq:
        member.set_bc()
    seq.run(batched=False)
    ens_rel, ens_bitwise = 0.0, True
    for a, b in zip(ens.members[:2], seq.members):
        for name in ("vor", "div", "t", "ps", "tr"):
            x, y = a._state[name][0], b._state[name][0]
            ens_bitwise &= torch.equal(x, y)
            ens_rel = max(ens_rel, _rel(x, y))
    t_e = torch.stack([m._state["t"][0] for m in ens.members])
    ens_spread = float((t_e - t_e[:1]).abs().max() / t_e.abs().max())
    ens_graphs = ens.members[0]._run.graphs
    if ens_graphs is None or len(ens_graphs.plans) != 2:
        raise RuntimeError("SpeedyEns did not run on the graphs (one buffer "
                           "plan at 16 members, one at 1)")
    # Bitwise: every operation of the step gives a member the same bits at
    # any batch width (the kernels by design, the m=0 correction of
    # grid_phi as a row reduction, the noise elementwise).
    if not ens_bitwise or not ens_spread > 1e-6:
        raise RuntimeError(f"SpeedyEns: batched vs one by one not bitwise "
                           f"({ens_rel:.3e}), members differ by "
                           f"{ens_spread:.3e}")
    print(f"SpeedyEns phase: {N_ENS} members, T30L8 f32 with SPPT on the "
          f"card, CUDA graphs ({ens_graphs.stats['captures']} captures: "
          f"four graph keys at {N_ENS} members and at 1), set_bc "
          f"{t_ens_init:.2f} s, one day batched {t_ens:.2f} s "
          f"({1e3 * t_ens / 36:.2f} ms/step wall for all members), launches "
          f"{launches_ens}; members 0 and 1 against the same members stepped "
          f"one by one: bitwise equal (vor, div, t, ps, tr); members differ "
          f"in t by {ens_spread:.3e} (more than 1e-6) [{card}]")
    # The same with bf16_tendencies (the dense route's 2-byte operands):
    # 4 members for a day, batched, against members 0 and 1 stepped one by
    # one (bitwise), and against the float32 ensemble above.
    reset_counts()
    ens_b = SpeedyEns(4, start_date=datetime(1982, 1, 1),
                      end_date=datetime(1982, 1, 2), params=p_ens,
                      bf16_tendencies=True)
    for member in ens_b:
        member.set_bc()
    ens_b.run()
    torch.cuda.synchronize()
    launches_ens_b = dict(ck.launch_counts)
    plain_ens_b = plain_calls()
    seq_b = SpeedyEns(2, start_date=datetime(1982, 1, 1),
                      end_date=datetime(1982, 1, 2), params=p_ens,
                      bf16_tendencies=True)
    for member in seq_b:
        member.set_bc()
    seq_b.run(batched=False)
    ens_b_bitwise = all(
        torch.equal(a._state[n][0], b._state[n][0])
        for a, b in zip(ens_b.members[:2], seq_b.members)
        for n in ("vor", "div", "t", "ps", "tr"))
    moved_b = _rel(ens_b.members[0]._state["t"][0],
                   ens.members[0]._state["t"][0])
    if (not ens_b_bitwise or not 1e-8 < moved_b < 1e-3
            or not ens_b.members[0]._consts.bf16_tendencies
            or any(plain_ens_b.values())
            or not all(launches_ens_b[k] > 0 for k in (
                "grid_dynamics_bf16", "grid_physics_sw_bf16",
                "fused_grid2spec_bf16"))):
        raise RuntimeError(f"SpeedyEns with bf16_tendencies: batched vs one "
                           f"by one bitwise {ens_b_bitwise}, t vs the float32"
                           f" ensemble {moved_b:.3e}, launches "
                           f"{launches_ens_b}, plain calls {plain_ens_b}")
    print(f"SpeedyEns phase, bf16_tendencies: 4 members, T30L8 f32 with SPPT "
          f"for a day on the card, launches {launches_ens_b}, no plain call; "
          f"members 0 and 1 bitwise the same members stepped one by one; "
          f"member 0's t {moved_b:.3e} (rel.) from the float32 ensemble's "
          f"(between 1e-8 and 1e-3) [{card}]")
    del ens, seq, t_e, ens_b, seq_b

    # 6h. the explicit gravity-wave branch at full width (T30, alph = 0,
    # 144 steps a day): rows 1-4 and no spectral update.
    phases.start("explicit path, a day")
    explicit = explicit_path(card, phases)

    # 6i. the T47L8 and T63L8 presets at full width: rows 1, 2, 6 and the
    # T47/T63 transform kernels at their shapes and a model day through
    # them.
    presets, bf16_presets = {}, {}
    for name, base in (("T47", T47L8), ("T63", T63L8)):
        presets[name] = preset_path(name, base, libs, card, phases)
        # 6i'. the same presets with bf16_tendencies: row 3 with a bfloat16
        # grid, rows 1-2 with bfloat16 outputs, a model day through them.
        bf16_presets[name] = bf16_preset_path(
            name, base, libs, card, phases, presets[name].pop("f32_model"))

    # 6j. the climatology check through the port's script (T30 f32, Speedy).
    phases.start("climatology phase")
    climate = climatology_phase(card)

    # 6k. a trace of a 3-step window of the main path (utils.profiling).
    phases.start("profiling trace")
    traced = trace_phase(run, state, cal_day2, first_main)

    phases.start("float64 card vs CPU")
    # 7. float64 end to end with physics: the card (the column kernels and
    # the fused transform kernels in float64) against the CPU (their plain
    # versions: the dense matmul chain for the transforms) from the same
    # initial state, grid_phi on in both; the card through the runner's
    # CUDA graphs (its wrappers called by each step kind's warm-up and
    # capture).
    ck.reset_launch_counts()
    nmem64 = 4
    evals64 = graph_evals(2, N_STEPS)
    consts_c, state_c, cal_c = make_demo_model(f64, device="cpu",
                                               grid_phi=True)
    consts_g, _ = M.build_consts(f64, device="cuda", grid_phi=True)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal_c), 2, N_STEPS)
    out_c = make_run_steps_batched(consts_c, device="cpu")(
        broadcast_state(state_c, nmem64), ctx)
    GK.reset_plain_calls()
    tk.reset_field_counts()
    out_g = make_run_steps_batched(consts_g, device="cuda")(
        broadcast_state(to_gpu(state_c), nmem64), ctx)
    torch.cuda.synchronize()
    check_state(out_g, nmem64, "f64 card run")
    launches64 = dict(ck.launch_counts)
    fields64 = dict(tk.field_counts)
    want64, want_fields64 = expected_path_launches(consts_g, 2, N_STEPS,
                                                   evals64, with_init=False)
    if (launches64 != want64 or fields64 != want_fields64
            or not consts_c.sp.use_dense_legendre
            or any(GK.plain_calls.values())):
        raise RuntimeError(f"f64 card run: launches {launches64}, transform "
                           f"fields {fields64}, expected {want64} and "
                           f"{want_fields64} on the dense route; plain calls "
                           f"{GK.plain_calls}")
    worst64, worst_name = 0.0, ""
    fields = [(n, out_g[n][0], out_c[n][0]) for n in PROGNOSTICS]
    fields += [(n, out_g[n], out_c[n]) for n in
               ("hfluxn", "precnv", "precls", "olr", "tsr", "rad_tau2",
                "sst_om", "land_temp")]
    for name, a, b in fields:
        err = float((a.cpu() - b).abs().max() / (b.abs().max() or 1.0))
        if err > worst64:
            worst64, worst_name = err, name
    # The limit of the dynamics-only comparison holds with the physics: no
    # column changed branch between the kernel and the plain version.
    print(f"f64 end to end with physics: T30L8, B={nmem64}, {N_STEPS} steps,"
          f" card (kernels, CUDA graphs) vs CPU (plain): max rel err "
          f"{worst64:.3e} in "
          f"{worst_name} over the prognostics and 8 physics fields (limit "
          f"1e-9); float64 transform kernels launched "
          f"{launches64['fused_grid2spec']} + {launches64['fused_spec2grid']}"
          f" times for {fields64['fused_grid2spec']} + "
          f"{fields64['fused_spec2grid']} fields, the float64 spectral update "
          f"{launches64['spectral_update']} (each step kind's warm-up and "
          f"capture; no plain call)")
    if not worst64 <= 1e-9:
        raise RuntimeError("float64 card run disagrees with the CPU run")

    # 7b. the SPPT day in float64: the card against the CPU from the same
    # initial state and the same member keys (split from the state's), the
    # noise drawn on each device.
    ck.reset_launch_counts()
    p64s = dataclasses.replace(f64, sppt_on=True)
    consts_cs, state_cs, cal_cs = make_demo_model(p64s, device="cpu",
                                                  grid_phi=True)
    consts_gs, _ = M.build_consts(p64s, device="cuda", grid_phi=True)
    ctx_s, _ = M.build_step_ctx(dataclasses.replace(cal_cs), 2, N_STEPS)
    out_cs = make_run_steps_batched(consts_cs, device="cpu")(
        broadcast_state(state_cs, nmem64), ctx_s)
    GK.reset_plain_calls()
    tk.reset_field_counts()
    out_gs = make_run_steps_batched(consts_gs, device="cuda")(
        broadcast_state(to_gpu(state_cs), nmem64), ctx_s)
    torch.cuda.synchronize()
    check_state(out_gs, nmem64, "f64 SPPT card run")
    launches64s = dict(ck.launch_counts)
    if (launches64s["grid_physics_sw"] + launches64s["grid_physics_nosw"]
            != len(evals64) or any(GK.plain_calls.values())):
        raise RuntimeError(f"f64 SPPT card run: launches {launches64s}, "
                           f"plain calls {GK.plain_calls}")
    worst64s, worst_name_s = 0.0, ""
    fields_s64 = [(n, out_gs[n][0], out_cs[n][0]) for n in PROGNOSTICS]
    fields_s64 += [(n, out_gs[n], out_cs[n]) for n in
                   ("sppt_spec", "hfluxn", "precnv", "precls", "olr")]
    for name, a, b in fields_s64:
        err = float((a.cpu() - b).abs().max() / (b.abs().max() or 1.0))
        if err > worst64s:
            worst64s, worst_name_s = err, name
    t_g = out_gs["t"][0]
    spread64 = float((t_g - t_g[:1]).abs().max() / t_g.abs().max())
    print(f"f64 SPPT day: T30L8, B={nmem64}, {N_STEPS} steps, card (kernels) "
          f"vs CPU (plain), the same member keys: max rel err {worst64s:.3e} "
          f"in {worst_name_s} over the prognostics, the SPPT spectrum and 4 "
          f"physics fields (limit 1e-9); members differ in t by "
          f"{spread64:.3e}")
    if not worst64s <= 1e-9 or not spread64 > 1e-6:
        raise RuntimeError("the float64 SPPT card run disagrees with the CPU "
                           "run, or its members did not diverge")
    del out_cs, out_gs, state_cs

    phases.stop()
    print("phases of this run (utils.profiling.PhaseTimer, each ended by "
          "torch.cuda.synchronize()):")
    for line in timer.report().splitlines():
        print("  " + line)

    # 8. kernels
    def entry(name, source, replaces, n_launches, res, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": res["max_abs_err"],
                "max_rel_err": res["max_rel_err"], "ms": res["ms"],
                "call_ms": res["call_ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms"), "shape": shape}

    def preset_entries(counter, key, sub=None):
        """{preset: the kernel against its plain version at the preset's
        shapes, f32 B=N_MEMBERS, and its launches on the preset's path}."""
        out = {}
        for name, r in presets.items():
            res = r[key][sub] if sub else r[key]
            out[name] = {k: res[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "max_rel_err")}
            out[name]["launches"] = r["launches"][counter]
        return out

    shape = f"T30L8 f32 B={N_MEMBERS}"
    phys_src = "pyspeedy_tpu_torch/csrc/grid_physics.cu"
    phys_repl = "pyspeedy_tpu/physics/pallas_physics.py:30"
    kernels = [entry("grid_dynamics",
                     "pyspeedy_tpu_torch/csrc/grid_dynamics.cu",
                     "pyspeedy_tpu/ops/pallas_tiling.py:56",
                     launches["grid_dynamics"], res32, shape)]
    kernels[0]["launches_dynamics_only_path"] = launches_dyn["grid_dynamics"]
    kernels[0]["launches_explicit_path"] = explicit["launches"]["grid_dynamics"]
    kernels[0]["presets"] = preset_entries("grid_dynamics", "dyn")
    kernels[0]["launches_bf16_path"] = launches_b["grid_dynamics_bf16"]
    md_2x2 = md["ranks"][0]["2x2"]["launches"]
    kernels[0]["launches_multidevice_2x2_per_rank"] = md_2x2["grid_dynamics"]
    for il in ("il24", "il12"):
        kernels[0]["band_" + il] = md["bands"][il]["grid_dynamics"]
    kernels[0].update(bf16_out["grid_dynamics"])
    kernels[0]["bf16_from_f64"] = bf16_out64["grid_dynamics"]
    kernels[0]["bf16_presets"] = {
        p: {"f32": r["outputs"]["grid_dynamics"],
            "f64": r["outputs_f64"]["grid_dynamics"],
            "launches": r["launches"]["grid_dynamics_bf16"]}
        for p, r in bf16_presets.items()}
    for name in ("grid_physics_sw", "grid_physics_nosw"):
        kernels.append(entry(name, phys_src, phys_repl, launches[name],
                             phys32[name], shape + " grid_phi"))
        kernels[-1]["ms_f64"] = phys64[name]["ms"]
        kernels[-1]["bound_ms_f64"] = phys64[name]["bound_ms"]
        kernels[-1]["f2f_float_double_in_float"] = f2f_float(
            "grid_physics_kernel")
        kernels[-1]["ms_model_state"] = phys_state[name]["ms"]
        kernels[-1]["bound_ms_model_state"] = phys_state[name]["bound_ms"]
        sw = "true" if name == "grid_physics_sw" else "false"
        for key, t in (("", "float"), ("_f64", "double")):
            blocks, threads, _, regs, local = occupancy[
                f"grid_physics_kernel<{t}, 8, {sw}, false>"]
            kernels[-1]["registers" + key] = regs
            kernels[-1]["local_bytes" + key] = local
            kernels[-1]["warps_per_sm" + key] = blocks * threads // 32
        kernels[-1]["flipped_columns"] = phys32[name]["flipped_columns"]
        kernels[-1]["launches_sppt_path"] = launches_s[name]
        kernels[-1]["ms_sppt_model_pattern"] = phys_sppt[name]["ms"]
        kernels[-1]["bound_ms_sppt_model_pattern"] = phys_sppt[name][
            "bound_ms"]
        kernels[-1]["plain_ms_sppt_model_pattern"] = phys_sppt[name][
            "plain_ms"]
        kernels[-1]["flipped_columns_sppt_model_pattern"] = phys_sppt[name][
            "flipped_columns"]
        kernels[-1]["launches_bf16_path"] = launches_b[name + "_bf16"]
        kernels[-1].update(bf16_out[name])
        kernels[-1]["bf16_from_f64"] = bf16_out64[name]
        kernels[-1]["bf16_presets"] = {
            p: {"f32": r["outputs"][name], "f64": r["outputs_f64"][name],
                "launches": r["launches"][name + "_bf16"]}
            for p, r in bf16_presets.items()}
        kernels[-1]["launches_explicit_path"] = explicit["launches"][name]
        kernels[-1]["presets"] = preset_entries(name, "phys", name)
        kernels[-1]["launches_multidevice_2x2_per_rank"] = md_2x2[name]
        for il in ("il24", "il12"):
            kernels[-1]["band_" + il] = md["bands"][il][name]
    tr_src = "pyspeedy_tpu_torch/csrc/fused_transform.cu"
    rows = f"T30 f32, {N_MEMBERS * T30L8.kx} rows (B={N_MEMBERS} x kx)"
    for name, repl in (("fused_grid2spec", "tools/exp_fused_transform.py:65"),
                       ("fused_spec2grid", "tools/exp_fused_transform.py:121")):
        kernels.append(entry(name, tr_src, repl, launches[name], tr32[name],
                             rows))
        kernels[-1]["fft_route_ms"] = tr32[name]["fft_route_ms"]
        kernels[-1]["launches_explicit_path"] = explicit["launches"][name]
        kernels[-1]["fields"] = fields_main[name]
        kernels[-1]["launches_dynamics_only_path"] = launches_dyn[name]
        kernels[-1]["fields_dynamics_only_path"] = fields_dyn[name]
        kernels[-1]["launches_sppt_path"] = launches_s[name]
        kernels[-1]["fields_sppt_path"] = fields_s[name]
        kernels[-1]["launches_multidevice_2x2_per_rank"] = md_2x2[name]
        kernels[-1]["max_rel_err_call_site_groups_sppt"] = sites_err_s
        kernels[-1]["groups"] = tr32[name]["groups"]
        kernels[-1]["groups_f64"] = tr64[name]["groups"]
        kernels[-1]["max_rel_err_call_site_groups"] = sites_err
        for key in ("ms", "call_ms", "plain_ms", "bound_ms", "max_rel_err",
                    "fft_route_ms"):
            kernels[-1][key + "_f64"] = tr64[name][key]
    kernels[-1]["group_sppt_physics"] = group_s
    kernels[-2]["launches_bf16_path"] = launches_b["fused_grid2spec_bf16"]
    kernels[-2]["fields_bf16_path"] = fields_b["fused_grid2spec_bf16"]
    kernels[-2].update(tr_bf16)
    kernels[-2].update({k + "_f64": v for k, v in tr_bf16_64.items()})
    # Rows 3-4 at T47/T63 (csrc/fused_transform_hires.cu, one device kernel
    # a launch, on thread-block clusters): launches on the T47 and T63 paths (the wrapper calls of
    # their graph days: the initialization and each step kind's warm-up and
    # capture); times and bound at T63 f32, one kx stack of 128 members;
    # every preset's figures, the step's groups and float64 under "presets".
    for name, direction, repl in (
            ("fused_grid2spec_hires", "direct",
             "tools/exp_fused_transform.py:65"),
            ("fused_spec2grid_hires", "inverse",
             "tools/exp_fused_transform.py:121")):
        t63 = presets["T63"]["transforms"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pyspeedy_tpu_torch/csrc/fused_transform_hires.cu",
            "replaces": repl, "kernels": list(t63["occupancy"]),
            "launches": sum(r["launches"][name] for r in presets.values()),
            "launches_on": "the T47 and T63 paths",
            "launches_by_path": {p: r["launches"][name]
                                 for p, r in presets.items()},
            "max_abs_err": max(r["transforms"][name]["max_abs_err"]
                               for r in presets.values()),
            "max_rel_err": max(r["transforms"][name]["max_rel_err"]
                               for r in presets.values()),
            "ms": t63["ms"], "call_ms": t63["call_ms"],
            "plain_ms": t63["plain_ms"], "bound_ms": t63["bound_ms"],
            "bound_by": t63["bound_by"], "library_ms": t63["plain_ms"],
            "shape": f"T63 f32, {N_MEMBERS * T63L8.kx} rows (B={N_MEMBERS} "
                     f"x kx)",
            "kernels_f64": {p: list(r["transforms_f64"][name]["occupancy"])
                            for p, r in presets.items()},
            "presets": {p: {"f32": r["transforms"][name],
                            "f64": r["transforms_f64"][name],
                            "member_alone_bitwise_after_a_day":
                                r["member0_b128_vs_b1_bitwise"]}
                        for p, r in presets.items()}})
    # Row 3 at T47/T63 with a bfloat16 grid (bf16_tendencies there):
    # launches on the two bf16_tendencies preset paths (the wrapper calls of
    # their graph days); times and bound at T63 f32, 1,024 rows, the grid
    # at 2 bytes; beside them the float32 instantiation on the widened grid.
    t63b = bf16_presets["T63"]["transform"]["rows_1024"]
    kernels.append({
        "name": "fused_grid2spec_hires_bf16", "route": "cuda",
        "source": "pyspeedy_tpu_torch/csrc/fused_transform_hires.cu",
        "replaces": "tools/exp_fused_transform.py:65",
        "kernels": ["hires_direct_cluster_kernel<S, T, __nv_bfloat16>"],
        "launches": sum(r["launches"]["fused_grid2spec_hires_bf16"]
                        for r in bf16_presets.values()),
        "launches_on": "the T47 and T63 bf16_tendencies paths",
        "launches_by_path": {
            p: r["launches"]["fused_grid2spec_hires_bf16"]
            for p, r in bf16_presets.items()},
        "launches_f64_day": {
            p: r["launches_f64"]["fused_grid2spec_hires_bf16"]
            for p, r in bf16_presets.items()},
        "max_abs_err": max(r["transform"]["max_abs_err"]
                           for r in bf16_presets.values()),
        "max_rel_err": max(r["transform"]["max_rel_err"]
                           for r in bf16_presets.values()),
        "ms": t63b["ms"], "call_ms": t63b["call_ms"],
        "plain_ms": t63b["plain_ms"], "bound_ms": t63b["bound_ms"],
        "bound_by": t63b["bound_by"], "library_ms": t63b["plain_ms"],
        "ms_widened_f32_kernel": t63b["ms_widened"],
        "shape": f"T63 f32, {N_MEMBERS * T63L8.kx} rows (B={N_MEMBERS} x "
                 f"kx), bfloat16 grid",
        "presets": {p: {"f32": r["transform"], "f64": r["transform_f64"],
                        "member_alone_bitwise_after_a_day":
                            r["member0_b128_vs_b1_bitwise"],
                        "f64_day_card_vs_cpu": r["f64_max_rel_err"]}
                    for p, r in bf16_presets.items()}})
    # The probes are not on the model's path: their launches are those of
    # the probe path above; the entry's times and bound are those of p2, the
    # whole chain for one part, at the tool's 256 rows, and every stage
    # carries its own there and at 9,344 rows (the step's direct group at
    # B=128) under `stages_step`.
    stage2 = probes32["stages"][2]
    kernels.append({
        "name": "fused_probe", "route": "cuda", "source": tr_src,
        "replaces": "tools/exp_fused_probe.py:49",
        "kernels": [PROBE_KERNELS[q] for q in tk.PROBE_STAGES],
        "launches": launches_probe["fused_probe"],
        "launches_on": "the probe path (the model's steps do not run it)",
        "max_abs_err": max(x["max_abs_err"] for x in probes32["stages"]),
        "max_rel_err": max(x["max_rel_err"] for x in probes32["stages"]),
        "ms": stage2["ms"], "call_ms": stage2["call_ms"],
        "plain_ms": stage2["plain_ms"], "bound_ms": stage2["bound_ms"],
        "bound_by": stage2["bound_by"], "library_ms": stage2["library_ms"],
        "shape": f"T30 f32, {N_PROBE_ROWS} rows, p2",
        "stages": probes32["stages"], "stages_step": probes32["stages_step"],
        "row3_ms_step": probes32["row3_ms_step"],
        "row3_group_ms": probes32["row3_group_ms"],
        "stages_f64": probes64["stages"],
        "stages_step_f64": probes64["stages_step"],
        "row3_ms_step_f64": probes64["row3_ms_step"]})
    glue = entry("spectral_update",
                 "pyspeedy_tpu_torch/csrc/spectral_update.cu",
                 "tools/exp_glue.py:39", launches["spectral_update"], glue32,
                 shape)
    glue["launches_dynamics_only_path"] = launches_dyn["spectral_update"]
    glue["launches_explicit_path"] = explicit["launches"]["spectral_update"]
    glue["presets"] = preset_entries("spectral_update", "glue")
    for name in presets:
        glue["presets"][name]["launch_plan"] = presets[name]["plan"]
        glue["presets"][name]["launch_plan_f64"] = presets[name]["plan_f64"]
        glue["presets"][name]["f64"] = {k: presets[name]["glue_f64"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_rel_err")}
    glue["launches_bf16_path"] = launches_b["spectral_update"]
    glue["launches_multidevice_2x2_per_rank"] = md_2x2["spectral_update"]
    glue["launches_f64_day"] = launches64["spectral_update"]
    glue["max_rel_err_model_state"] = glue_state
    for key in ("ms", "call_ms", "plain_ms", "bound_ms", "max_rel_err",
                "ms_b1", "bound_ms_b1"):
        glue[key + "_f64"] = glue64[key]
    glue["ms_b1"], glue["bound_ms_b1"] = glue32["ms_b1"], glue32["bound_ms_b1"]
    glue["f2f_float_double_in_float"] = f2f_float("spectral_update_kernel")
    for key, t in (("", "float"), ("_f64", "double")):
        blocks, threads, _, regs, local = occupancy[
            f"spectral_update_kernel<{t}, 8>"]
        glue["registers" + key] = regs
        glue["local_bytes" + key] = local
        glue["warps_per_sm" + key] = blocks * threads // 32
    kernels.append(glue)
    # The DFT chain is not on the model's path: its launches are those of
    # the DFT-chain path above.
    dft = entry("dft_chain", "pyspeedy_tpu_torch/csrc/dft_chain.cu",
                "tools/exp_dft_kernel.py:113", launches_dft["dft_chain"],
                dft32, f"f32 B={N_DFT_MEMBERS} x ({DC.NFIELDS}, {DC.KX}, "
                f"{DC.IL}, {DC.MX}) Fourier pairs")
    dft["launches_on"] = "the DFT-chain path (the model's steps do not run it)"
    for key in ("kernel", "member_alone_bitwise", "registers", "local_bytes",
                "warps_per_sm"):
        dft[key] = dft32[key]
    for key in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "max_rel_err", "kernel", "member_alone_bitwise", "registers",
                "local_bytes", "warps_per_sm"):
        dft[key + "_f64"] = dft64[key]
    kernels.append(dft)
    # SPPT's noise, on the SPPT path (the main path draws none).
    kernels.append({
        "name": "sppt_noise", "route": "cuda",
        "source": "pyspeedy_tpu_torch/csrc/sppt_noise.cu",
        "replaces": "none (the JAX package draws with jax.random)",
        "launches": launches_s["sppt_noise"],
        "launches_on": "the SPPT path: the initialization's three draws and "
                       "one a run call",
        "shape": "T30L8 f32 B=1024 x 8 steps",
        **{k: noise["f32"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bitwise", "ulps")},
        **{k + "_f64": noise["f64"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bitwise", "ulps")}})
    # The main path's kernels: `launches` is the initialization's (eager,
    # counted by the wrappers) and the profiler's records of the graph day;
    # beside it the wrappers' calls in that day and the eager day's
    # launches. The launches_*_path keys of graph paths count wrapper calls.
    for k in kernels:
        if k["name"] in KERNEL_OF_COUNTER and "launches_on" not in k:
            k["launches_eager_day"] = launches_eager_day[k["name"]]
            k["wrapper_calls_graph_path"] = wrapper_calls[k["name"]]
            k["launches_counted_by"] = (
                "launches: the wrappers' counts of the initialization and "
                "the profiler's records of the main path's graph day; "
                "launches_*_path of the graph paths: wrapper calls (the "
                "initialization and each step kind's warm-up and captures)")
    # The graph runner against the eager loop on every path, in turns.
    paths = {"T30 B=128": main_graphs, "T30 B=1": b1_graphs,
             "SPPT": sppt_graphs, "explicit": explicit["graphs"],
             "bf16_tendencies": bf16_graphs,
             **{name: r["graphs"] for name, r in presets.items()},
             **{name + " bf16_tendencies": r["graphs"]
                for name, r in bf16_presets.items()}}
    print(json.dumps({"graphs": {name: {
        k: g[k] for k in ("bitwise", "diffs", "captures", "ms_per_step",
                          "profile")} for name, g in paths.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
