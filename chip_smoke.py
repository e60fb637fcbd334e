#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``pyspeedy_tpu_torch/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card at the shapes the
model gives it (the two column kernels, their bfloat16-output instantiations,
the fused spectral transforms in float32, float64 and the 2-byte operand
mode, the four probe stages), drives the port's paths through the public
entry points (the member-batched dynamics-only T30L8 model at a reduced
depth; the main path: the full-physics T30L8 model, initialization and one
model day of 128 members; the bf16_tendencies configuration at a reduced
depth; the probe stages on the model's own fields), checks the results and
the exact launch counts of every path, and prints what it measured. It needs a CUDA
device and exits non-zero without one; there is no CPU fallback. Every phase
that fails raises, so the run exits non-zero.

Output: one line (or a few) per phase; a ``{"kernels": [...]}`` JSON line;
the card's name and power limit as nvidia-smi gives them; and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

from pyspeedy_tpu_torch.models import model as M
from pyspeedy_tpu_torch.models.tendencies import grid_dynamics_core
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import spectral as S
from pyspeedy_tpu_torch.ops import transform_kernels as tk
from pyspeedy_tpu_torch.parallel.ensemble import (broadcast_state,
                                                   make_run_steps_batched)
from pyspeedy_tpu_torch.params import T30L5, T30L8
from pyspeedy_tpu_torch.physics import driver as PD
from pyspeedy_tpu_torch.testing import make_demo_model

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 / float64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# bfloat16 products run in the tensor cores (dense rate, same data sheet).
PEAK_FLOPS_BF16 = 989e12

N_MEMBERS = 128
N_STEPS = 36            # one model day at T30
N_STEPS_DYN = 12        # depth of the dynamics-only path
N_STEPS_BF16 = 12       # depth of the bf16_tendencies path
N_PROBE_ROWS = 256      # rows of the probe stages' comparison
PHYS_NAMES = (("utend", "vtend", "ttend", "qtend") + PD.DIAG_FIELDS
              + PD.CACHE_FIELDS)
# Columns of a float32 comparison that may sit on a threshold of the physics
# (a convection or cloud top, a stability switch, nint(T)) and take the other
# branch in the kernel: counted, shown to agree in float64, and gated here.
F32_FLIP_CEILING = 20
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
OUT_NAMES = ("utend", "vtend", "ttend", "trtend", "psdt_g", "flux_ut",
             "flux_vt", "flux_qu", "flux_qv", "ke")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def kernel_device_ms(fn, kernel_name: str, reps: int = 20) -> float:
    """Time the card spends in one launch of the named kernel, from the
    profiler's device-side records (CUPTI). Raises if it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel_name in e.key]
    count = sum(e.count for e in hits)
    # The tracer may drop a record now and then: the mean is over the
    # launches it did record; none at all, or more than were made, is wrong.
    if not 0 < count <= reps:
        raise RuntimeError(
            f"profiler recorded {count} launches of {kernel_name}, "
            f"expected {reps}")
    return 1e-3 * sum(e.self_device_time_total for e in hits) / count


def kernel_inputs(params, n_members: int, seed: int = 0):
    """Seeded grid fields of plausible magnitude at the model's shapes."""
    rng = np.random.default_rng(seed)
    kx, il, ix, ntr = params.kx, params.il, params.ix, params.ntr
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
    ops = (n_members * params.il * params.ix
           * (params.kx * (70 + 11 * params.ntr) + 5))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[params.dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes


def check_kernel(params, n_members: int, limit: float, card: str):
    """Grid-dynamics kernel against its plain version on the card: all ten
    outputs."""
    consts, _ = M.build_consts(params, device="cuda", physics_on=False)
    args = kernel_inputs(params, n_members)
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
    tag = f"T30L{params.kx} {params.precision} B={n_members}"
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
    kx, il, ix = p.kx, p.il, p.ix
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
    ops = tg.shape[0] * params.il * params.ix * (params.kx * per_level + 150)
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
    c64 = check_physics.consts64[consts.params.kx, consts.sea_coupling_flag]
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
                  timed=False):
    """The physics kernel against its plain version on the card, both
    shortwave variants, in the modes `what` names: "phig" (geopotential
    read), "grid_phi" (integrated in the kernel), "sppt" (with a pattern).
    Returns {variant: measurements} for the last mode when `timed`."""
    consts, _ = M.build_consts(params, device="cuda", sea_coupling_flag=sea)
    check_physics.consts64.setdefault(
        (params.kx, sea), M.build_consts(
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
        tag = (f"T30L{params.kx} {params.precision} B={tg.shape[0]} "
               f"{x.get('source', 'random columns')} {mode} sea={sea}")
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

def transform_bound(sp, nrows: int, direct: bool, in_dtype):
    """Least time the card could take for `nrows` field rows: the larger of
    bytes over the memory rate (the grid rows, the spectral pairs and the two
    tables, each once) and operations over the peak rate of the operand type
    (a DFT of il x ix x 2mx and a block-structured Legendre stage of
    2 x mx x nx x il multiply-adds per row)."""
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    work = sp.rdtype.itemsize
    grid_b = il * ix * (in_dtype.itemsize if direct else work)
    spec_b = 2 * mx * nx * work
    table_b = (2 * ix * mx + il * mx * nx) * (
        in_dtype.itemsize if direct else work)
    nbytes = nrows * (grid_b + spec_b) + table_b
    ops = nrows * 2 * (il * ix * 2 * mx + 2 * mx * nx * il)
    peak = (PEAK_FLOPS_BF16 if in_dtype == torch.bfloat16
            else PEAK_FLOPS[sp.rdtype])
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes, ops


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


def check_transforms(params, limit: float, card: str):
    """Both fused transform kernels against their plain versions (the dense
    matmul chain, which is also the library yardstick) at the shapes the
    main path gives them, in the strided layouts the step passes, and timed
    at one kx stack of 128 members; beside them the same transform through
    the torch.fft route."""
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
          f"plain {worst_d:.3e} / {worst_i:.3e} over (B, k) = (128, {kx}), "
          f"(128, 1), (1, 1), (128, 2), kcos 1 and 2; strided layouts "
          f"{strided:.3e} (limit {limit:.0e}); m=0 imaginary garbage: "
          f"bitwise no effect; round trip of a truncated field {trip:.3e} "
          f"(limit 2e-2), vs the plain round trip {trip_plain:.3e}")
    if not max(worst_d, worst_i, strided, trip_plain) <= limit:
        raise RuntimeError("a fused transform kernel disagrees with its "
                           "plain version")
    if not trip <= 2e-2:
        raise RuntimeError(f"round trip error {trip:.3e}")

    # Times at one kx stack of 128 members (1,024 rows).
    g, p = transform_inputs(sp, N_MEMBERS, kx, seed=7)
    nrows = N_MEMBERS * kx
    sp_fft = S.build_spectral(params, M.build_geometry(params),
                              use_matmul_fft=False, device="cuda")
    res = {}
    for name, kern, launch, plain, fft, worst, max_abs, direct in (
            ("fused_grid2spec", "grid2spec_kernel",
             lambda: tk.fused_grid2spec_cuda(sp, g, 1),
             lambda: tk.grid2spec_plain(sp, g, 1),
             lambda: S.grid2spec_p(sp_fft, g, 1), worst_d, abs_d, True),
            ("fused_spec2grid", "spec2grid_kernel",
             lambda: tk.fused_spec2grid_cuda(sp, p, 1, 1),
             lambda: tk.spec2grid_plain(sp, p, 1, 1),
             lambda: S.spec2grid_p(sp_fft, p, 1, 1), worst_i, abs_i, False)):
        ms = kernel_device_ms(launch, kern)
        call_ms = time_ms(launch, reps=20)
        plain_ms = time_ms(plain, reps=10, warmup=2, windows=3)
        fft_ms = time_ms(fft, reps=10, warmup=2, windows=3)
        bound_ms, bound_by, nbytes, ops = transform_bound(
            sp, nrows, direct, sp.rdtype)
        print(f"  {name} {tag} {nrows} rows: the same transform through the "
              f"fft route (torch.fft + Legendre einsum) {fft_ms:.4f} ms")
        print(f"  {name} {tag} {nrows} rows: kernel {ms:.4f} ms on the card "
              f"({call_ms:.4f} ms per wrapper call, back to back), plain = "
              f"library (dense cuBLAS chain) {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP at {PEAK_FLOPS[sp.rdtype] / 1e12:.0f} "
              f"TFLOP/s) = {100 * bound_ms / ms:.0f}% [{card}]")
        res[name] = {"max_rel_err": worst, "max_abs_err": max_abs, "ms": ms,
                     "call_ms": call_ms, "plain_ms": plain_ms,
                     "library_ms": plain_ms, "fft_route_ms": fft_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    return res


def check_bf16_operands(params, card: str):
    """The 2-byte operand mode of the direct transform against its plain
    chain: limit 2^-8 of the output's largest value (one bfloat16 rounding of
    the Fourier intermediate may fall the other way), the rms error beside
    it."""
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
        if got.dtype != torch.float32:
            raise RuntimeError("2-byte operand mode must return float32")
    vs_f32 = _rel(got, tk.grid2spec_plain(sp, g.float(), 1))
    g, _ = transform_inputs(sp, N_MEMBERS, kx, seed=21)
    g = g.to(torch.bfloat16)
    launch = lambda: tk.fused_grid2spec_cuda(sp, g, 1)
    ms = kernel_device_ms(launch, "grid2spec_kernel")
    call_ms = time_ms(launch, reps=20)
    plain_ms = time_ms(lambda: tk.grid2spec_plain(sp, g, 1), reps=10,
                       warmup=2, windows=3)
    bound_ms, bound_by, nbytes, _ = transform_bound(
        sp, N_MEMBERS * kx, True, torch.bfloat16)
    limit = 2.0 ** -8
    print(f"kernel fused_grid2spec, 2-byte operands (bfloat16 grid and "
          f"tables, float32 sums and result): max rel err vs its plain chain "
          f"{worst:.3e} (limit 2^-8 = {limit:.3e}), rms {rms:.3e}; against "
          f"the float32 transform of the same rounded grid {vs_f32:.3e}; "
          f"kernel {ms:.4f} ms on the card ({call_ms:.4f} ms per call), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB) [{card}]")
    if not worst <= limit:
        raise RuntimeError("the 2-byte operand kernel disagrees with its "
                           "plain chain")
    return {"max_rel_err_bf16": worst, "max_abs_err_bf16": max_abs,
            "rms_rel_err_bf16": rms, "ms_bf16": ms, "call_ms_bf16": call_ms,
            "plain_ms_bf16": plain_ms, "bound_ms_bf16": bound_ms,
            "bound_by_bf16": bound_by}


def check_probes(params, limit: float, card: str):
    """Each probe stage against its plain version, and its time on the card:
    which stage is wrong, and which stage takes the time."""
    consts, _ = M.build_consts(params, device="cuda", physics_on=False)
    sp = consts.sp
    rng = np.random.default_rng(30)
    g = torch.from_numpy(rng.standard_normal(
        (N_PROBE_ROWS, sp.il, sp.ix))).to("cuda", sp.rdtype)
    what = {0: "DFT stage to device memory",
            1: "DFT stage through shared memory, stored flat",
            2: "DFT + Legendre stage, one part",
            3: "inverse-side split, times 2"}
    il, ix, mx, nx, n = sp.il, sp.ix, sp.mx, sp.nx, N_PROBE_ROWS
    size = sp.rdtype.itemsize
    # Bytes (input read once, output written once, tables once) and
    # operations of each stage, for its bound.
    dft_bytes, dft_ops = n * il * (ix + mx) + ix * mx, 2 * n * il * ix * mx
    work = {0: (dft_bytes, dft_ops), 1: (dft_bytes, dft_ops),
            2: (n * (il * ix + mx * nx) + ix * mx + il * mx * nx,
                dft_ops + 2 * n * mx * nx * il),
            3: (2 * n * il * mx, n * il * mx)}
    stages = []
    for stage in tk.PROBE_STAGES:
        got = tk.fused_probe_cuda(sp, stage, g)
        want = tk.probe_plain(sp, stage, g)
        err = _rel(got, want)
        kern = "split_probe_kernel" if stage == 3 else "grid2spec_kernel"
        launch = lambda: tk.fused_probe_cuda(sp, stage, g)
        ms = kernel_device_ms(launch, kern)
        call_ms = time_ms(launch, reps=20)
        plain_ms = time_ms(lambda: tk.probe_plain(sp, stage, g), reps=10,
                           warmup=2, windows=3)
        t_b = work[stage][0] * size / PEAK_BYTES_PER_S
        t_o = work[stage][1] / PEAK_FLOPS[sp.rdtype]
        bound_ms, bound_by = 1e3 * max(t_b, t_o), (
            "bytes" if t_b >= t_o else "operations")
        print(f"kernel fused_probe p{stage} ({what[stage]}) T30L{params.kx} "
              f"{params.precision} {N_PROBE_ROWS} rows: max rel err vs plain "
              f"{err:.3e} (limit {limit:.0e}), kernel {ms:.4f} ms on the "
              f"card ({call_ms:.4f} ms per wrapper call, back to back), bound "
              f"{bound_ms:.5f} ms by {bound_by}, plain = PyTorch's own calls "
              f"{plain_ms:.4f} ms [{card}]")
        if got.shape != want.shape or not err <= limit:
            raise RuntimeError(f"probe stage {stage} disagrees with its "
                               f"plain version")
        # The plain version of a stage is PyTorch's own calls and nothing
        # else (one matmul, two for p2, a multiply for p3), so its time is
        # also the stage's library time.
        stages.append({"stage": f"p{stage}", "max_rel_err": err,
                       "max_abs_err": float((got - want).abs().max()),
                       "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                       "library_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})
    return stages


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


def check_bf16_outputs(params, card: str):
    """The bfloat16-output instantiations of the grid-dynamics and physics
    kernels against their plain versions with the flag."""
    consts, _ = M.build_consts(params, device="cuda")
    cb = dataclasses.replace(consts, bf16_tendencies=True)
    args = kernel_inputs(params, N_MEMBERS)
    k32 = ck.grid_dynamics_cuda(consts.col, *args)
    kb = ck.grid_dynamics_cuda(consts.col, *args, bf16_out=True)
    pb = grid_dynamics_core(consts.col, *args, bf16_out=True)
    shares = [bf16_agreement(f"grid_dynamics {n}", b, p, f)
              for n, b, p, f in zip(OUT_NAMES, kb, pb, k32)]
    launch = lambda: ck.grid_dynamics_cuda(consts.col, *args, bf16_out=True)
    ms = kernel_device_ms(launch, "grid_dynamics_kernel")
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *kb))
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    print(f"kernel grid_dynamics, bfloat16 outputs (all ten), T30L8 f32 "
          f"B={N_MEMBERS}: every store is the rounding of the float32 value; "
          f"vs the plain version with the flag {bf16_summary(shares)}; "
          f"kernel {ms:.4f} ms on the card, bound {bound_ms:.4f} ms "
          f"by bytes ({nbytes / 1e6:.1f} MB) [{card}]")
    out = {"grid_dynamics": {
        "ms_bf16": ms, "bound_ms_bf16": bound_ms,
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
        for g, f in zip(_flatten(rb)[4:], _flatten(f32)[4:]):
            if g.dtype != params.dtype or not torch.equal(g, f):
                raise RuntimeError(f"{name}: a diagnostic or cache field "
                                   f"changed with bf16_tendencies")
        launch = lambda: ck.grid_physics_cuda(cb, sw_flag, *a, **kwargs)
        ms = kernel_device_ms(launch, "grid_physics_kernel")
        bound_ms = physics_bound(
            params, sw_flag, a, {k: v for k, v in kwargs.items()}, rb)[0]
        print(f"kernel {name}, bfloat16 tendencies (after the SPPT multiply; "
              f"14 diagnostics and 7 cache fields stay float32 and are "
              f"bitwise unchanged), grid_phi: vs the plain version with the "
              f"flag {bf16_summary(shares)}; kernel {ms:.4f} ms on the card, "
              f"bound {bound_ms:.4f} ms by bytes [{card}]")
        out[name] = {
            "ms_bf16": ms, "bound_ms_bf16": bound_ms,
            "share_differing_bf16": max(r["differ"] for r in shares),
            "share_over_one_unit_bf16": max(r["wide"] for r in shares)}
    return out


def expected_transform_launches(consts, n_evals: int, n_forcings: int,
                                with_init: bool):
    """(direct, inverse) transform launches of a path, from the step's
    structure: a step evaluation transforms 7 stacks to the grid for the
    dynamics (vor, div, T, tracers, u, v, the log-ps gradient) and, with the
    physics, 5 more (u, v, T, q, ps; 6 without grid_phi: the phi stack), and
    7 + 3*ntr back (psdt, two wind and two temperature-flux fields, two
    fluxes and one tendency per tracer, kinetic energy, T); the daily forcing
    2 direct; the initialization itself 4 direct and 2 inverse (the filtered
    orography, its spectral form and synthesis, surface pressure and
    humidity of the rest state)."""
    ntr = consts.params.ntr
    inv = 7 + ((5 if consts.grid_phi else 6) if consts.physics_on else 0)
    direct = n_evals * (7 + 3 * ntr) + 2 * n_forcings
    inverse = n_evals * inv
    if with_init:
        direct, inverse = direct + 4, inverse + 2
    return direct, inverse


def build_report() -> list:
    """Registers and spill bytes of every kernel instantiation, from what
    nvcc -Xptxas -v printed when the libraries were built."""
    import re
    bases = ("grid_dynamics_kernel", "grid_physics_kernel",
             "grid2spec_kernel", "spec2grid_kernel", "split_probe_kernel")
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


def run_window(run, state, cal, first_step: int, n_steps: int):
    """n_steps through the batched runner; returns (state, calendar after,
    wall seconds including the final synchronize)."""
    ctx, cal = M.build_step_ctx(dataclasses.replace(cal), first_step, n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, ctx)
    torch.cuda.synchronize()
    return state, cal, time.perf_counter() - t0


def device_time_per_step(run, state, cal, first_step: int, n_steps: int):
    """(milliseconds the card is busy per step, device launches per step,
    the eight device kernels that take most of that time as
    [(name, ms per step, launches per step)], and the ms per step of the
    matrix products and of the hand-written kernels) over a short
    window, from torch.profiler; (None, None, [], {}) if the profiler saw no
    device activity. The profiler slows the host, so the busy share is taken
    against the step time of an unprofiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), first_step, n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(state, ctx)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies, fills): the operator-level
    # events carry the same device time once more.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        return None, None, [], {}
    share = lambda *keys: sum(
        e.self_device_time_total for e in events
        if any(k in e.key.lower() for k in keys)) * 1e-3 / n_steps
    groups = {"matrix products": share("gemm", "cutlass", "xmma"),
              "fused transform kernels": share("grid2spec_kernel",
                                               "spec2grid_kernel"),
              "grid_physics kernel": share("grid_physics_kernel"),
              "grid_dynamics kernel": share("grid_dynamics_kernel")}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    top = [(e.key[:60], e.self_device_time_total * 1e-3 / n_steps,
            e.count / n_steps) for e in top]
    return (busy_us * 1e-3 / n_steps, sum(e.count for e in events) / n_steps,
            top, groups)


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


def main() -> None:
    t_start = time.perf_counter()
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

    # 2. build: one nvcc process per source, started together
    t0 = time.perf_counter()
    libs = ck.build_kernels()
    print(f"build: {len(libs)} kernel libraries with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs.values()))
    for row in build_report():
        print("  " + row)

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
    probes32 = check_probes(f32, 1e-5, card)
    check_probes(f64, 1e-12, card)
    bf16_out = check_bf16_outputs(f32, card)

    # 5. the dynamics-only path, at a reduced depth: initialization (two
    # bootstrap steps at B=1), then 12 steps of 128 members.
    ck.reset_launch_counts()
    tk.reset_plain_chain_calls()
    consts_d, state_d, cal_d = make_demo_model(
        T30L8, device="cuda", physics_on=False, precision="f32",
        fft_mode="matmul")
    run_d = make_run_steps_batched(consts_d, device="cuda")
    out_d, _, _ = run_window(run_d, broadcast_state(state_d, N_MEMBERS),
                             cal_d, 2, N_STEPS_DYN)
    launches_dyn = dict(ck.launch_counts)
    check_state(out_d, N_MEMBERS, "dynamics-only path")
    direct, inverse = expected_transform_launches(
        consts_d, N_STEPS_DYN + 2, 1, with_init=True)
    expected_dyn = dict.fromkeys(ck.launch_counts, 0)
    expected_dyn.update(grid_dynamics=N_STEPS_DYN + 2, fused_grid2spec=direct,
                        fused_spec2grid=inverse)
    if launches_dyn != expected_dyn or any(tk.plain_chain_calls.values()):
        raise RuntimeError(
            f"dynamics-only path: launches {launches_dyn}, expected "
            f"{expected_dyn}; plain chain calls {tk.plain_chain_calls}")
    print(f"dynamics-only path: T30L8 f32, {N_MEMBERS} members x "
          f"{N_STEPS_DYN} steps + initialization, finite, error_flag false, "
          f"grid_dynamics launches {launches_dyn['grid_dynamics']} (= steps "
          f"+ 2), fused_grid2spec {direct}, fused_spec2grid {inverse}, none "
          f"of the physics or of the plain chain; unperturbed members differ "
          f"from member 0 by {member_spread(out_d):.1e}")
    del out_d

    # 6. the main path at full width: the full-physics model (grid_phi on,
    # the default on the card). Initialization runs both bootstrap steps
    # with shortwave at B=1; then one model day of 128 members from step 2,
    # shortwave on steps 3, 6, ..., 36, the daily forcing at step 36.
    ck.reset_launch_counts()
    tk.reset_plain_chain_calls()
    consts, state1, cal = make_demo_model(T30L8, device="cuda",
                                          precision="f32", fft_mode="matmul")
    run = make_run_steps_batched(consts, device="cuda")
    state, cal_day, secs_first = run_window(
        run, broadcast_state(state1, N_MEMBERS), cal, 2, N_STEPS)
    launches = dict(ck.launch_counts)
    plain_calls = dict(tk.plain_chain_calls)
    check_state(state, N_MEMBERS, "main path")
    steps = range(2, 2 + N_STEPS)
    n_sw = 2 + sum(1 for s in steps if s % 3 == 0)
    n_forcings = 1 + sum(1 for s in steps if s % T30L8.nsteps == 0)
    direct, inverse = expected_transform_launches(
        consts, N_STEPS + 2, n_forcings, with_init=True)
    expected = dict.fromkeys(ck.launch_counts, 0)
    expected.update(grid_dynamics=N_STEPS + 2, grid_physics_sw=n_sw,
                    grid_physics_nosw=N_STEPS + 2 - n_sw,
                    fused_grid2spec=direct, fused_spec2grid=inverse)
    if launches != expected or any(plain_calls.values()):
        raise RuntimeError(f"main path launched {launches}, expected "
                           f"{expected}; plain chain calls {plain_calls}")
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
          f"{N_STEPS} steps + initialization, finite, error_flag false, "
          f"launches {launches} (grid_dynamics = steps + 2; physics 14 with "
          f"shortwave + 24 without; fused_spec2grid = 38 evaluations x 12 + "
          f"2 of the initialization; fused_grid2spec = 38 x 10 + 4 + 2 for "
          f"each of {n_forcings} forcings), plain chain calls {plain_calls}; "
          f"unperturbed members differ from member 0 by {spread:.1e}; first "
          f"window {secs_first:.3f} s")

    # The physics kernel once more, on the model's own columns after that
    # day (float32, both variants, the main path's grid_phi mode and an SPPT
    # pattern).
    check_physics(f32, N_MEMBERS, 1e-5, card, ("grid_phi", "sppt"),
                  inputs=state_physics_inputs(consts, state))

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
    print(f"member independence: B=8, member {who} perturbed by 0.05 in T, "
          f"6 steps: it differs by {diff:.3e} K (spectral), all others equal "
          f"member 0 bitwise (T and hfluxn)")

    # Throughput: a second day, everything warm.
    state, cal_day2, secs = run_window(run, state, cal_day, 2 + N_STEPS,
                                       N_STEPS)
    check_state(state, N_MEMBERS, "second day")
    dev_ms_128, launches_per_step, top_128, groups = device_time_per_step(
        run, state, cal_day2, 2 + 2 * N_STEPS, 6)
    s1 = broadcast_state(state1, 1)
    s1, cal1, _ = run_window(run, s1, cal, 2, N_STEPS)
    s1, cal1b, secs1 = run_window(run, s1, cal1, 2 + N_STEPS, N_STEPS)
    check_state(s1, 1, "B=1")
    dev_ms_1 = device_time_per_step(run, s1, cal1b, 2 + 2 * N_STEPS, 6)[0]
    per_step = ("not measured" if launches_per_step is None
                else f"{launches_per_step:.0f}")
    print(f"throughput, full physics: "
          f"{report(N_MEMBERS, N_STEPS, secs, dev_ms_128)}; "
          f"{report(1, N_STEPS, secs1, dev_ms_1)}; device launches per step "
          f"{per_step} [{card}]")
    print(f"device time by kernel, B={N_MEMBERS}, ms/step (launches/step): "
          + "; ".join(f"{name} {ms:.3f} ({n:.2f})" for name, ms, n in top_128))
    print(f"device time by group, B={N_MEMBERS}, ms/step: "
          + "; ".join(f"{k} {v:.3f}" for k, v in groups.items()))
    # The dynamics-only path beside it, warm, same depth as its first run.
    state_dd = broadcast_state(state_d, N_MEMBERS)
    state_dd, cal_dd, _ = run_window(run_d, state_dd, cal_d, 2, N_STEPS_DYN)
    _, _, secs_dd = run_window(run_d, state_dd, cal_dd, 2 + N_STEPS_DYN,
                               N_STEPS_DYN)
    print(f"throughput, dynamics only: "
          f"{report(N_MEMBERS, N_STEPS_DYN, secs_dd, None)}")
    del state_dd

    # 6b. the bf16_tendencies configuration at a reduced depth: the
    # initialization strips the flag (float32 instantiations, two bootstrap
    # steps), the runner keeps it (bfloat16 instantiations on every step).
    ck.reset_launch_counts()
    tk.reset_plain_chain_calls()
    consts_b, state_b1, cal_b = make_demo_model(
        T30L8, device="cuda", precision="f32", fft_mode="matmul",
        bf16_tendencies=True)
    run_b = make_run_steps_batched(consts_b, device="cuda")
    out_b, cal_b2, _ = run_window(run_b, broadcast_state(state_b1, N_MEMBERS),
                                  cal_b, 2, N_STEPS_BF16)
    launches_b = dict(ck.launch_counts)
    plain_b = dict(tk.plain_chain_calls)
    check_state(out_b, N_MEMBERS, "bf16_tendencies path")
    steps_b = range(2, 2 + N_STEPS_BF16)
    n_sw_b = sum(1 for s in steps_b if s % 3 == 0)
    n_forc_b = sum(1 for s in steps_b if s % T30L8.nsteps == 0)
    init_d, init_i = expected_transform_launches(consts_b, 2, 1, True)
    run_d2, run_i = expected_transform_launches(consts_b, N_STEPS_BF16,
                                                n_forc_b, False)
    expected_b = dict.fromkeys(ck.launch_counts, 0)
    expected_b.update(
        grid_dynamics=2, grid_physics_sw=2,
        grid_dynamics_bf16=N_STEPS_BF16, grid_physics_sw_bf16=n_sw_b,
        grid_physics_nosw_bf16=N_STEPS_BF16 - n_sw_b,
        fused_grid2spec=init_d + 2 * n_forc_b,
        fused_grid2spec_bf16=run_d2 - 2 * n_forc_b,
        fused_spec2grid=init_i + run_i)
    if launches_b != expected_b or any(plain_b.values()):
        raise RuntimeError(f"bf16_tendencies path launched {launches_b}, "
                           f"expected {expected_b}; plain chain {plain_b}")
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
    dev_ms_b, launches_per_step_b, _, groups_b = device_time_per_step(
        run_b, out_b, cal_b2, 2 + 2 * N_STEPS_BF16, 6)
    check_state(out_b, N_MEMBERS, "bf16_tendencies path, warm")
    rate = lambda secs: N_MEMBERS * N_STEPS_BF16 / secs
    print(f"bf16_tendencies path: T30L8 f32, {N_MEMBERS} members x "
          f"{N_STEPS_BF16} steps + initialization, finite, error_flag false, "
          f"launches {launches_b} (the bfloat16 instantiations on the "
          f"{N_STEPS_BF16} steps, the float32 ones on the two bootstrap "
          f"steps), plain chain calls {plain_b}; same initial state bitwise; "
          f"prognostics vs the float32 run after {N_STEPS_BF16} steps, rel. "
          f"to each field's largest value: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + " (bounds t, ps 1e-3; vor, div 5e-2; and more than 1e-8)")
    print(f"throughput, bf16_tendencies beside float32, {N_STEPS_BF16}-step "
          f"windows in turns: bf16 "
          + ", ".join(f"{rate(x):.1f}" for x in secs_bf)
          + " member-steps/s; float32 "
          + ", ".join(f"{rate(x):.1f}" for x in secs_ff)
          + f" member-steps/s; bf16 device busy "
          + ("not measured" if dev_ms_b is None else
             f"{dev_ms_b:.3f} ms/step, {launches_per_step_b:.0f} launches "
             f"per step; by group " + "; ".join(
                 f"{k} {v:.3f}" for k, v in groups_b.items()))
          + f" [{card}]")
    del out_b, out_f

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

    # 7. float64 end to end with physics: the card (the column kernels and
    # the fused transform kernels in float64) against the CPU (their plain
    # versions: the dense matmul chain for the transforms) from the same
    # initial state, grid_phi on in both.
    ck.reset_launch_counts()
    nmem64 = 4
    consts_c, state_c, cal_c = make_demo_model(f64, device="cpu",
                                               grid_phi=True)
    consts_g, _ = M.build_consts(f64, device="cuda", grid_phi=True)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal_c), 2, N_STEPS)
    out_c = make_run_steps_batched(consts_c, device="cpu")(
        broadcast_state(state_c, nmem64), ctx)
    out_g = make_run_steps_batched(consts_g, device="cuda")(
        broadcast_state(to_gpu(state_c), nmem64), ctx)
    torch.cuda.synchronize()
    check_state(out_g, nmem64, "f64 card run")
    launches64 = dict(ck.launch_counts)
    d64, i64 = expected_transform_launches(consts_g, N_STEPS,
                                           n_forcings - 1, False)
    if (launches64["fused_grid2spec"], launches64["fused_spec2grid"]) != (
            d64, i64) or not consts_c.sp.use_dense_legendre:
        raise RuntimeError(f"f64 card run: transform launches {launches64}, "
                           f"expected {d64} and {i64} on the dense route")
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
          f" card (kernels) vs CPU (plain): max rel err {worst64:.3e} in "
          f"{worst_name} over the prognostics and 8 physics fields (limit "
          f"1e-9); float64 transform kernels launched "
          f"{launches64['fused_grid2spec']} + {launches64['fused_spec2grid']}"
          f" times")
    if not worst64 <= 1e-9:
        raise RuntimeError("float64 card run disagrees with the CPU run")

    # 8. kernels
    def entry(name, source, replaces, n_launches, res, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": res["max_abs_err"],
                "max_rel_err": res["max_rel_err"], "ms": res["ms"],
                "call_ms": res["call_ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms"), "shape": shape}

    shape = f"T30L8 f32 B={N_MEMBERS}"
    phys_src = "pyspeedy_tpu_torch/csrc/grid_physics.cu"
    phys_repl = "pyspeedy_tpu/physics/pallas_physics.py:30"
    kernels = [entry("grid_dynamics",
                     "pyspeedy_tpu_torch/csrc/grid_dynamics.cu",
                     "pyspeedy_tpu/ops/pallas_tiling.py:56",
                     launches["grid_dynamics"], res32, shape)]
    kernels[0]["launches_dynamics_only_path"] = launches_dyn["grid_dynamics"]
    kernels[0]["launches_bf16_path"] = launches_b["grid_dynamics_bf16"]
    kernels[0].update(bf16_out["grid_dynamics"])
    for name in ("grid_physics_sw", "grid_physics_nosw"):
        kernels.append(entry(name, phys_src, phys_repl, launches[name],
                             phys32[name], shape + " grid_phi"))
        kernels[-1]["ms_f64"] = phys64[name]["ms"]
        kernels[-1]["bound_ms_f64"] = phys64[name]["bound_ms"]
        kernels[-1]["flipped_columns"] = phys32[name]["flipped_columns"]
        kernels[-1]["launches_bf16_path"] = launches_b[name + "_bf16"]
        kernels[-1].update(bf16_out[name])
    tr_src = "pyspeedy_tpu_torch/csrc/fused_transform.cu"
    rows = f"T30 f32, {N_MEMBERS * T30L8.kx} rows (B={N_MEMBERS} x kx)"
    for name, repl in (("fused_grid2spec", "tools/exp_fused_transform.py:65"),
                       ("fused_spec2grid", "tools/exp_fused_transform.py:121")):
        kernels.append(entry(name, tr_src, repl, launches[name], tr32[name],
                             rows))
        kernels[-1]["fft_route_ms"] = tr32[name]["fft_route_ms"]
        kernels[-1]["launches_dynamics_only_path"] = launches_dyn[name]
        for key in ("ms", "call_ms", "plain_ms", "bound_ms", "max_rel_err",
                    "fft_route_ms"):
            kernels[-1][key + "_f64"] = tr64[name][key]
    kernels[-2]["launches_bf16_path"] = launches_b["fused_grid2spec_bf16"]
    kernels[-2].update(tr_bf16)
    # The probes are not on the model's path: their launches are those of
    # the probe path above; the entry's times and bound are those of p2, the
    # whole chain for one part, and every stage carries its own.
    stage2 = probes32[2]
    kernels.append({
        "name": "fused_probe", "route": "cuda", "source": tr_src,
        "replaces": "tools/exp_fused_probe.py:49",
        "launches": launches_probe["fused_probe"],
        "launches_on": "the probe path (the model's steps do not run it)",
        "max_abs_err": max(x["max_abs_err"] for x in probes32),
        "max_rel_err": max(x["max_rel_err"] for x in probes32),
        "ms": stage2["ms"], "call_ms": stage2["call_ms"],
        "plain_ms": stage2["plain_ms"], "bound_ms": stage2["bound_ms"],
        "bound_by": stage2["bound_by"], "library_ms": stage2["library_ms"],
        "shape": f"T30 f32, {N_PROBE_ROWS} rows, p2", "stages": probes32})
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
