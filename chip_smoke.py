#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``pyspeedy_tpu_torch/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card at the shapes the
model gives it, drives the port's paths through the public entry points (the
member-batched dynamics-only T30L8 model at a reduced depth, then the main
path: the full-physics T30L8 model, initialization and one model day of 128
members), checks the results, and prints what it measured. It needs a CUDA
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
from pyspeedy_tpu_torch.parallel.ensemble import (broadcast_state,
                                                   make_run_steps_batched)
from pyspeedy_tpu_torch.params import T30L5, T30L8
from pyspeedy_tpu_torch.physics import driver as PD
from pyspeedy_tpu_torch.testing import make_demo_model

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 / float64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

N_MEMBERS = 128
N_STEPS = 36            # one model day at T30
N_STEPS_DYN = 12        # depth of the dynamics-only path
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


def build_report() -> list:
    """Registers and spill bytes of every kernel instantiation, from what
    nvcc -Xptxas -v printed when the libraries were built."""
    import re
    rows = []
    for name, log in ck.build_logs.items():
        lines = log.splitlines()
        for n, line in enumerate(lines):
            m = re.search(r"Function properties for \S*?kernelI([df])Li(\d)"
                          r"(?:ELb([01]))?", line)
            if not m:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", lines[n + 1])
            regs = re.search(r"Used (\d+) registers", lines[n + 2])
            variant = {"1": " sw", "0": " nosw", None: ""}[m.group(3)]
            rows.append(
                f"{name} {'f64' if m.group(1) == 'd' else 'f32'} "
                f"kx={m.group(2)}{variant}: {regs.group(1)} registers, spill "
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
    matrix products and of the two hand-written kernels) over a short
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

    # 5. the dynamics-only path, at a reduced depth: initialization (two
    # bootstrap steps at B=1), then 12 steps of 128 members.
    ck.reset_launch_counts()
    consts_d, state_d, cal_d = make_demo_model(
        T30L8, device="cuda", physics_on=False, precision="f32",
        fft_mode="matmul")
    run_d = make_run_steps_batched(consts_d, device="cuda")
    out_d, _, _ = run_window(run_d, broadcast_state(state_d, N_MEMBERS),
                             cal_d, 2, N_STEPS_DYN)
    launches_dyn = dict(ck.launch_counts)
    check_state(out_d, N_MEMBERS, "dynamics-only path")
    if (launches_dyn["grid_dynamics"] != N_STEPS_DYN + 2
            or launches_dyn["grid_physics_sw"]
            or launches_dyn["grid_physics_nosw"]):
        raise RuntimeError(
            f"dynamics-only path: launches {launches_dyn}, expected "
            f"{N_STEPS_DYN + 2} of grid_dynamics and none of the physics")
    print(f"dynamics-only path: T30L8 f32, {N_MEMBERS} members x "
          f"{N_STEPS_DYN} steps + initialization, finite, error_flag false, "
          f"grid_dynamics launches {launches_dyn['grid_dynamics']} (= steps "
          f"+ 2), unperturbed members differ from member 0 by "
          f"{member_spread(out_d):.1e}")
    del out_d

    # 6. the main path at full width: the full-physics model (grid_phi on,
    # the default on the card). Initialization runs both bootstrap steps
    # with shortwave at B=1; then one model day of 128 members from step 2,
    # shortwave on steps 3, 6, ..., 36, the daily forcing at step 36.
    ck.reset_launch_counts()
    consts, state1, cal = make_demo_model(T30L8, device="cuda",
                                          precision="f32", fft_mode="matmul")
    run = make_run_steps_batched(consts, device="cuda")
    state, cal_day, secs_first = run_window(
        run, broadcast_state(state1, N_MEMBERS), cal, 2, N_STEPS)
    launches = dict(ck.launch_counts)
    check_state(state, N_MEMBERS, "main path")
    n_sw = 2 + sum(1 for s in range(2, 2 + N_STEPS) if s % 3 == 0)
    expected = {"grid_dynamics": N_STEPS + 2, "grid_physics_sw": n_sw,
                "grid_physics_nosw": N_STEPS + 2 - n_sw}
    if launches != expected:
        raise RuntimeError(f"main path launched {launches}, expected "
                           f"{expected}")
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
          f"shortwave + 24 without), unperturbed members differ from member "
          f"0 by {spread:.1e}; first window {secs_first:.3f} s")

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

    # 7. float64 end to end with physics: the card (kernels) against the CPU
    # (plain versions) from the same initial state, grid_phi on in both.
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
          f"1e-9)")
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
                "library_ms": None, "shape": shape}

    shape = f"T30L8 f32 B={N_MEMBERS}"
    phys_src = "pyspeedy_tpu_torch/csrc/grid_physics.cu"
    phys_repl = "pyspeedy_tpu/physics/pallas_physics.py:30"
    kernels = [entry("grid_dynamics",
                     "pyspeedy_tpu_torch/csrc/grid_dynamics.cu",
                     "pyspeedy_tpu/ops/pallas_tiling.py:56",
                     launches["grid_dynamics"], res32, shape)]
    kernels[0]["launches_dynamics_only_path"] = launches_dyn["grid_dynamics"]
    for name in ("grid_physics_sw", "grid_physics_nosw"):
        kernels.append(entry(name, phys_src, phys_repl, launches[name],
                             phys32[name], shape + " grid_phi"))
        kernels[-1]["ms_f64"] = phys64[name]["ms"]
        kernels[-1]["bound_ms_f64"] = phys64[name]["bound_ms"]
        kernels[-1]["flipped_columns"] = phys32[name]["flipped_columns"]
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
