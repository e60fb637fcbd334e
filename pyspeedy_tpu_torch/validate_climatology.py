"""Full-physics 1-year climatology check of the PyTorch port.

Runs 13 months (the first discarded as spin-up), takes monthly means of the
surface temperature, the precipitation and the net top-of-atmosphere
radiation, and checks them against broad climatological ranges. Prints the
card's name and power limit (or the CPU), the wall time of each phase, then
a JSON report; exits 0 when every check passes, 1 otherwise.

    python -m pyspeedy_tpu_torch.validate_climatology [--months N] [--f32]
        [--preset T30|T47|T63] [--bc bundled|synthetic] [--device cuda|cpu]
        [--bf16-tendencies]

Every preset runs from the bundled boundary conditions through the public
``Speedy`` API (``--bc bundled``, the default): at T47 and T63 ``set_bc``
remaps the bundled T30 fields onto the model's grid
(``coupling/remap.py``). ``--bc synthetic`` runs T47L8 or T63L8 from the
synthetic boundary conditions (``testing.synthetic_host_bc``: an idealised
continent and a zonal SST) through the model-level API, the batched runner
at B=1. Without ``--f32`` the run is float64 on either device.
``--device`` defaults to "cuda" and raises without a card.
``--bf16-tendencies`` runs the steps after the initialization with bfloat16
tendencies (``Speedy(..., bf16_tendencies=True)``, ``make_demo_model(...,
bf16_tendencies=True)`` on the synthetic route; either precision, see
``models.model.build_consts``). On the card the runs replay the batched
runner's CUDA graphs of the step, on the CPU they take its eager loop
(``parallel.ensemble.takes_graphs``); the printed line names the mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from datetime import datetime, timedelta

import numpy as np

from .utils.profiling import PhaseTimer

__all__ = ["DAYS_PER_MONTH", "run_bundled", "run_synthetic",
           "climate_report", "main"]

# Model days of a "month" of the check.
DAYS_PER_MONTH = 30


def run_bundled(params, months, device="cuda", bf16_tendencies=False,
                timer=None):
    """Monthly means (tsfc K, precip mm/day, TOA net W/m2) of months 2..N
    through the Speedy API from the bundled boundary conditions (remapped
    by set_bc onto a grid other than T30's)."""
    from .speedy import Speedy

    timer = timer or PhaseTimer()
    with timer.phase("set_bc"):
        model = Speedy(start_date=datetime(1981, 12, 1),
                       end_date=datetime(1983, 6, 1), params=params,
                       device=device, bf16_tendencies=bf16_tendencies)
        model.set_bc()

    tsfc, prec, toa = [], [], []
    for m in range(months):
        with timer.phase("months"):
            model._advance(DAYS_PER_MONTH * params.nsteps)
            model._raise_if_failed()
        if m == 0:
            continue  # spinup
        with timer.phase("monthly means"):
            model.spectral2grid()
            w = np.cos(np.deg2rad(model["lat"]))[None, :, None]
            wsum = w.sum() * params.ix
            t_sfc = model["t_grid"][:, :, -1].T[None]  # (1, lat, lon)
            tsfc.append(float((t_sfc * w).sum() / wsum))
            p = (model["precnv"] + model["precls"]).T[None]
            prec.append(float((p * w).sum() / wsum) * 86.4)  # mm/day
            net = (model["tsr"] - model["olr"]).T[None]
            toa.append(float((net * w).sum() / wsum))
    return tsfc, prec, toa


def run_synthetic(params, months, device="cuda", bf16_tendencies=False,
                  timer=None):
    """Model-level monthly loop from synthetic boundary conditions (the
    T47/T63 path): the batched runner at B=1. The SST anomaly record covers
    the calendar months the run reaches (the JAX package's three slabs are
    read past their end there, where JAX clamps the index to the last
    slab; all are zero)."""
    from .models import model as M
    from .models import prognostics as prog
    from .parallel.ensemble import broadcast_state, make_run_steps_batched
    from .testing import DEMO_START, make_demo_model

    timer = timer or PhaseTimer()
    end = DEMO_START + timedelta(days=months * DAYS_PER_MONTH)
    n_months = ((end.year - DEMO_START.year) * 12 + end.month
                - DEMO_START.month + 1)
    with timer.phase("init"):
        consts, state1, cal = make_demo_model(
            params, device=device, bf16_tendencies=bf16_tendencies,
            n_months=n_months)
        run = make_run_steps_batched(consts, device=device)
        state = broadcast_state(state1, 1)

    n_month = DAYS_PER_MONTH * params.nsteps
    stepno = 2
    w = np.cos(np.asarray(consts.geom.radang, dtype=np.float64))[:, None]
    wsum = w.sum() * params.ix
    host = lambda x: x[0].double().cpu().numpy()

    tsfc, prec, toa = [], [], []
    for m in range(months):
        with timer.phase("months"):
            ctx, cal = M.build_step_ctx(cal, stepno, n_month)
            state = run(state, ctx)
            stepno += n_month
            if bool(state["error_flag"].any()):
                raise RuntimeError(f"diagnostics tripped in month {m}")
        if m == 0:
            continue
        with timer.phase("monthly means"):
            st = prog.spectral2grid(consts, state, pdim=1)
            t_sfc = host(st["t_grid"])[-1]                 # (il, ix)
            tsfc.append(float((t_sfc * w).sum() / wsum))
            p = host(state["precnv"]) + host(state["precls"])
            prec.append(float((p * w).sum() / wsum) * 86.4)
            net = host(state["tsr"]) - host(state["olr"])
            toa.append(float((net * w).sum() / wsum))
    return tsfc, prec, toa


def climate_report(preset, tsfc, prec, toa) -> dict:
    """The JSON report: means and range of the monthly means, the three
    plausibility checks and their conjunction."""
    report = {
        "preset": preset,
        "months_used": len(tsfc),
        "tsfc_mean_K": round(float(np.mean(tsfc)), 2),
        "tsfc_range_K": [round(min(tsfc), 2), round(max(tsfc), 2)],
        "precip_mean_mm_day": round(float(np.mean(prec)), 3),
        "toa_net_W_m2": round(float(np.mean(toa)), 2),
    }
    checks = {
        "tsfc_plausible": 270.0 < report["tsfc_mean_K"] < 295.0,
        "precip_plausible": 1.0 < report["precip_mean_mm_day"] < 6.0,
        "toa_balance": abs(report["toa_net_W_m2"]) < 40.0,
    }
    report["checks"] = checks
    report["ok"] = all(checks.values())
    return report


def _device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--months", type=int, default=13)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--preset", default="T30",
                    choices=("T30", "T47", "T63"))
    ap.add_argument("--bc", default="bundled",
                    choices=("bundled", "synthetic"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bf16-tendencies", action="store_true")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .parallel.ensemble import takes_graphs
    from .params import T30L8, T47L8, T63L8

    device = resolve_device(args.device)
    params = {"T30": T30L8, "T47": T47L8, "T63": T63L8}[args.preset]
    if args.f32:
        params = dataclasses.replace(params, precision="f32",
                                     fft_mode="matmul")

    if args.bc == "synthetic" and args.preset == "T30":
        ap.error("--bc synthetic is the T47 / T63 route")
    timer = PhaseTimer()
    run = run_bundled if args.bc == "bundled" else run_synthetic
    with timer.phase("total"):
        tsfc, prec, toa = run(params, args.months, device=device,
                              bf16_tendencies=args.bf16_tendencies,
                              timer=timer)

    report = climate_report(args.preset, tsfc, prec, toa)
    print(f"device: {_device_line(device)}; {params.precision}, "
          f"{args.bc} boundary conditions, "
          f"bf16_tendencies={args.bf16_tendencies}, {args.months} months of "
          f"{DAYS_PER_MONTH} days at {params.nsteps} steps a day; the "
          f"batched runner's "
          + ("CUDA graphs" if takes_graphs(device) else "eager loop"))
    print(timer.report())
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
