"""Synthetic boundary conditions and demo states for tests, smoke runs and
benchmarks: a self-contained initialization path that needs no data files."""

from __future__ import annotations

import dataclasses
from datetime import datetime

import numpy as np

from .models import model as M
from .params import ModelParams, T30L8
from .utils.calendar import ModelCalendar

__all__ = ["synthetic_host_bc", "make_demo_model"]


def synthetic_host_bc(params: ModelParams, geom_np) -> dict:
    """Physically plausible synthetic BCs: an idealized continent, zonal SST
    profile, moderate albedo and soil moisture."""
    il, ix = params.il, params.ix
    lat = geom_np.radang[:, None] * np.ones((il, ix))
    lon = (2 * np.pi / ix) * np.arange(ix)[None, :] * np.ones((il, ix))

    # Idealized mid-latitude continent with a smooth 1500 m mountain.
    land = (np.cos(lat * 2) > 0.3) & (np.cos(lon - 1.0) > 0.2)
    fmask = np.where(land, 1.0, 0.0)
    orog = 1500.0 * np.exp(-((lat - 0.7) ** 2 + (np.cos(lon) - 0.5) ** 2)
                           / 0.2) * fmask

    sst = 300.0 - 30.0 * np.sin(lat) ** 2
    stl = sst - 2.0
    snowd = np.where(np.abs(lat) > 1.1, 5000.0, 0.0) * fmask
    icec = np.where(np.abs(lat) > 1.2, 0.8, 0.0)

    monthly = lambda f: np.repeat(f[None], 12, axis=0)
    return {
        "orog": orog,
        "fmask_orig": fmask,
        "alb0": 0.1 + 0.2 * fmask,
        "veg_high": 0.3 * fmask,
        "veg_low": 0.4 * fmask,
        "stl12": monthly(stl),
        "snowd12": monthly(snowd),
        "soil_wc_l1": monthly(0.2 * fmask),
        "soil_wc_l2": monthly(0.2 * fmask),
        "soil_wc_l3": monthly(0.2 * fmask),
        "sst12": monthly(sst),
        "sea_ice_frac12": monthly(icec),
        "sst_anom": np.zeros((3, il, ix)),
    }


def make_demo_model(params: ModelParams = T30L8, device="cuda",
                    physics_on: bool = True,
                    grid_phi: bool | None = None,
                    bf16_tendencies: bool = False, **overrides):
    """(consts, state, calendar) fully initialized from synthetic BCs, the
    single-member state on `device`. physics_on, grid_phi and
    bf16_tendencies go to build_consts; `overrides` replace fields of
    `params` (precision="f32", fft_mode="matmul", ...)."""
    if overrides:
        params = dataclasses.replace(params, **overrides)
    consts, geom_np = M.build_consts(params, device=device,
                                     physics_on=physics_on,
                                     grid_phi=grid_phi,
                                     bf16_tendencies=bf16_tendencies)
    host_bc = synthetic_host_bc(params, geom_np)
    host_bc["_geom_np"] = geom_np
    state = M.allocate_state(params, n_months=1, device=device)
    cal = ModelCalendar.from_datetime(datetime(1982, 1, 1),
                                      nsteps=params.nsteps)
    state = M.initialize(consts, state, host_bc, cal)
    return consts, state, cal
