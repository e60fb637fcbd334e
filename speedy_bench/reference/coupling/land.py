"""Slab land-surface model (reference: speedy.f90/land_model.f90).

land_model_init runs host-side (numpy) at initialization and produces
constant fields; couple_land_atm runs on tensors inside the step (it is
called every step in the reference, speedy.f90:72). Fields the step carries
(stl_lm, land_temp) may have a leading member axis; the climatologies and the
surface fluxes read here (hfluxn: (3, il, ix) shared by all members while the
physics is off, (B, 3, il, ix) once it writes them) are indexed from the
right, so the same code serves both."""

from __future__ import annotations

import numpy as np
import torch

from .boundaries import check_surface_fields, fill_missing_values
from .interpolation import shared_plane

__all__ = ["land_model_init", "couple_land_atm", "SNOW_DEPTH2COVER"]

SNOW_DEPTH2COVER = 60.0  # mm water equivalent for full snow cover


def land_model_init(params, host):
    """Masks, soil-water availability and slab heat capacities
    (land_model.f90:18-148). `host` is a dict of numpy BC fields; returns a
    dict of derived constant fields (numpy)."""
    delt = params.delt
    swcap, swwil, thrsh = 0.30, 0.17, 0.1

    fmask_orig = host["fmask_orig"]
    fmask_land = fmask_orig.copy()
    bmask_land = np.where(fmask_land >= thrsh, 1.0, 0.0)
    fmask_land = np.where(fmask_land >= thrsh,
                          np.where(fmask_orig > 1.0 - thrsh, 1.0, fmask_land),
                          0.0)

    stl12 = np.stack([fill_missing_values(host["stl12"][m], 0.0)
                      for m in range(12)])
    stl12, _ = check_surface_fields(bmask_land, 0.0, 400.0, 273.0, stl12)
    snowd12, _ = check_surface_fields(bmask_land, 0.0, 20000.0, 0.0,
                                      host["snowd12"])

    veg = np.maximum(0.0, host["veg_high"] + 0.8 * host["veg_low"])
    idep2 = 3
    swwil2 = idep2 * swwil
    rsw = 1.0 / (swcap + idep2 * (swcap - swwil))

    swroot = idep2 * host["soil_wc_l2"]
    soilw12 = np.minimum(
        1.0, rsw * (host["soil_wc_l1"]
                    + veg[None] * np.maximum(0.0, swroot - swwil2)))
    soilw12, _ = check_surface_fields(bmask_land, 0.0, 10.0, 0.0, soilw12)

    # Heat capacities and dissipation (land_model.f90:104-147)
    depth_soil, depth_lice, tdland, flandmin = 1.0, 5.0, 40.0, 1.0 / 3.0
    hcapl = depth_soil * 2.50e6
    hcapli = depth_lice * 1.93e6

    dmask = np.where(fmask_land < flandmin, 0.0, 1.0)
    rhcapl = np.where(host["alb0"] < 0.4, delt / hcapl, delt / hcapli)
    cdland = dmask * tdland / (1.0 + dmask * tdland)

    return {
        "fmask_land": fmask_land,
        "bmask_land": bmask_land,
        "stl12": stl12,
        "snowd12": snowd12,
        "soilw12": soilw12,
        "rhcapl": rhcapl,
        "cdland": cdland,
    }


def couple_land_atm(consts, state, day0: bool, tables, out=None):
    """Interpolate climatologies to the date and advance the slab land model
    (land_model.f90:151-216). day0=True only during initialization.
    `tables` (interpolation.CouplerTables) holds the date's month rows and
    weights on the device. With `out` (the state's own tensors by field)
    the slab model writes stl_lm and land_temp into them, and the
    interpolations go into the planes it gives (coupler.py)."""
    into = lambda name: None if out is None else out[name]
    plane = lambda name: None if out is None else shared_plane(out[name])
    state = dict(state)
    stlcl = tables.forin5(state["stl12"], plane("stlcl_obs"))
    snowdcl = tables.forint(state["snowd12"], plane("snowdcl_obs"))
    soilwcl = tables.forint(state["soilw12"], plane("soilwcl_obs"))
    state["stlcl_obs"] = stlcl
    state["snowdcl_obs"] = snowdcl
    state["soilwcl_obs"] = soilwcl

    if day0:
        state["stl_lm"] = stlcl
        state["land_temp"] = stlcl
    else:
        # slab land model (land_model.f90:195-216), applied only where the
        # runtime land_coupling_flag state scalar is set (land_model.f90:179;
        # off -> land_temp from climatology, stl_lm untouched).
        tanom = state["stl_lm"] - stlcl
        tanom = state["cdland"] * (
            tanom + state["rhcapl"] * state["hfluxn"][..., 0, :, :])
        stl_lm_new = tanom + stlcl
        flag = state["land_coupling_flag"]
        state["stl_lm"] = torch.where(flag, stl_lm_new, state["stl_lm"],
                                      out=into("stl_lm"))
        state["land_temp"] = torch.where(flag, stl_lm_new, stlcl,
                                         out=into("land_temp"))

    state["snow_depth"] = snowdcl
    state["soil_avail_water"] = soilwcl
    return state
