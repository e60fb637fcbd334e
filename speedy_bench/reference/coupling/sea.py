"""Slab ocean / sea-ice model (reference: speedy.f90/sea_model.f90).

sea_model_init runs host-side at initialization; couple_sea_atm runs on
tensors inside the step. Coupling configuration matches the reference's
supported modes: sea_coupling_flag = 0 (prescribed SST), ice_coupling_flag = 1.
Fields the step carries may have a leading member axis; climatologies and,
with physics off, the surface fluxes (shf, evap, hfluxn: (3, il, ix)) are
shared by all members and broadcast; the physics writes them member-batched,
(B, 3, il, ix). Their land/sea/average axis is indexed from the right, so the
same code serves both.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as pc
from .boundaries import check_surface_fields, fill_missing_values
from .interpolation import shared_plane

__all__ = ["sea_model_init", "couple_sea_atm"]

BETA = 1.0          # heat-flux coefficient at the sea/ice interface
SSTFR = 273.2 - 1.8  # freezing-point SST


def sea_domain(cdomain, deglat_s, ix):
    """Regional ocean-domain masks (sea_model.f90:386-463): weights in [0,1]
    per grid point for the named domain. Domains: northe, natlan, npacif,
    tropic, indian, elnino."""
    il = deglat_s.shape[0]
    dmask = np.zeros((il, ix))
    rlon = 360.0 / ix * np.arange(ix)[None, :]
    lat = deglat_s[:, None]

    if cdomain == "northe":
        dmask[:] = np.where(lat > 20.0, 1.0, 0.0)
    elif cdomain == "natlan":
        dmask[:] = np.where((lat > 20.0) & (lat < 80.0)
                            & ((rlon < 45.0) | (rlon > 260.0)), 1.0, 0.0)
    elif cdomain == "npacif":
        dmask[:] = np.where((lat > 20.0) & (lat < 65.0)
                            & (rlon > 120.0) & (rlon < 260.0), 1.0, 0.0)
    elif cdomain == "tropic":
        dmask[:] = np.where((lat > -30.0) & (lat < 30.0), 1.0, 0.0)
    elif cdomain == "indian":
        dmask[:] = np.where((lat > -30.0) & (lat < 30.0)
                            & (rlon > 30.0) & (rlon < 120.0), 1.0, 0.0)
    elif cdomain == "elnino":
        arlat = np.abs(lat)
        wlat = np.where(arlat > 15.0, (0.1 * (25.0 - arlat)) ** 2, 1.0)
        wlat = np.where(arlat < 25.0, wlat, 0.0)
        rlonw = 300.0 - 2.0 * np.maximum(lat, 0.0)
        inner = (rlon > 165.0) & (rlon < rlonw)
        ramp = (rlon > 155.0) & (rlon <= 165.0)
        dmask[:] = np.where(inner, wlat,
                            np.where(ramp, wlat * 0.1 * (rlon - 155.0), 0.0))
    else:
        raise ValueError(f"unknown sea domain {cdomain!r}")
    return dmask


def sea_model_init(params, host, radang):
    """Masks, heat capacities, dissipation fields (sea_model.f90:33-191)."""
    delt = params.delt
    il = params.il
    thrsh = 0.1
    depth_ml, dept0_ml = 60.0, 40.0
    depth_ice, dept0_ice = 2.5, 1.5
    tdsst, tdice, fseamin = 90.0, 30.0, 1.0 / 3.0

    fmask_sea = 1.0 - host["fmask_orig"]
    bmask_sea = np.where(fmask_sea >= thrsh, 1.0, 0.0)
    fmask_sea = np.where(fmask_sea >= thrsh,
                         np.where(fmask_sea > 1.0 - thrsh, 1.0, fmask_sea),
                         0.0)

    deglat_s = radang * 90.0 / np.arcsin(1.0)

    sst12 = np.stack([fill_missing_values(host["sst12"][m], 0.0)
                      for m in range(12)])
    sst12, _ = check_surface_fields(bmask_sea, 100.0, 400.0, 273.0, sst12)

    sice12 = np.maximum(host["sea_ice_frac12"], 0.0)
    sice12, _ = check_surface_fields(bmask_sea, 0.0, 1.0, 0.0, sice12)

    sst_anom, _ = check_surface_fields(bmask_sea, -50.0, 50.0, 0.0,
                                       host["sst_anom"])

    hfseacl = np.zeros_like(fmask_sea)

    crad = np.arcsin(1.0) / 90.0
    coslat = np.cos(crad * deglat_s)
    hcaps = 4.18e6 * (depth_ml + (dept0_ml - depth_ml) * coslat**3)
    hcapi = 1.93e6 * (depth_ice + (dept0_ice - depth_ice) * coslat**2)

    # Global domain, smoothed latitudinal boundaries, land blanking
    # (sea_model.f90:157-188).
    dmask = np.ones_like(fmask_sea)
    sm = dmask.copy()
    sm[1:il - 1] = 0.25 * (dmask[0:il - 2] + 2 * dmask[1:il - 1] + dmask[2:il])
    dmask[1:il - 1] = sm[1:il - 1]
    dmask = np.where(fmask_sea < fseamin, 0.0, dmask)

    rhcaps = delt / hcaps[:, None] * np.ones_like(fmask_sea)
    rhcapi = delt / hcapi[:, None] * np.ones_like(fmask_sea)
    cdsea = dmask * tdsst / (1.0 + dmask * tdsst)
    cdice = dmask * tdice / (1.0 + dmask * tdice)

    return {
        "fmask_sea": fmask_sea,
        "bmask_sea": bmask_sea,
        "deglat_s": deglat_s,
        "sst12": sst12,
        "sea_ice_frac12": sice12,
        "sst_anom": sst_anom,
        "hfseacl": hfseacl,
        "rhcaps": rhcaps,
        "rhcapi": rhcapi,
        "cdsea": cdsea,
        "cdice": cdice,
    }


def _run_sea_model(consts, state, into):
    """Slab mixed-layer ocean + sea-ice integration (sea_model.f90:313-383);
    into(name) is the tensor to write field `name` into, or None."""
    ssrd = state["ssrd"]
    sea = lambda flux: flux[..., 1, :, :]    # the sea row of (..., 3, il, ix)

    difice = ((pc.ALBSEA - pc.ALBICE) * ssrd
              + pc.EMISFC * pc.SBC * (SSTFR**4 - state["tice_am"] ** 4)
              + sea(state["shf"]) + sea(state["evap"]) * pc.ALHC)
    hflux_i = sea(state["hfluxn"]) + difice * (1.0 - state["sice_am"])
    hflux = (sea(state["hfluxn"]) - state["hfseacl"]
             - state["sicecl_ob"] * (hflux_i + BETA * (SSTFR - state["tice_om"])))

    tanom = state["sst_om"] - state["sstcl_ob"]
    tanom = state["cdsea"] * (tanom + state["rhcaps"] * hflux)
    sst_om = torch.add(tanom, state["sstcl_ob"], out=into("sst_om"))

    hflux = hflux_i + BETA * (SSTFR - state["tice_om"])
    tanom = state["tice_om"] - state["ticecl_ob"]
    anom0 = 20.0
    cdis = state["cdice"] * (anom0 / (anom0 + torch.abs(tanom)))
    tanom = cdis * (tanom + state["rhcapi"] * hflux)
    tice_om = torch.add(tanom, state["ticecl_ob"], out=into("tice_om"))

    state = dict(state)
    state["sst_om"] = sst_om
    state["tice_om"] = tice_om
    state["sice_om"] = state["sicecl_ob"]
    return state


def couple_sea_atm(consts, state, day0: bool, tables, out=None):
    """Interpolate SST/ice climatology, adjust over sea ice, advance the slab
    ocean, and compose the atmosphere-side SST fields
    (sea_model.f90:193-310). `tables` (interpolation.CouplerTables) holds
    the date's month rows and weights on the device. With `out` (the
    state's own tensors by field) the member-batched fields are written
    into them: sstan_ob, the slab model's sst_om and tice_om, sstan_am,
    sst_am and ssti_om; sstcl_ob, sicecl_ob and ticecl_ob into the planes
    it gives (coupler.py)."""
    into = lambda name: None if out is None else out[name]
    plane = lambda name: None if out is None else shared_plane(out[name])
    state = dict(state)

    sstcl = tables.forin5(state["sst12"])
    sicecl = tables.forint(state["sea_ice_frac12"])

    # sst_anomaly_coupling_flag is a runtime state scalar
    # (sea_model.f90:218-222); off -> sstan_ob keeps its (zero) value.
    ssta_flag = state["sst_anomaly_coupling_flag"]
    state["sstan_ob"] = torch.where(
        ssta_flag, tables.sst_anom(state["sst_anom"]),
        state["sstan_ob"], out=into("sstan_ob"))

    # Freezing-point adjustment over sea ice (sea_model.f90:232-252)
    warm = sstcl > SSTFR
    sicecl_w = torch.clamp(sicecl, max=0.5)
    sstcl_w = torch.where(sicecl_w > 0.0,
                        SSTFR + (sstcl - SSTFR) / (1.0 - sicecl_w), sstcl)
    ticecl_w = torch.full_like(sstcl, SSTFR)

    sicecl_c = torch.clamp(sicecl, min=0.5)
    ticecl_c = SSTFR + (sstcl - SSTFR) / sicecl_c
    sstcl_c = torch.full_like(sstcl, SSTFR)

    state["sicecl_ob"] = torch.where(warm, sicecl_w, sicecl_c,
                                     out=plane("sicecl_ob"))
    state["ticecl_ob"] = torch.where(warm, ticecl_w, ticecl_c,
                                     out=plane("ticecl_ob"))
    state["sstcl_ob"] = torch.where(warm, sstcl_w, sstcl_c,
                                    out=plane("sstcl_ob"))

    if day0:
        state["sst_om"] = torch.zeros_like(sstcl)  # sea_coupling_flag <= 0
        state["tice_om"] = state["ticecl_ob"]
        state["sice_om"] = state["sicecl_ob"]
        state["wsst_ob"] = torch.zeros_like(sstcl)
    else:
        # ice_coupling_flag > 0 -> run the slab model every call
        state = _run_sea_model(consts, state, into)

    # Compose atmosphere-side fields (sea_model.f90:274-309)
    state["sstan_am"] = torch.where(ssta_flag, state["sstan_ob"],
                                    torch.zeros_like(sstcl),
                                    out=into("sstan_am"))
    sst_am = state["sstcl_ob"] + state["sstan_am"]

    # ice_coupling_flag = 1: use model ice
    state["sice_am"] = state["sice_om"]
    state["tice_am"] = state["tice_om"]

    state["sst_am"] = torch.add(
        sst_am, state["sice_am"] * (state["tice_am"] - sst_am),
        out=into("sst_am"))
    state["ssti_om"] = torch.add(
        state["sst_om"], state["sice_am"] * (state["tice_am"]
                                             - state["sst_om"]),
        out=into("ssti_om"))
    return state
