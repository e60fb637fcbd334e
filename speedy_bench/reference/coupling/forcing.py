"""Daily time-dependent forcing fields (reference: speedy.f90/forcing.f90):
seasonal radiative forcing, surface albedos, CO2 trend, and the orographic
temperature/humidity corrections for horizontal diffusion."""

from __future__ import annotations

import math

import torch

from .. import constants as pc
from ..ops import spectral as S
from ..physics.humidity import get_qsat
from ..physics.shortwave_radiation import get_zonal_average_fields
from .land import SNOW_DEPTH2COVER

__all__ = ["set_forcing", "FORCING_FIELDS"]

# The fields set_forcing writes.
FORCING_FIELDS = frozenset({
    "flux_solar_in", "flux_ozone_upper", "flux_ozone_lower",
    "zenit_correction", "stratospheric_correction", "snowc", "alb_land",
    "alb_sea", "alb_surface", "air_absortivity_co2", "tcorh", "qcorh"})

_IYEAR_REF = 1950
_DEL_CO2 = 0.005


def set_forcing(consts, state, year_frac: float, tyear: float):
    """Daily forcing update (forcing.f90:15-102, imode=1 path; the imode=0
    one-time pieces radset, forog and ablco2_ref are set at initialization)
    of the member-batched state: the fields it writes have a leading member
    axis, as the ones it reads from the coupler (sice_am, land_temp, sst_am).

    year_frac = year + tyear for the CO2 trend; tyear the fraction of the
    year; both Python floats from the host calendar. Returns the updated
    state."""
    sp = consts.sp
    state = dict(state)
    ones = torch.ones_like(state["sice_am"])          # (B, il, ix)
    nmem = ones.shape[0]

    zonal = torch.from_numpy(get_zonal_average_fields(consts.geom, tyear))
    fsol, ozupp, ozone, zenit, stratz = zonal.to(ones.device)
    state["flux_solar_in"] = fsol * ones
    state["flux_ozone_upper"] = ozupp * ones
    state["flux_ozone_lower"] = ozone * ones
    state["zenit_correction"] = zenit * ones
    state["stratospheric_correction"] = stratz * ones

    # Surface albedos (forcing.f90:56-65)
    snowc = torch.clamp(state["snow_depth"] / SNOW_DEPTH2COVER, max=1.0)
    alb_land = state["alb0"] + snowc * (pc.ALBSN - state["alb0"])
    alb_sea = pc.ALBSEA + state["sice_am"] * (pc.ALBICE - pc.ALBSEA)
    state["snowc"] = snowc
    state["alb_land"] = alb_land
    state["alb_sea"] = alb_sea
    state["alb_surface"] = alb_sea + state["fmask_land"] * (alb_land - alb_sea)

    # CO2 absorptivity trend (forcing.f90:67-74). `increase_co2` is a
    # runtime-settable state scalar in the reference
    # (registry/model_state_def.py:305-311): it stays a 0-d device tensor and
    # is consumed with torch.where, never read back to the host.
    trend = state["ablco2_ref"] * math.exp(_DEL_CO2 * (year_frac - _IYEAR_REF))
    state["air_absortivity_co2"] = torch.where(
        state["increase_co2"], trend, state["air_absortivity_co2"])

    # Orographic T/q corrections for horizontal diffusion (forcing.f90:76-101)
    gamlat = pc.GAMMA / (1000.0 * pc.GRAV)
    corh = gamlat * state["phis0"]                    # (il, ix), shared
    tcorh = S.grid2spec_p(sp, corh)                   # (2, mx, nx)
    state["tcorh"] = tcorh.expand(nmem, *tcorh.shape)

    pexp = 1.0 / (pc.RGAS * gamlat)
    tsfc = (state["fmask_land"] * state["land_temp"]
            + state["fmask_sea"] * state["sst_am"])
    tref = tsfc + corh
    psfc = (tsfc / tref) ** pexp

    qref = get_qsat(tref, torch.ones_like(psfc), -1.0)
    qsfc = get_qsat(tsfc, psfc, 1.0)
    corh = pc.REFRH1 * (qref - qsfc)
    state["qcorh"] = S.grid2spec_p(sp, corh, 1)       # (B, 2, mx, nx)
    return state
