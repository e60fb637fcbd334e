"""Shortwave radiation, cloud diagnosis and seasonal insolation
(reference: speedy.f90/shortwave_radiation.f90).

The daily zonal-mean forcing fields (``solar_insolation``,
``get_zonal_average_fields``) depend on latitude and the date alone, and the
date lives on the host, so they are computed with numpy in the model dtype
and go to the device as one small tensor per day. ``clouds`` and
``get_shortwave_rad_fluxes`` are the column physics: short static loops over
the kx levels of (..., kx, il, ix) stacks. The shortwave routine also
initializes the longwave transmissivities (the bands of rad_tau2) and the
stratospheric correction, which persist in the model state across the
nstrad-step shortwave cadence.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as pc
from ._levels import LEV, floats, lev, stack

__all__ = ["clouds", "solar_insolation", "get_zonal_average_fields",
           "get_shortwave_rad_fluxes", "sw_abs1", "SOLC", "EPSSW"]

SOLC = 342.0
RHCL1 = 0.30
RHCL2 = 1.00
QACL = 0.20
WPCL = 0.2
PMAXCL = 10.0
CLSMAX = 0.60
CLSMINL = 0.15
GSE_S0 = 0.25
GSE_S1 = 0.40
ALBCL = 0.43
ALBCLS = 0.50
EPSSW = 0.020

ABSDRY = 0.033
ABSAER = 0.033
ABSWV1 = 0.022
ABSWV2 = 15.000
ABSCL1 = 0.015
ABSCL2 = 0.15

ABLWIN = 0.3
ABLWV1 = 0.7
ABLWV2 = 50.0
ABLCL1 = 12.0
ABLCL2 = 0.6

CLFACT = 1.2
FBAND2 = 0.05


def clouds(qa, rh, precnv, precls, iptop, gse, fmask):
    """Cloud cover and cloud-top diagnosis (shortwave_radiation.f90:325-404).
    Returns (icltop [1-based int32], cloudc, clstr, qcloud_equiv)."""
    kx = qa.shape[LEV]
    nl1 = kx - 1
    nlp = kx + 1
    rrcl = 1.0 / (RHCL2 - RHCL1)

    rh_nl1 = lev(rh, nl1 - 1)
    base = rh_nl1 > RHCL1
    cloudc = torch.where(base, rh_nl1 - RHCL1, torch.zeros_like(rh_nl1))
    icltop = torch.where(base, nl1, nlp).to(torch.int32)

    for k in range(3, kx - 1):  # 1-based 3..kx-2, running max of RH excess
        drh = lev(rh, k - 1) - RHCL1
        hit = (drh > cloudc) & (lev(qa, k - 1) > QACL)
        cloudc = torch.where(hit, drh, cloudc)
        icltop = torch.where(hit, k, icltop).to(torch.int32)

    pr1 = torch.clamp(86.4 * (precnv + precls), max=PMAXCL)
    cloudc = torch.clamp(
        WPCL * torch.sqrt(pr1) + torch.clamp(cloudc * rrcl, max=1.0) ** 2,
        max=1.0)
    icltop = torch.minimum(iptop, icltop)

    qcloud_equiv = lev(qa, nl1 - 1)

    rgse = 1.0 / (GSE_S1 - GSE_S0)
    fstab = torch.clamp(rgse * (gse - GSE_S0), 0.0, 1.0)
    clstr = fstab * torch.clamp(CLSMAX - CLFACT * cloudc, min=0.0)
    clstrl = torch.clamp(clstr, min=CLSMINL) * lev(rh, kx - 1)
    clstr = clstr + fmask * (clstrl - clstr)
    return icltop, cloudc, clstr, qcloud_equiv


def solar_insolation(tyear, csol, coa, sia):
    """Hartmann (1994) daily-average TOA insolation by latitude
    (shortwave_radiation.f90:276-322). tyear: scalar of the model dtype;
    coa/sia: (il,) numpy."""
    pigr = float(2.0 * np.arcsin(1.0))
    alpha = 2.0 * pigr * tyear
    ca1 = np.cos(alpha)
    sa1 = np.sin(alpha)
    ca2 = ca1 * ca1 - sa1 * sa1
    sa2 = 2.0 * sa1 * ca1
    ca3 = ca1 * ca2 - sa1 * sa2
    sa3 = sa1 * ca2 + sa2 * ca1

    decl = (0.006918 - 0.399912 * ca1 + 0.070257 * sa1 - 0.006758 * ca2
            + 0.000907 * sa2 - 0.002697 * ca3 + 0.001480 * sa3)
    fdis = (1.000110 + 0.034221 * ca1 + 0.001280 * sa1 + 0.000719 * ca2
            + 0.000077 * sa2)

    cdecl = np.cos(decl)
    sdecl = np.sin(decl)
    tdecl = sdecl / cdecl

    csolp = csol / pigr
    ch0 = np.clip(-tdecl * sia / coa, -1.0, 1.0)
    h0 = np.arccos(ch0)
    sh0 = np.sin(h0)
    return csolp * fdis * (h0 * sia * sdecl + sh0 * coa * cdecl)


def get_zonal_average_fields(geom, tyear: float) -> np.ndarray:
    """Daily zonal-mean radiative forcing fields
    (shortwave_radiation.f90:218-273). geom: numpy Geometry in the model
    dtype. Returns a (5, il, 1) numpy array in that dtype: flux_solar_in,
    flux_ozone_upper, flux_ozone_lower, zenit_correction,
    stratospheric_correction, each (il, ix)-broadcastable."""
    coa = np.asarray(geom.coa)
    sia = np.asarray(geom.sia)
    rdt = coa.dtype.type
    tyear = rdt(tyear)

    alpha = rdt(4.0 * np.arcsin(1.0)) * (tyear + rdt(10.0 / 365.0))
    coz1 = np.maximum(rdt(0.0), np.cos(alpha))
    coz2 = rdt(1.8)
    azen = rdt(1.0)
    nzen = 2
    rzen = -np.cos(alpha) * rdt(23.45 * np.arcsin(1.0) / 90.0)
    fs0 = rdt(6.0)

    topsr = solar_insolation(tyear, rdt(4.0 * SOLC), coa, sia)
    flat2 = rdt(1.5) * sia**2 - rdt(0.5)

    fsol = topsr
    ozupp = np.full_like(topsr, 0.5 * EPSSW)
    ozone = rdt(0.4 * EPSSW) * (rdt(1.0) + coz1 * sia + coz2 * flat2)
    zenit = rdt(1.0) + azen * (
        rdt(1.0) - (coa * np.cos(rzen) + sia * np.sin(rzen))) ** nzen
    ozupp = fsol * ozupp * zenit
    ozone = fsol * ozone * zenit
    stratz = np.maximum(fs0 - fsol, rdt(0.0))

    out = np.stack([fsol, ozupp, ozone, zenit, stratz])[:, :, None]
    return out.astype(coa.dtype)


def sw_abs1(geom) -> list:
    """Dry-air plus aerosol absorptivity of the visible band per level."""
    return [ABSDRY + ABSAER * f ** 2 for f in floats(geom.fsg)]


def get_shortwave_rad_fluxes(geom, state, psa, qa, icltop, cloudc, clstr):
    """Shortwave absorption sweeps + LW transmissivity initialization
    (shortwave_radiation.f90:50-214). `state` holds zenit_correction,
    qcloud_equiv, flux_solar_in, flux_ozone_upper, flux_ozone_lower,
    alb_surface, stratospheric_correction (planes that broadcast against
    psa) and air_absortivity_co2 (0-d, or one value per member shaped to
    broadcast).

    Returns (tsr, ssrd, ssr, tt_rsw_flux, rad_tau2, rad_strat_corr); tt_rsw is
    the per-layer absorbed *flux*, scaled to a tendency by the caller;
    rad_tau2 is (..., 4, kx, il, ix), rad_strat_corr (..., 2, il, ix).
    """
    kx = qa.shape[LEV]
    dhs, abs1_k = floats(geom.dhs), sw_abs1(geom)
    fband1 = 1.0 - FBAND2
    ones = torch.ones_like(psa)
    q = lambda k: lev(qa, k)

    # -- 1. cloud albedo slots (band index 2) --
    tau3 = [torch.zeros_like(psa) for _ in range(kx)]
    for k in range(3, kx + 1):  # icltop can reach kx here
        tau3[k - 1] = torch.where(icltop == k, ALBCL * cloudc, tau3[k - 1])
    tau3[kx - 1] = ALBCLS * clstr  # overwrites any cloud top at kx

    # -- 2. shortwave transmissivities --
    psaz = psa * state["zenit_correction"]
    acloud = cloudc * torch.clamp(ABSCL1 * state["qcloud_equiv"], max=ABSCL2)

    tau1 = [None] * kx
    tau1[0] = torch.exp(-psaz * dhs[0] * ABSDRY)
    for k in range(2, kx):  # 1-based 2..nl1
        k0 = k - 1
        abs1 = abs1_k[k0]
        deltap = psaz * dhs[k0]
        tau1[k0] = torch.where(
            k >= icltop,
            torch.exp(-deltap * (abs1 + ABSWV1 * q(k0) + acloud)),
            torch.exp(-deltap * (abs1 + ABSWV1 * q(k0))))
    abs1 = abs1_k[kx - 1]
    tau1[kx - 1] = torch.exp(
        -psaz * dhs[kx - 1] * (abs1 + ABSWV1 * q(kx - 1)))

    tau2b = [ones] + [torch.exp(-psaz * dhs[k0] * ABSWV2 * q(k0))
                      for k0 in range(1, kx)]

    # -- 3. downward flux sweeps --
    fsol = state["flux_solar_in"] * ones
    tsr = fsol
    flux1 = fsol * fband1
    flux2 = fsol * FBAND2

    tt = [None] * kx
    # stratosphere: ozone + dry-air absorption (3.2)
    tt[0] = flux1
    flux1 = tau1[0] * (flux1 - state["flux_ozone_upper"] * psa)
    tt[0] = tt[0] - flux1
    tt[1] = flux1
    flux1 = tau1[1] * (flux1 - state["flux_ozone_lower"] * psa)
    tt[1] = tt[1] - flux1

    # troposphere: absorption and cloud reflection (3.3)
    for k0 in range(2, kx):
        tau3[k0] = flux1 * tau3[k0]
        flux1 = flux1 - tau3[k0]
        tt[k0] = flux1
        flux1 = tau1[k0] * flux1
        tt[k0] = tt[k0] - flux1

    # near-IR band (3.3 second loop)
    for k0 in range(1, kx):
        tt[k0] = tt[k0] + flux2
        flux2 = tau2b[k0] * flux2
        tt[k0] = tt[k0] - flux2

    # -- 4. surface and upward sweep --
    ssrd = flux1 + flux2
    flux1 = flux1 * state["alb_surface"]
    ssr = ssrd - flux1

    for k0 in range(kx - 1, -1, -1):
        tt[k0] = tt[k0] + flux1
        flux1 = tau1[k0] * flux1
        tt[k0] = tt[k0] - flux1
        flux1 = flux1 + tau3[k0]

    tsr = tsr - flux1

    # -- 5. longwave transmissivity initialization (5.1) --
    lw1 = [None] * kx
    lw2 = [None] * kx
    lw3 = [None] * kx
    lw4 = [None] * kx
    ablco2 = state["air_absortivity_co2"]

    lw1[0] = torch.exp(-psa * dhs[0] * ABLWIN)
    lw2[0] = torch.exp(-psa * dhs[0] * ablco2)
    lw3[0] = ones
    lw4[0] = ones

    for k in (2, kx):  # 1-based: levels 2 and kx (cloud-free)
        k0 = k - 1
        lw1[k0] = torch.exp(-psa * dhs[k0] * ABLWIN)
        lw2[k0] = torch.exp(-psa * dhs[k0] * ablco2)
        lw3[k0] = torch.exp(-psa * dhs[k0] * ABLWV1 * q(k0))
        lw4[k0] = torch.exp(-psa * dhs[k0] * ABLWV2 * q(k0))

    acloud = cloudc * ABLCL2
    for k in range(3, kx):  # 1-based 3..nl1 (cloudy free troposphere)
        k0 = k - 1
        deltap = psa * dhs[k0]
        acloud1 = torch.where(k < icltop, acloud, ABLCL1 * cloudc)
        lw1[k0] = torch.exp(-deltap * (ABLWIN + acloud1))
        lw2[k0] = torch.exp(-deltap * ablco2)
        lw3[k0] = torch.exp(-deltap * torch.maximum(ABLWV1 * q(k0), acloud))
        lw4[k0] = torch.exp(-deltap * torch.maximum(ABLWV2 * q(k0), acloud))

    rad_tau2 = torch.stack([stack(b) for b in (lw1, lw2, lw3, lw4)],
                           dim=LEV - 1)

    # -- 5.2 stratospheric correction --
    eps1 = pc.EPSLW / (dhs[0] + dhs[1])
    rad_strat_corr = stack(
        [state["stratospheric_correction"] * psa, eps1 * psa])

    return tsr, ssrd, ssr, stack(tt), rad_tau2, rad_strat_corr
