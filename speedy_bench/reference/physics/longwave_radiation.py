"""Four-band longwave radiation (reference:
speedy.f90/longwave_radiation.f90).

The four spectral bands form an axis in front of the levels, so each level
of the sequential up/down sweeps is a few elementwise operations on
(..., 4, il, ix) tensors. The integer-temperature band-fraction lookup
fband(nint(T), band) is evaluated in closed form (the table memoizes
quadratics), which keeps the whole scheme elementwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as pc
from ._levels import LEV, floats, lev, stack

__all__ = ["radset", "get_downward_longwave_rad_fluxes",
           "get_upward_longwave_rad_fluxes", "NBAND"]

NBAND = 4


def radset() -> np.ndarray:
    """Energy fraction emitted in each LW band as f(T) (radset,
    longwave_radiation.f90:208-232). Returns (301, 4) table for T=100..400K."""
    eps1 = 1.0 - pc.EPSLW
    fband = np.zeros((301, 4))
    t = np.arange(200, 321)
    i = t - 100
    fband[i, 1] = (0.148 - 3.0e-6 * (t - 247) ** 2) * eps1
    fband[i, 2] = (0.356 - 5.2e-6 * (t - 282) ** 2) * eps1
    fband[i, 3] = (0.314 + 1.0e-5 * (t - 315) ** 2) * eps1
    fband[i, 0] = eps1 - (fband[i, 1] + fband[i, 2] + fband[i, 3])
    fband[: 100] = fband[100]
    fband[221:] = fband[220]
    return fband


def _fband_all(ta):
    """Band fractions at nint(T), clipped to the table range, for all four
    bands: (..., 4, il, ix) for ta (..., il, ix).

    The (301, 4) table memoizes closed-form quadratics
    (longwave_radiation.f90:208-232) with constant extrapolation outside
    T = 200..320 K: the same as evaluating the quadratics at
    clip(nint(T), 200, 320)."""
    eps1 = 1.0 - pc.EPSLW
    t = torch.clamp(torch.floor(ta + 0.5), 200.0, 320.0)
    b1 = (0.148 - 3.0e-6 * (t - 247.0) ** 2) * eps1
    b2 = (0.356 - 5.2e-6 * (t - 282.0) ** 2) * eps1
    b3 = (0.314 + 1.0e-5 * (t - 315.0) ** 2) * eps1
    b0 = eps1 - (b1 + b2 + b3)
    return torch.stack([b0, b1, b2, b3], dim=LEV)


def _strat_band_mask(like):
    """Bands 2-3 carry no stratospheric (k=0) flux (longwave_radiation.f90
    computes the k=1 layer only for jb=1,2)."""
    return torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=like.dtype,
                        device=like.device).reshape(4, 1, 1)


def _band(rad_tau2, k):
    """All four bands of level k: (..., 4, il, ix)."""
    return rad_tau2[..., :, k, :, :]


def get_downward_longwave_rad_fluxes(geom, fband, rad_tau2, ta):
    """Downward LW sweep (longwave_radiation.f90:16-121).

    ta: (..., kx, il, ix); rad_tau2: (..., 4, kx, il, ix). Returns (fsfcd,
    dfabs, rad_flux, rad_st4a); rad_flux (..., 4, il, ix) and rad_st4a
    (..., 2, kx, il, ix) feed the upward sweep of the same step. `fband` (the
    memoized table) is not read: the fractions are evaluated in closed form.
    """
    kx = ta.shape[LEV]
    nl1 = kx - 1
    wvi1 = floats(np.asarray(geom.wvi)[:, 1])
    t = lambda k: lev(ta, k)
    up = lambda x: x.unsqueeze(LEV)

    # Blackbody emission: boundary temperatures, stratospheric means,
    # tropospheric gradients (lw:42-70).
    tb = [t(k) + wvi1[k] * (t(k + 1) - t(k)) for k in range(nl1)]

    st4a_2 = [None] * kx
    st4a_2[0] = 0.75 * t(0) + 0.25 * tb[0]
    st4a_2[1] = 0.50 * t(1) + 0.25 * (tb[0] + tb[1])
    for k0 in range(2, nl1):
        st4a_2[k0] = 0.5 * torch.clamp(tb[k0] - tb[k0 - 1], min=0.0)
    st4a_2[kx - 1] = torch.clamp(t(kx - 1) - tb[nl1 - 1], min=0.0)

    st4a_1 = [None] * kx
    for k0 in range(2):
        sq = st4a_2[k0] * st4a_2[k0]
        st4a_1[k0] = pc.SBC * (sq * sq)
        st4a_2[k0] = torch.zeros_like(t(0))
    for k0 in range(2, kx):
        st3a = pc.SBC * (t(k0) * t(k0) * t(k0))
        st4a_1[k0] = st3a * t(k0)
        st4a_2[k0] = 4.0 * st3a * st4a_2[k0]

    bmask = _strat_band_mask(ta)

    # 3.1 stratosphere, bands 1-2 at k=1
    emis = (1.0 - _band(rad_tau2, 0)) * bmask
    flux = emis * (_fband_all(t(0)) * (up(st4a_1[0]) + emis * up(st4a_2[0])))
    dfabs = [None] * kx
    dfabs[0] = -torch.sum(flux, dim=LEV)

    # 3.2 troposphere
    for k0 in range(1, kx):
        tau = _band(rad_tau2, k0)
        emis = 1.0 - tau
        brad = _fband_all(t(k0)) * (up(st4a_1[k0]) + emis * up(st4a_2[k0]))
        newflux = tau * flux + emis * brad
        dfabs[k0] = torch.sum(flux - newflux, dim=LEV)
        flux = newflux

    fsfcd = pc.EMISFC * torch.sum(flux, dim=LEV)

    # 3.4 "black" band correction incl. surface reflection
    corlw = pc.EPSLW * pc.EMISFC * st4a_1[kx - 1]
    dfabs[kx - 1] = dfabs[kx - 1] - corlw
    fsfcd = fsfcd + corlw

    rad_st4a = torch.stack([stack(st4a_1), stack(st4a_2)], dim=LEV - 1)
    return fsfcd, stack(dfabs), flux, rad_st4a


def get_upward_longwave_rad_fluxes(geom, fband, rad_tau2, rad_st4a,
                                   rad_strat_corr, ta, ts, fsfcd, fsfcu,
                                   dfabs_in, rad_flux_down):
    """Full upward sweep (longwave_radiation.f90:124-205), band-vectorized
    like the downward sweep. Returns (fsfc, ftop, dfabs)."""
    kx = ta.shape[LEV]
    dhs = floats(geom.dhs)
    st4a_1 = rad_st4a[..., 0, :, :, :]
    st4a_2 = rad_st4a[..., 1, :, :, :]
    up = lambda x: x.unsqueeze(LEV)

    refsfc = 1.0 - pc.EMISFC
    fsfc = fsfcu - fsfcd

    flux = _fband_all(ts) * up(fsfcu) + refsfc * rad_flux_down

    dfabs = [lev(dfabs_in, k0) for k0 in range(kx)]
    # "black" band correction
    dfabs[kx - 1] = dfabs[kx - 1] + pc.EPSLW * fsfcu

    for k0 in range(kx - 1, 0, -1):
        tau = _band(rad_tau2, k0)
        emis = 1.0 - tau
        brad = _fband_all(lev(ta, k0)) * (
            up(lev(st4a_1, k0)) - emis * up(lev(st4a_2, k0)))
        newflux = tau * flux + emis * brad
        dfabs[k0] = dfabs[k0] + torch.sum(flux - newflux, dim=LEV)
        flux = newflux

    # stratosphere, bands 1-2 at k=1
    bmask = _strat_band_mask(ta)
    tau = _band(rad_tau2, 0)
    emis = (1.0 - tau) * bmask
    brad = _fband_all(lev(ta, 0)) * (
        up(lev(st4a_1, 0)) - emis * up(lev(st4a_2, 0)))
    newflux = bmask * (tau * flux + emis * brad) + (1.0 - bmask) * flux
    dfabs[0] = dfabs[0] + torch.sum(flux - newflux, dim=LEV)
    flux = newflux

    # "black" band + polar-night cooling corrections
    sc0 = lev(rad_strat_corr, 0)
    sc1 = lev(rad_strat_corr, 1)
    corlw1 = dhs[0] * sc1 * lev(st4a_1, 0) + sc0
    corlw2 = dhs[1] * sc1 * lev(st4a_1, 1)
    dfabs[0] = dfabs[0] - corlw1
    dfabs[1] = dfabs[1] - corlw2

    ftop = corlw1 + corlw2 + torch.sum(flux, dim=LEV)
    return fsfc, ftop, stack(dfabs)
