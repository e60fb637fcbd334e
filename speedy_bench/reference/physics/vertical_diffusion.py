"""Vertical diffusion and shallow convection (reference:
speedy.f90/vertical_diffusion.f90): shallow convection between the lowest two
layers, slow moisture diffusion above the PBL, and super-adiabatic lapse-rate
damping."""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as pc
from ._levels import LEV, col, lev, shift_down

__all__ = ["get_vertical_diffusion_tend", "vdiff_constants",
           "vdiff_level_tables", "TRSHC",
           "TRVDI", "TRVDS", "REDSHC", "RHGRAD", "SEGRAD"]

TRSHC = 6.0    # shallow-convection relaxation time [h]
TRVDI = 24.0   # moisture-diffusion relaxation time [h]
TRVDS = 6.0    # super-adiabatic damping time [h]
REDSHC = 0.5   # shallow-convection reduction under deep convection
RHGRAD = 0.5   # max d(RH)/d(sigma)
SEGRAD = 0.1   # min d(DSE)/d(phi)


def vdiff_constants(geom):
    """(fshcq, fshcse, fvdiq, fvdise) in the geometry's dtype."""
    dhs, sigh = np.asarray(geom.dhs), np.asarray(geom.sigh)
    kx = dhs.shape[0]
    nl1 = kx - 1
    cshc = dhs[kx - 1] / 3600.0
    cvdi = (sigh[nl1] - sigh[1]) / ((nl1 - 1) * 3600.0)
    return tuple(float(x) for x in (
        cshc / TRSHC, cshc / (TRSHC * pc.CP), cvdi / TRVDI,
        cvdi / (TRVDS * pc.CP)))


def vdiff_level_tables(geom):
    """(rsig, rsig1, drh0k, fvdiq2k, gate), each (kx,) numpy in the
    geometry's dtype: 1/dhs; 1/(1 - sigh[k+1]) (last entry unused); the RH
    gradient threshold and the diffusion coefficient of the moisture
    diffusion between levels k and k+1; 1 where that diffusion acts (1-based
    k = 3..kx-2 with sigh(k) > 0.5)."""
    fsg, dhs, sigh = (np.asarray(geom.fsg), np.asarray(geom.dhs),
                      np.asarray(geom.sigh))
    kx = dhs.shape[0]
    fvdiq = vdiff_constants(geom)[2]
    rsig = 1.0 / dhs
    rsig1 = np.zeros_like(rsig)
    rsig1[:kx - 1] = 1.0 / (1.0 - sigh[1:kx])
    drh0k = np.zeros_like(rsig)
    drh0k[:kx - 1] = RHGRAD * (fsg[1:] - fsg[:-1])
    fvdiq2k = fvdiq * sigh[1:kx + 1]
    gate = np.zeros_like(rsig)
    for k in range(3, kx - 1):
        if sigh[k] > 0.5:
            gate[k - 1] = 1.0
    return rsig, rsig1, drh0k, fvdiq2k, gate


def get_vertical_diffusion_tend(geom, se, rh, qa, qsat, phi, icnv):
    """Returns (utenvd, vtenvd, ttenvd, qtenvd); u/v tendencies are zero in
    the reference scheme (vertical_diffusion.f90:30-146)."""
    kx = se.shape[LEV]
    nl1 = kx - 1
    fsg, dhs, sigh = (np.asarray(geom.fsg), np.asarray(geom.dhs),
                      np.asarray(geom.sigh))
    fshcq, fshcse, fvdiq, fvdise = vdiff_constants(geom)

    rsig, rsig1, drh0k, fvdiq2k, gate = vdiff_level_tables(geom)

    # 2. shallow convection (vdiff:81-109): the lowest two layers only
    drh0 = float(RHGRAD * (fsg[kx - 1] - fsg[nl1 - 1]))
    fvdiq2 = float(fvdiq * sigh[nl1])
    dmse = (lev(se, kx - 1) - lev(se, nl1 - 1)
            + pc.ALHC * (lev(qa, kx - 1) - lev(qsat, nl1 - 1)))
    drh = lev(rh, kx - 1) - lev(rh, nl1 - 1)
    fcnv = torch.where(icnv > 0, REDSHC, 1.0).to(se.dtype)
    zero = torch.zeros_like(dmse)

    unstable = dmse >= 0.0
    fluxse = torch.where(unstable, fcnv * fshcse * dmse, zero)

    moist = unstable & (drh >= 0.0)
    dry_humid = (~unstable) & (drh > drh0)
    fluxq = torch.where(
        moist, fcnv * fshcq * lev(qsat, kx - 1) * drh,
        torch.where(dry_humid, fvdiq2 * lev(qsat, nl1 - 1) * drh, zero))

    # one-hot level columns
    row_nl1 = np.zeros(kx)
    row_nl1[nl1 - 1] = 1.0
    row_bot = np.zeros(kx)
    row_bot[kx - 1] = 1.0
    up = lambda x: x.unsqueeze(LEV)
    tt = (col(row_nl1 * rsig[nl1 - 1], se) * up(fluxse)
          - col(row_bot * rsig[kx - 1], se) * up(fluxse))
    qt = (col(row_nl1 * rsig[nl1 - 1], se) * up(fluxq)
          - col(row_bot * rsig[kx - 1], se) * up(fluxq))

    # 3. moisture diffusion above the PBL (vdiff:111-128), level-parallel:
    # rows 1-based k = 3..kx-2 gated statically by sigh(k) > 0.5.
    if gate.any():
        drhk = torch.cat([rh.narrow(LEV, 1, kx - 1) - rh.narrow(LEV, 0, kx - 1),
                          torch.zeros_like(rh.narrow(LEV, 0, 1))], dim=LEV)
        fq = torch.where((drhk >= col(drh0k, se)) & (col(gate, se) > 0.0),
                         col(fvdiq2k, se) * qsat * drhk, 0.0)
        # qt[k] += fq[k]*rsig[k]; qt[k+1] -= fq[k]*rsig[k+1]
        qt = qt + (fq - shift_down(fq, 1)) * col(rsig, se)

    # 4. super-adiabatic lapse-rate damping (vdiff:130-145), level-parallel:
    # the all-levels-below redistribution is an exclusive prefix sum.
    se_top, se_bot = se.narrow(LEV, 0, kx - 1), se.narrow(LEV, 1, kx - 1)
    se0 = se_bot + SEGRAD * (phi.narrow(LEV, 0, kx - 1)
                             - phi.narrow(LEV, 1, kx - 1))
    fse = torch.where(se_top < se0, fvdise * (se0 - se_top), 0.0)
    pad = torch.zeros_like(fse.narrow(LEV, 0, 1))
    tt = tt + torch.cat([fse * col(rsig[:kx - 1], se), pad], dim=LEV)
    g = fse * col(rsig1[:kx - 1], se)
    # prefix sums via log-depth shift-adds (the JAX package's order)
    csum = g
    shift = 1
    while shift < csum.shape[LEV]:
        csum = csum + shift_down(csum, shift)
        shift *= 2
    tt = tt - torch.cat([pad, csum], dim=LEV)

    zeros = torch.zeros_like(se)
    return zeros, zeros, tt, qt
