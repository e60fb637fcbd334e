"""Large-scale condensation (reference:
speedy.f90/large_scale_condensation.f90): relaxation of q to a
sigma-dependent RH threshold with capped latent heating."""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as pc
from ._levels import LEV, col

__all__ = ["get_large_scale_condensation_tendencies", "lsc_level_tables",
           "TRLSC", "RHLSC", "DRHLSC", "RHBLSC", "QSMAX"]

TRLSC = 4.0    # relaxation time [h]
RHLSC = 0.9    # RH threshold at sigma=1
DRHLSC = 0.1   # vertical range of the threshold
RHBLSC = 0.95  # boundary-layer RH threshold
QSMAX = 10.0   # cap of the latent heating


def lsc_level_tables(geom):
    """(rhref, dqmax, wcol) per level, numpy in the geometry's dtype: the RH
    threshold, the cap of the humidity tendency that heats, and the weights
    dhs * p0 / g of the precipitation sum."""
    kx = np.asarray(geom.fsg).shape[0]
    rtlsc = 1.0 / (TRLSC * 3600.0)
    sig2 = np.asarray(geom.fsg) ** 2
    rhref = RHLSC + DRHLSC * (sig2 - 1.0)
    rhref[kx - 1] = max(rhref[kx - 1], RHBLSC)
    dqmax = QSMAX * sig2 * rtlsc
    wcol = np.asarray(geom.dhs) * (pc.P0 / pc.GRAV)
    return rhref, dqmax, wcol


def get_large_scale_condensation_tendencies(geom, psa, qa, qsat, itop):
    """Returns (itop, precls, dtlsc, dqlsc)
    (large_scale_condensation.f90:33-96); dtlsc/dqlsc are direct tendencies
    (K/s, g/kg/s), itop is updated with the condensation top."""
    kx = qa.shape[LEV]

    rtlsc = 1.0 / (TRLSC * 3600.0)
    tfact = pc.ALHC / pc.CP
    psa2 = psa**2

    # Level-parallel over 1-based levels 2..kx; level 1 carries no
    # large-scale condensation.
    rhref, dqmax, wcol = lsc_level_tables(geom)
    karr = torch.arange(1, kx + 1, dtype=torch.int32,
                        device=qa.device).reshape(-1, 1, 1)

    dqa = col(rhref, qa) * qsat - qa
    cond = (dqa < 0.0) & (karr > 1)
    # sequential "itop = min(k, itop) when cond" == elementwise min over hits
    hitk = torch.where(cond, karr, kx + 1)
    itop = torch.minimum(itop, hitk.amin(dim=LEV).to(itop.dtype))
    dqlsc = torch.where(cond, dqa * rtlsc, 0.0)
    dtlsc = torch.where(
        cond,
        tfact * torch.minimum(-dqlsc, col(dqmax, qa) * psa2.unsqueeze(LEV)),
        0.0)

    precls = -torch.sum(col(wcol[1:], qa) * dqlsc.narrow(LEV, 1, kx - 1), dim=LEV) * psa
    return itop, precls, dtlsc, dqlsc
