"""Prognostic-variable initialization (reference:
speedy.f90/prognostics.f90). The grid/spectral conversions of the public API
are not part of this package yet."""

from __future__ import annotations

import math

import torch

from .. import constants as pc
from ..ops import spectral as S

__all__ = ["initialize_from_rest_state"]


def initialize_from_rest_state(consts, state):
    """Reference atmosphere at rest (prognostics.f90:29-120): isothermal
    stratosphere over a constant-lapse-rate troposphere, surface pressure in
    hydrostatic balance with the (filtered) orography, humidity decaying as
    sigma^(hscale/hshum). Works on the single-member (unbatched) state:
    spectral fields are real pairs (2, ..., mx, nx)."""
    params = consts.params
    sp = consts.sp
    fsg = [float(x) for x in consts.geom.fsg]
    kx = params.kx
    rdtype, device = params.dtype, sp.device

    gam1 = pc.GAMMA / (1000.0 * pc.GRAV)

    state = dict(state)
    phis = S.grid2spec_p(sp, state["phis0"])
    state["phis"] = phis
    # Loop-invariant grid synthesis of phis for the grid_phi physics path
    # (models/geopotential.get_geopotential_grid). NOT phis0: the reference
    # transform pair is non-orthogonal (~5e-4, ops/geometry.py), so
    # spec2grid(phis) and phis0 differ by a small static field; exact
    # commutation with the spectral recursion requires the former.
    state["phisg"] = S.spec2grid_p(sp, phis, 1)

    zeros3 = torch.zeros((2, kx, params.mx, params.nx), dtype=rdtype,
                         device=device)
    state["vor"] = (zeros3, zeros3.clone())
    state["div"] = (zeros3.clone(), zeros3.clone())

    tref, ttop = 288.0, 216.0
    gam2 = gam1 / tref
    rgam = pc.RGAS * gam1
    rgamr = 1.0 / rgam

    # Fresh tensors, written in place where the JAX package scatters.
    surfs = -gam1 * phis
    surfs[0, 0, 0] = math.sqrt(2.0) * tref - gam1 * phis[0, 0, 0]

    ttop_plane = torch.zeros_like(phis)
    ttop_plane[0, 0, 0] = math.sqrt(2.0) * ttop
    t_levels = [ttop_plane, ttop_plane]
    for k in range(2, kx):
        t_levels.append(surfs * fsg[k] ** rgam)
    t1 = torch.stack(t_levels, dim=1)  # (2, kx, mx, nx)
    state["t"] = (t1, torch.zeros_like(t1))

    # log(normalized ps) consistent with the temperature profile, p=1013 hPa
    # at z=0 (prognostics.f90:83-94).
    rlog0 = math.log(1.013)
    surfg = rlog0 + rgamr * torch.log(1.0 - gam2 * state["phis0"])
    ps1 = S.grid2spec_p(sp, surfg)
    if params.ix == 4 * params.iy:
        ps1 = S.truncate(sp, ps1)
    state["ps"] = (ps1, torch.zeros_like(ps1))

    # Tropospheric specific humidity in g/kg (prognostics.f90:96-115).
    esref = 17.0
    qref = pc.REFRH1 * 0.622 * esref
    qexp = pc.HSCALE / pc.HSHUM
    surfgq = qref * torch.exp(qexp * surfg)
    surfsq = S.grid2spec_p(sp, surfgq)
    if params.ix == 4 * params.iy:
        surfsq = S.truncate(sp, surfsq)

    q_levels = [torch.zeros_like(phis) for _ in range(2)]
    for k in range(2, kx):
        q_levels.append(surfsq * fsg[k] ** qexp)
    # tr layout: tuple over t_levs of (2, ntr, kx, mx, nx)
    tr0 = torch.zeros((2, params.ntr, kx, params.mx, params.nx),
                      dtype=rdtype, device=device)
    tr0[:, 0] = torch.stack(q_levels, dim=1)
    state["tr"] = (tr0, torch.zeros_like(tr0))

    state["phi"] = torch.zeros_like(t1)
    return state
