"""Prognostic-variable initialization and the conversions between the
spectral prognostics and their grid-space mirrors (reference:
speedy.f90/prognostics.f90).

`spectral2grid`, `grid2spectral` and `grid_filter_prognostics` work on the
single-member state (spectral pairs (2, ..., mx, nx), pdim=0: the default) and
on the member-batched state (pairs (B, 2, ..., mx, nx) and grid mirrors
(B, ..., il, ix): pass pdim=1). All their transforms go through
``ops.spectral.grid2spec_p`` / ``spec2grid_p``, so on the card and the dense
route through the fused transform kernels."""

from __future__ import annotations

import math

import torch

from .. import constants as pc
from ..ops import spectral as S

__all__ = ["initialize_from_rest_state", "spectral2grid", "grid2spectral",
           "grid_filter_prognostics", "GRID_MIRRORS"]

GRID_MIRRORS = ("u_grid", "v_grid", "t_grid", "q_grid", "phi_grid", "ps_grid")


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


def spectral2grid(consts, state, pdim: int = 0):
    """Fill the grid-space mirrors with unit conversions
    (prognostics.f90:125-154)."""
    sp = consts.sp
    state = dict(state)
    to_grid = lambda f, kcos=1: S.spec2grid_p(sp, f, kcos, pdim)
    ucos, vcos = S.vort2vel_p(sp, state["vor"][0], state["div"][0], pdim)
    state["u_grid"] = to_grid(ucos, 2)
    state["v_grid"] = to_grid(vcos, 2)
    state["t_grid"] = to_grid(state["t"][0])
    state["q_grid"] = to_grid(state["tr"][0].select(pdim + 1, 0)) * 1.0e-3  # kg/kg
    state["phi_grid"] = to_grid(state["phi"]) / pc.GRAV                    # m
    state["ps_grid"] = pc.P0 * torch.exp(to_grid(state["ps"][0]))         # Pa
    return state


def grid2spectral(consts, state, pdim: int = 0):
    """Push the grid-space mirrors back into the spectral prognostics
    (prognostics.f90:157-179)."""
    sp = consts.sp
    state = dict(state)
    to_spec = lambda g: S.grid2spec_p(sp, g, pdim)
    vor1, div1 = S.grid_vel2vort_p(sp, state["u_grid"], state["v_grid"], 2,
                                   pdim)
    state["vor"] = (vor1, state["vor"][1])
    state["div"] = (div1, state["div"][1])
    state["t"] = (to_spec(state["t_grid"]), state["t"][1])
    tr0 = state["tr"][0].clone()
    tr0.select(pdim + 1, 0).copy_(to_spec(state["q_grid"]) / 1.0e-3)
    state["tr"] = (tr0, state["tr"][1])
    state["phi"] = to_spec(state["phi_grid"]) * pc.GRAV
    state["ps"] = (to_spec(torch.log(state["ps_grid"] / pc.P0)),
                   state["ps"][1])
    return state


def grid_filter_prognostics(consts, state, pdim: int = 0):
    """Spectrally filter the grid-space mirrors (prognostics.f90:183-219)."""
    sp = consts.sp
    state = dict(state)
    for name in GRID_MIRRORS:
        g = state[name]
        state[name] = S.spec2grid_p(
            sp, S.truncate(sp, S.grid2spec_p(sp, g, pdim)), 1, pdim)
    return state
