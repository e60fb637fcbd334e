"""Leapfrog time stepping with Robert-Williams filtering and horizontal
diffusion (reference: speedy.f90/time_stepping.f90)."""

from __future__ import annotations

import torch

from .. import constants as pc
from .tendencies import get_tendencies, grid_tendency_specs

__all__ = ["step", "hordif", "leapfrog_pair", "sdrag_mask", "step_field",
           "diffusion_and_drag"]


def hordif(field, fdt, dmp, dmp1):
    """fdt_out = (fdt - dmp*field) * dmp1 (horizontal_diffusion.f90:131-152).
    dmp/dmp1 are (mx, nx); field/fdt have trailing (mx, nx)."""
    return (fdt - dmp * field) * dmp1


def leapfrog_pair(params, trfilt, j1: int, dt, eps, f0, f1, fdt,
                  do_truncate: bool):
    """Leapfrog + Robert-Williams filter update of one prognostic pair
    (time_stepping.f90:164-188). j1 is 1-based as in the reference: (1,1)
    forward, (1,2) initial leapfrog, (2,2) filtered. Returns (new0, new1)."""
    if do_truncate:
        fdt = fdt * trfilt
    fj = f0 if j1 == 1 else f1
    fnew = f0 + dt * fdt
    g1 = fj + params.wil * eps * (f0 - 2.0 * fj + fnew)
    # The reference computes the second-level filter displacement with the
    # already-updated first level (sequential aliasing in step_field_2d).
    g2 = fnew - (1.0 - params.wil) * eps * (g1 - 2.0 * fj + fnew)
    return (g1, g2)


def sdrag_mask(kx: int, mx: int, dtype, device):
    """One-hot (kx, mx, 1) mask selecting the top-level zonal-mean mode for
    the stratospheric drag (time_stepping.f90:92-100), applied as a masked
    subtract instead of a scattered update. The one is filled in place on
    the device (no host-to-device copy), so that a CUDA graph of the step
    can record it."""
    m00 = torch.zeros((kx, mx, 1), dtype=dtype, device=device)
    m00[0, 0, 0].fill_(1.0)
    return m00


def step_field(params, sp, j1: int, dt, eps, f, fdt):
    """leapfrog_pair on a (lev0, lev1) tuple field; truncation applies on
    the quadratic grids (ix == 4iy)."""
    return leapfrog_pair(params, sp.trfilt, j1, dt, eps, f[0], f[1], fdt,
                         params.ix == params.iy * 4)


def diffusion_and_drag(consts, vor0, div0, t0, trf0, tcorh, qcorh, vordt,
                       divdt, tdt, trdt):
    """Horizontal diffusion and the stratospheric drag of the tendencies
    (time_stepping.f90:78-122), member-batched; tracers FLAT,
    (B, 2, ntr*kx, mx, nx): tracer 0 (humidity) gets the orographic
    correction and the divergence's del^8, the rest plain del^8. tcorh and
    qcorh are (B, 2, mx, nx). Returns (vordt, divdt, tdt, trdt)."""
    im = consts.implicit
    hd = consts.hd
    ntr, kx = consts.params.ntr, consts.params.kx

    vordt = hordif(vor0, vordt, hd.dmp, im.dmp1)
    divdt = hordif(div0, divdt, hd.dmpd, im.dmp1d)
    # Insert the level axis of tcorh for the (kx, 1, 1) vertical profile.
    tcor = t0 + tcorh[:, :, None] * hd.tcorv[:, None, None]
    tdt = hordif(tcor, tdt, hd.dmp, im.dmp1)

    # Stratospheric drag on the zonal-mean top-level flow
    # (time_stepping.f90:92-100), applied as a masked subtract.
    sdrag = 1.0 / (pc.TDRS * 3600.0)
    m00 = sdrag_mask(kx, vordt.shape[-2], vordt.dtype, vordt.device)
    vordt = vordt - (sdrag * m00) * vor0
    divdt = divdt - (sdrag * m00) * div0

    vordt = hordif(vor0, vordt, hd.dmps, im.dmp1s)
    divdt = hordif(div0, divdt, hd.dmps, im.dmp1s)
    tdt = hordif(tcor, tdt, hd.dmps, im.dmp1s)

    qcor = trf0[:, :, :kx] + qcorh[:, :, None] * hd.qcorv[:, None, None]
    tr_parts = [hordif(qcor, trdt[:, :, :kx], hd.dmpd, im.dmp1d)]
    for itr in range(1, ntr):
        sl = slice(itr * kx, (itr + 1) * kx)
        tr_parts.append(hordif(trf0[:, :, sl], trdt[:, :, sl], hd.dmp,
                               im.dmp1))
    trdt = torch.cat(tr_parts, dim=2) if ntr > 1 else tr_parts[0]
    return vordt, divdt, tdt, trdt


def step(consts, state, j1: int, j2: int, dt: float, physics_fn=None,
         ctx=None, out=None):
    """One (half/full/leapfrog) step (time_stepping.f90:38-147) of the
    member-batched state.

    j1/j2 are the reference's 1-based time-level selectors; dt the step
    length. consts.implicit must hold the tables for this dt. physics_fn
    (physics.driver.get_physical_tendencies, or None with the physics off)
    and its ctx go through to grid_tendency_specs.

    For the default semi-implicit configuration (alph >= 0.5) the whole
    spectral side (flux combination, linear tendencies, implicit
    correction, diffusion, leapfrog) runs through
    spectral_glue.apply_spectral_update: one kernel launch on the card. The
    explicit gravity-wave branch (alph < 0.5, dead at the reference
    default) keeps the op-by-op formulation of the JAX package, in plain
    PyTorch after the transforms and the column kernels on either device.

    `out`, when given, is the state's own tensors (a dict by field: the
    batched runner's buffers on its graph path). On the semi-implicit
    branch the step writes there what it writes through its kernels: the
    geopotential, the physics' diagnostics, cache and SPPT spectrum, and
    the new prognostic pairs (grid_tendency_specs,
    spectral_glue.apply_spectral_update); the explicit branch returns new
    tensors.
    """
    params = consts.params
    if params.alph >= 0.5:
        # spectral_glue imports this module: imported at the call.
        from .spectral_glue import apply_spectral_update

        specs, psdt, state = grid_tendency_specs(consts, state, j2 - 1,
                                                 physics_fn, ctx, out=out)
        return apply_spectral_update(consts, state, specs, psdt, j1, dt,
                                     out=out)

    vordt, divdt, tdt, psdt, trdt, state = get_tendencies(
        consts, state, j2 - 1, physics_fn, ctx)
    tr0 = state["tr"][0]
    vordt, divdt, tdt, trdt = diffusion_and_drag(
        consts, state["vor"][0], state["div"][0], state["t"][0],
        tr0.flatten(2, 3), state["tcorh"], state["qcorh"], vordt, divdt, tdt,
        trdt.flatten(2, 3))

    # --- leapfrog with Robert-Williams filter (time_stepping.f90:124-144) ---
    eps = 0.0 if j1 == 1 else params.rob
    state = dict(state)
    for name, fdt in (("ps", psdt), ("vor", vordt), ("div", divdt),
                      ("t", tdt), ("tr", trdt.unflatten(2, tr0.shape[2:4]))):
        state[name] = step_field(params, consts.sp, j1, dt, eps, state[name],
                                 fdt)
    return state
