"""Leapfrog time stepping with Robert-Williams filtering and horizontal
diffusion (reference: speedy.f90/time_stepping.f90)."""

from __future__ import annotations

import torch

__all__ = ["step", "hordif", "leapfrog_pair", "sdrag_mask"]


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
    subtract instead of a scattered update."""
    m00 = torch.zeros((kx, mx, 1), dtype=dtype, device=device)
    m00[0, 0, 0] = 1.0
    return m00


def step(consts, state, j1: int, j2: int, dt: float, physics_fn=None,
         ctx=None):
    """One (half/full/leapfrog) step (time_stepping.f90:38-147) of the
    member-batched state.

    j1/j2 are the reference's 1-based time-level selectors; dt the step
    length. consts.implicit must hold the tables for this dt. physics_fn
    (physics.driver.get_physical_tendencies, or None with the physics off)
    and its ctx go through to grid_tendency_specs.

    Only the default semi-implicit configuration (alph >= 0.5) is ported:
    the whole spectral side (flux combination, linear tendencies, implicit
    correction, diffusion, leapfrog) runs through
    spectral_glue.apply_spectral_update. The explicit gravity-wave branch of
    the JAX package (alph < 0.5, dead at the reference default) is not.
    """
    if consts.params.alph < 0.5:
        raise NotImplementedError(
            "alph < 0.5 (the explicit gravity-wave branch of timestep.step "
            "and tendencies.get_tendencies) is not ported yet")
    from .spectral_glue import apply_spectral_update
    from .tendencies import grid_tendency_specs

    specs, psdt, state = grid_tendency_specs(consts, state, j2 - 1,
                                             physics_fn, ctx)
    return apply_spectral_update(consts, state, specs, psdt, j1, dt)
