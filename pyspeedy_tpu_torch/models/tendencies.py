"""Dynamical-core tendencies (reference: speedy.f90/tendencies.f90),
member-batched.

Tensor layouts: every field carries a leading member axis B. Spectral fields
are real PAIRS with the pair axis c second (c=0 real part, c=1 imaginary
part; see ops/spectral.py): (B, 2, kx, mx, nx) / (B, 2, mx, nx). Grid fields
are (B, kx, il, ix) / (B, il, ix). The leapfrog time levels are tuples of
per-level tensors: vor = (lev0, lev1) each (B, 2, kx, mx, nx); tr levels are
(B, 2, ntr, kx, mx, nx). Fields shared by all members (phis) have no member
axis and broadcast.
"""

from __future__ import annotations

import torch

from .. import constants as pc
from ..ops import spectral as S
from ..ops.column_kernels import ColumnTables, grid_dynamics
from .geopotential import get_geopotential

__all__ = ["grid_dynamics_core", "grid_tendency_specs", "combine_specs",
           "spectral_linear_tendencies", "PDIM"]

# Position of the pair axis in a member-batched spectral field.
PDIM = 1
# Position of the level axis in a member-batched grid field (B, kx, il, ix).
_LEV = 1


def _vertical_means(dhs, fields):
    """Sigma-mass-weighted vertical means of (B, kx, il, ix) fields:
    broadcast-multiply + level sum, as in the JAX package."""
    return [torch.sum(dhs * f, dim=_LEV) for f in fields]


def _half_level_flux(sigdt, df):
    """temp[k] = sigdt[k] * df[k] on interior half levels, zero at the
    boundaries: returns a (B, kx+1, il, ix) tensor."""
    zeros = torch.zeros_like(sigdt[:, :1])
    return torch.cat([zeros, sigdt[:, 1:-1] * df, zeros], dim=_LEV)


def _prefix_cumsum(x, dim: int = _LEV):
    """Prefix sums along `dim` via log-depth shift-adds: the JAX package's
    formulation, kept so that float64 results agree with it to rounding."""
    n = x.shape[dim]
    shift = 1
    while shift < n:
        head = torch.zeros_like(x.narrow(dim, 0, shift))
        x = x + torch.cat([head, x.narrow(dim, 0, n - shift)], dim=dim)
        shift *= 2
    return x


def grid_dynamics_core(tab: ColumnTables, vorg, divg, tg, trg_flat, ug0, vg0,
                       pxy, bf16_out: bool = False):
    """Grid-point dynamical algebra (tendencies.f90:132-224): everything
    between the inverse and direct transforms, column-local by construction
    (vertical means, sigma-dot recursions, advection/energy products).

    This is the plain PyTorch version of the CUDA kernel
    ``csrc/grid_dynamics.cu``: it runs for CPU tensors, and is the kernel's
    yardstick of correctness on the card. Inputs are member-batched:
    (B, kx, il, ix) fields, trg_flat (B, ntr*kx, il, ix), pxy (B, 2, il, ix).

    Returns (utend, vtend, ttend, trtend, psdt_g, flux_ut, flux_vt,
    flux_qu, flux_qv, ke): the dynamics-only tendencies, the grid-space
    log-ps tendency, and the direct-transform input products. With
    `bf16_out` (the bf16_tendencies configuration) all ten are cast to
    bfloat16 at the end, where the kernel rounds at its stores: every output
    is tendency-class (a per-step increment or a flux-form product), and the
    direct transforms downstream read them as 2-byte operands.
    """
    dhs, dhsr, fsgr = tab.dhs, tab.dhsr, tab.fsgr
    tref, tref3 = tab.tref, tab.tref3
    rcos, coriol = tab.rcos, tab.coriol
    kx = tab.kx
    ntr = trg_flat.shape[_LEV] // kx

    ug = ug0 * rcos
    vg = vg0 * rcos
    px = (pxy[:, 0] * rcos)[:, None]
    py = (pxy[:, 1] * rcos)[:, None]
    vorg = vorg + coriol

    umean, vmean, dmean = (m[:, None] for m in
                           _vertical_means(dhs, (ug, vg, divg)))

    # --- log-ps tendency, grid part (tendencies.f90:144-149) ---
    psdt_g = (-umean * px - vmean * py)[:, 0]

    # --- sigma-dot vertical velocity (tendencies.f90:152-166) ---
    # NB the reference's recursion runs through k=kx, so the bottom half
    # level carries the accumulated sum (~ -mean(puv)), it is NOT zero.
    puv = (ug - umean) * px + (vg - vmean) * py
    zero2 = torch.zeros_like(puv[:, :1])
    sigdt = torch.cat(
        [zero2, -_prefix_cumsum(dhs * (puv + divg - dmean))], dim=_LEV)
    sigm = torch.cat([zero2, -_prefix_cumsum(dhs * puv)], dim=_LEV)

    tgg = tg - tref

    # --- wind tendencies (tendencies.f90:174-195) ---
    tmp = _half_level_flux(sigdt, ug[:, 1:] - ug[:, :-1])
    utend = vg * vorg - tgg * pc.RGAS * px - (tmp[:, 1:] + tmp[:, :-1]) * dhsr
    tmp = _half_level_flux(sigdt, vg[:, 1:] - vg[:, :-1])
    vtend = -ug * vorg - tgg * pc.RGAS * py - (tmp[:, 1:] + tmp[:, :-1]) * dhsr

    # --- temperature tendency (tendencies.f90:197-210) ---
    tmp = _half_level_flux(sigdt, tgg[:, 1:] - tgg[:, :-1]) \
        + _half_level_flux(sigm, (tref[1:] - tref[:-1])
                           * torch.ones_like(sigm[:, 1:-1]))
    ttend = (tgg * divg - (tmp[:, 1:] + tmp[:, :-1]) * dhsr
             + fsgr * tgg * (sigdt[:, 1:] + sigdt[:, :-1])
             + tref3 * (sigm[:, 1:] + sigm[:, :-1])
             + pc.AKAP * (tg * puv - tgg * dmean))

    # --- tracer tendencies (tendencies.f90:212-224) ---
    # The reference zeroes the vertical tracer flux at the top two interior
    # half levels (temp(:,:,2:3) = 0, tendencies.f90:218).
    trmask = torch.ones((kx + 1, 1, 1), dtype=vorg.dtype, device=vorg.device)
    trmask[1:3] = 0.0

    def tracer_tend(q):
        tmp = _half_level_flux(sigdt, q[:, 1:] - q[:, :-1]) * trmask
        return q * divg - (tmp[:, 1:] + tmp[:, :-1]) * dhsr

    trg_list = [trg_flat[:, i * kx:(i + 1) * kx] for i in range(ntr)]
    trtend = torch.cat([tracer_tend(q) for q in trg_list], dim=_LEV)

    # --- direct-transform input products (tendencies.f90:238-268) ---
    flux_ut = -ug * tgg * rcos
    flux_vt = -vg * tgg * rcos
    flux_qu = torch.cat([-ug * q * rcos for q in trg_list], dim=_LEV)
    flux_qv = torch.cat([-vg * q * rcos for q in trg_list], dim=_LEV)
    ke = 0.5 * (ug**2 + vg**2)

    out = (utend, vtend, ttend, trtend, psdt_g, flux_ut, flux_vt,
           flux_qu, flux_qv, ke)
    if bf16_out:
        out = tuple(x.to(torch.bfloat16) for x in out)
    return out


def grid_tendency_specs(consts, state, j2: int, physics_fn=None, ctx=None):
    """The transform-and-grid-kernel part of a step: inverse transforms ->
    grid dynamics (the CUDA kernel on the card, the plain version on the CPU)
    -> physics (physics_fn, when given, adds its tendencies at time level 0
    and writes its diagnostics into the state) -> direct transforms, one
    transform call per field. Returns
    (specs, psdt, state) where specs is the list of direct-transform outputs
    (wind/flux pairs then ke, ttend, tracer tendencies) still awaiting the
    spectral-side combination (tendencies.f90:238-268 second half), and psdt
    is the spectral log-ps tendency (grid part, already mean-masked).
    `state` comes back with the geopotential updated (and what the physics
    wrote)."""
    sp = consts.sp
    kx = consts.params.kx

    vor = state["vor"][j2]
    div = state["div"][j2]
    t = state["t"][j2]
    tr = state["tr"][j2]  # (B, 2, ntr, kx, mx, nx)
    ps = state["ps"][j2]
    ntr = tr.shape[2]

    # --- prognostics to grid space (tendencies.f90:109-130) ---
    # The cos-lat scaling of the reference's kcos=2 variant commutes with the
    # linear transform and is applied after, in the grid-dynamics function.
    # The grid-dynamics kernel takes dense tensors: the fused transform
    # kernel and the fft route return one (contiguous() is then a no-op), an
    # einsum of the third route may return a permuted view.
    ucos, vcos = S.vort2vel_p(sp, vor, div, PDIM)
    psdx, psdy = S.gradient_p(sp, ps, PDIM)
    to_grid = lambda f: S.spec2grid_p(sp, f, 1, PDIM).contiguous()
    vorg, divg, tg = to_grid(vor), to_grid(div), to_grid(t)
    trg_flat = to_grid(tr.flatten(2, 3))
    ug, vg = to_grid(ucos), to_grid(vcos)
    pxy = to_grid(torch.stack([psdx, psdy], dim=2))   # (B, 2, il, ix)

    (utend, vtend, ttend, trtend_flat, psdt_g, flux_ut, flux_vt,
     flux_qu, flux_qv, ke) = grid_dynamics(
        grid_dynamics_core, consts.col, vorg, divg, tg, trg_flat, ug, vg, pxy,
        bf16_out=consts.bf16_tendencies)

    # --- log-ps tendency (tendencies.f90:144-149): the (0,0) spectral mean
    # is zeroed in place on the fresh tensor.
    psdt = S.grid2spec_p(sp, psdt_g, PDIM)
    psdt[..., 0, 0] = 0.0

    state = dict(state)
    # --- physics (tendencies.f90:229-232) ---
    state["phi"] = get_geopotential(consts.gp, state["t"][0], state["phis"])
    if physics_fn is not None:
        utend, vtend, ttend, trtend_flat, state = physics_fn(
            consts, state, ctx, utend, vtend, ttend, trtend_flat)

    # --- back to spectral (tendencies.f90:238-268) ---
    # Direct transforms of every outgoing field: the wind/flux pairs (scaled
    # by 1/cos as in grid_vel2vort's kcos=2) plus the scalar tendencies. With
    # bf16_tendencies the operands arrive in bfloat16 from the kernels; the
    # 1/cos scaling stays in their type so that nothing widens them again.
    rcos = consts.col.rcos.to(utend.dtype)
    inputs = [utend * rcos, vtend * rcos, flux_ut, flux_vt]
    for i in range(ntr):
        inputs += [flux_qu[:, i * kx:(i + 1) * kx],
                   flux_qv[:, i * kx:(i + 1) * kx]]
    inputs += [ke, ttend]
    inputs += [trtend_flat[:, i * kx:(i + 1) * kx] for i in range(ntr)]
    specs = [S.grid2spec_p(sp, f, PDIM) for f in inputs]

    return specs, psdt, state


def combine_specs(consts, specs, ntr: int, kx: int):
    """Spectral combination of the direct-transform outputs
    (tendencies.f90:244-268): flux pairs -> vor/div/T/tracer tendencies,
    KE Laplacian. Tracer tendencies come back FLAT: (B, 2, ntr*kx, mx, nx)."""
    sp = consts.sp
    vordt, divdt = S.vel2vort_p(sp, specs[0], specs[1], PDIM)
    _, tdt_flux = S.vel2vort_p(sp, specs[2], specs[3], PDIM)
    tr_fluxes = [S.vel2vort_p(sp, specs[4 + 2 * i], specs[5 + 2 * i], PDIM)[1]
                 for i in range(ntr)]
    base = 4 + 2 * ntr
    ke_spec = specs[base]
    tdt = tdt_flux + specs[base + 1]
    tr_parts = [tr_fluxes[i] + specs[base + 2 + i] for i in range(ntr)]
    trdt_flat = torch.cat(tr_parts, dim=2) if ntr > 1 else tr_parts[0]

    divdt = divdt - S.laplacian(sp, ke_spec)

    return vordt, divdt, tdt, trdt_flat


def spectral_linear_tendencies(consts, div, ps, phi, divdt, tdt, psdt):
    """Linear (reference-profile) spectral tendencies on explicit tensors
    (tendencies.f90:283-352), in the reference-ordered form (sequential
    cumulative sum). div/phi are (B, 2, kx, mx, nx), ps (B, 2, mx, nx)."""
    sp = consts.sp
    im = consts.implicit
    col = consts.col
    lev = 2   # level axis of a (B, 2, kx, mx, nx) field

    dmeanc = torch.einsum("k,bckmn->bcmn", col.dhs[:, 0, 0], div)
    psdt = psdt - dmeanc
    psdt[..., 0, 0] = 0.0

    # sigma-dot on half levels (B, 2, kx+1, mx, nx); note the reference
    # accumulates only through k=kx-1 so the bottom boundary stays zero.
    zero2 = torch.zeros_like(div[:, :, :1])
    flux = col.dhs[:-1] * (div[:, :, :-1] - dmeanc[:, :, None])
    sigdtc = torch.cat([zero2, -torch.cumsum(flux, dim=lev), zero2], dim=lev)

    dumk = torch.cat(
        [zero2, sigdtc[:, :, 1:-1] * (col.tref[1:] - col.tref[:-1]), zero2],
        dim=lev)

    tdt = (tdt - (dumk[:, :, 1:] + dumk[:, :, :-1]) * col.dhsr
           + col.tref3 * (sigdtc[:, :, 1:] + sigdtc[:, :, :-1])
           - im.tref2[:, None, None] * dmeanc[:, :, None])

    divdt = divdt - S.laplacian(
        sp, phi + pc.RGAS * col.tref * ps[:, :, None])

    return divdt, tdt, psdt
