"""Column-physics driver (reference: speedy.f90/physics.f90).

Sequencing matches physics.f90:14-256: convection -> large-scale condensation
-> shortwave (every nstrad steps, with absorbed fluxes and LW transmissivities
cached in the state) -> longwave down -> surface fluxes -> longwave up ->
vertical diffusion -> surface-flux tendencies -> SPPT.

`grid_physics` is the whole grid-space physics chain as a function of explicit
member-batched tensors (no state dict), column-local by construction. It is
the plain PyTorch version of the CUDA kernel ``csrc/grid_physics.cu``: it runs
for CPU tensors, and is the kernel's yardstick of correctness on the card.
`get_physical_tendencies` is the state-dict glue around it; it goes through
``ops.column_kernels.grid_physics``, which launches the kernel for CUDA
tensors.
"""

from __future__ import annotations

import torch

from .. import constants as pc
from ..models.geopotential import (hydrostatic_grid_levels,
                                   hydrostatic_m0corr)
from ..ops import spectral as S
from ..ops.column_kernels import grid_physics as dispatch_grid_physics
from . import convection as conv
from . import large_scale_condensation as lsc
from . import longwave_radiation as lw
from . import shortwave_radiation as sw
from . import surface_fluxes as sflx
from . import vertical_diffusion as vdif
from ._levels import LEV, col, lev
from .humidity import spec_hum_to_rel_hum

__all__ = ["get_physical_tendencies", "grid_physics", "physics_grid_inputs",
           "BC_FIELDS", "CACHE_FIELDS", "DIAG_FIELDS"]

# 2D boundary/forcing fields consumed by the grid physics (read-only here).
BC_FIELDS = (
    "fmask_land", "phis0", "forog", "sst_am", "alb_land", "alb_sea",
    "alb_surface", "snowc", "land_temp", "soil_avail_water",
    "zenit_correction", "flux_solar_in", "flux_ozone_upper",
    "flux_ozone_lower", "stratospheric_correction", "ssti_om",
)

# The nstrad shortwave cache: read on every step, rewritten on SW steps.
CACHE_FIELDS = ("tt_rsw", "rad_tau2", "rad_strat_corr", "tsr", "ssrd",
                "ssr", "qcloud_equiv")

# Per-step diagnostics written back into the state.
DIAG_FIELDS = ("cbmf", "precnv", "precls", "slrd", "slr", "olr",
               "ustr", "vstr", "shf", "evap", "slru", "hfluxn",
               "rad_flux", "rad_st4a")


def grid_physics(consts, sw_flag: bool, ug, vg, tg, qg, phig, pslg, bc, cache,
                 ablco2, phisg=None, m0corr=None, sppt_pattern=None):
    """The full grid-space physics chain (physics.f90:107-232) on explicit
    member-batched tensors: ug/vg/tg/qg/phig (B, kx, il, ix), pslg
    (B, il, ix), `bc` the 16 BC_FIELDS (each shared (il, ix), zonal (il, 1) or
    with a leading member axis), `cache` the 7 CACHE_FIELDS of the last
    shortwave step (read when sw_flag is False, may be () otherwise), ablco2
    0-d or (B,).

    Returns (utend, vtend, ttend, qtend, diag, new_cache) where the
    tendencies are the PHYSICS-ONLY contributions (added to the dynamics
    tendencies by the caller) and diag/new_cache are tuples ordered as
    DIAG_FIELDS / CACHE_FIELDS. On a step without shortwave new_cache is
    `cache` itself.

    phig=None reconstructs the geopotential by the column-local hydrostatic
    recursion from tg, phisg (grid surface geopotential, (il, ix)) and m0corr
    (the zonally-uniform m=0 lapse-rate correction, (B, kx, il, 1), see
    `models.geopotential.hydrostatic_m0corr`): exact commutation with geopotential.f90:49-77.

    sppt_pattern, when given, is the (B, kx, il, ix) SPPT field: the four
    tendencies are multiplied by 1 + pattern.

    With consts.bf16_tendencies the four tendencies are cast to bfloat16 at
    the end, after the SPPT multiply (the kernel rounds at its stores); the
    diagnostics and the radiation cache keep full precision.
    """
    geom = consts.geom
    kx = consts.params.kx
    sw_flag = bool(sw_flag)
    if phig is None:
        phig = hydrostatic_grid_levels(consts.gp, tg, phisg) + m0corr
    (fmask_land, phis0, forog, sst_am, alb_land, alb_sea, alb_surface,
     snowc, land_temp, soil_avail_water, zenit_correction, flux_solar_in,
     flux_ozone_upper, flux_ozone_lower, stratospheric_correction,
     ssti_om) = bc
    if not sw_flag and len(cache) != len(CACHE_FIELDS):
        raise ValueError("a step without shortwave needs the 7 cache fields")
    if ablco2.dim() == 1:
        ablco2 = ablco2.reshape(-1, 1, 1)   # one value per member
    up = lambda x: x.unsqueeze(LEV)

    # --- thermodynamics (physics.f90:107-116) ---
    psg = torch.exp(pslg)
    rps = 1.0 / psg
    qg = torch.clamp(qg, min=0.0)
    se = pc.CP * tg + phig
    rh, qsat = spec_hum_to_rel_hum(tg, up(psg), col(geom.fsg, tg), qg)

    # --- deep convection (physics.f90:123-132) ---
    iptop, cbmf, precnv, dfse, dfqa = conv.get_convection_tendencies(
        geom, psg, se, qg, qsat)
    # Flux -> tendency scaling for levels 2..kx (physics.f90:127-130);
    # level 1 carries no convective flux, so a masked multiply is exact.
    lvl_mask = torch.ones((kx, 1, 1), dtype=tg.dtype, device=tg.device)
    lvl_mask[0] = 0.0
    scale_t = up(rps) * col(geom.grdscp, tg)
    scale_q = up(rps) * col(geom.grdsig, tg)
    tt_cnv = dfse * (scale_t * lvl_mask)
    qt_cnv = dfqa * (scale_q * lvl_mask)
    icnv = kx - iptop

    # --- large-scale condensation (physics.f90:135-139) ---
    iptop, precls, tt_lsc, qt_lsc = lsc.get_large_scale_condensation_tendencies(
        geom, psg, qg, qsat, iptop)

    ttend = tt_cnv + tt_lsc
    qtend = qt_cnv + qt_lsc

    # --- shortwave (every nstrad steps; physics.f90:151-169) ---
    if sw_flag:
        gse = (lev(se, kx - 2) - lev(se, kx - 1)) / (
            lev(phig, kx - 2) - lev(phig, kx - 1))
        icltop, cloudc, clstr, qcloud = sw.clouds(
            qg, rh, precnv, precls, iptop, gse, fmask_land)
        sw_state = {
            "zenit_correction": zenit_correction,
            "flux_solar_in": flux_solar_in,
            "flux_ozone_upper": flux_ozone_upper,
            "flux_ozone_lower": flux_ozone_lower,
            "alb_surface": alb_surface,
            "stratospheric_correction": stratospheric_correction,
            "air_absortivity_co2": ablco2,
            "qcloud_equiv": qcloud,
        }
        tsr, ssrd, ssr, tt_flux, rad_tau2, rad_sc = sw.get_shortwave_rad_fluxes(
            geom, sw_state, psg, qg, icltop, cloudc, clstr)
        tt_rsw = tt_flux * scale_t
        new_cache = (tt_rsw, rad_tau2, rad_sc, tsr, ssrd, ssr, qcloud)
    else:
        new_cache = tuple(cache)
        tt_rsw, rad_tau2, rad_sc, tsr, ssrd, ssr, qcloud = new_cache

    # --- longwave downward (physics.f90:172-174) ---
    fband = consts.fband
    slrd, tt_rlw, rad_flux, rad_st4a = lw.get_downward_longwave_rad_fluxes(
        geom, fband, rad_tau2, tg)

    # --- surface fluxes (physics.f90:177-198) ---
    fl = sflx.get_surface_fluxes(
        geom, psg, ug, vg, tg, qg, rh, phig,
        phis0, fmask_land, forog, sst_am,
        ssrd, slrd, alb_land, alb_sea, snowc,
        land_temp, soil_avail_water, lfluxland=True)
    if consts.sea_coupling_flag > 0:
        # second, sea-only call with the ocean-model SST (physics.f90:186-195)
        fl = sflx.get_surface_fluxes(
            geom, psg, ug, vg, tg, qg, rh, phig,
            phis0, fmask_land, forog, ssti_om,
            ssrd, slrd, alb_land, alb_sea, snowc,
            land_temp, soil_avail_water, lfluxland=False, prev=fl["_carry"])
    hfluxn3 = torch.cat(
        [fl["hfluxn"], torch.zeros_like(fl["hfluxn"][..., :1, :, :])],
        dim=LEV)

    # --- longwave upward (physics.f90:202-211) ---
    fsfc, ftop, tt_rlw = lw.get_upward_longwave_rad_fluxes(
        geom, fband, rad_tau2, rad_st4a, rad_sc, tg, fl["tsfc"], slrd,
        lev(fl["slru"], 2), tt_rlw, rad_flux)
    tt_rlw = tt_rlw * scale_t

    ttend = ttend + tt_rsw + tt_rlw

    # --- vertical diffusion + shallow convection (physics.f90:218-220) ---
    utend, vtend, tt_pbl, qt_pbl = vdif.get_vertical_diffusion_tend(
        geom, se, rh, qg, qsat, phig, icnv)

    # surface-flux tendencies into the lowest layer (physics.f90:223-226),
    # one-hot adds instead of scattered updates
    bot = torch.zeros((kx, 1, 1), dtype=tg.dtype, device=tg.device)
    bot[kx - 1] = 1.0
    gsig = rps * float(geom.grdsig[kx - 1])
    gscp = rps * float(geom.grdscp[kx - 1])
    utend = utend + bot * up(lev(fl["ustr"], 2) * gsig)
    vtend = vtend + bot * up(lev(fl["vstr"], 2) * gsig)
    ttend = ttend + tt_pbl + bot * up(lev(fl["shf"], 2) * gscp)
    qtend = qtend + qt_pbl + bot * up(lev(fl["evap"], 2) * gsig)

    diag = (cbmf, precnv, precls, slrd, fsfc, ftop,
            fl["ustr"], fl["vstr"], fl["shf"], fl["evap"], fl["slru"],
            hfluxn3, rad_flux, rad_st4a)
    if sppt_pattern is not None:
        # SPPT multiplies the PHYSICS-ONLY tendency by 1 + pattern
        # (physics.f90:234-248: f*(tend - tend_dyn) + tend_dyn, and the
        # outputs here ARE tend - tend_dyn). mu = 1: no vertical tapering
        # (sppt.f90:20).
        f = 1.0 + sppt_pattern
        utend = f * utend
        vtend = f * vtend
        ttend = f * ttend
        qtend = f * qtend
    if consts.bf16_tendencies:
        utend, vtend, ttend, qtend = (
            x.to(torch.bfloat16) for x in (utend, vtend, ttend, qtend))
    return utend, vtend, ttend, qtend, diag, new_cache


def physics_grid_inputs(consts, state, sw_flag: bool):
    """What `grid_physics` takes, from the member-batched state at time level
    0 (physics.f90:89-101): returns (args, kwargs) with args = (ug, vg, tg,
    qg, phig, pslg, bc, cache, ablco2) and kwargs = {phisg, m0corr}.

    With consts.grid_phi the phi stack is not transformed: phig is None and
    the hydrostatic recursion runs inside grid_physics (inside the kernel on
    the card, which also saves the phig round trip through memory); only the
    small zonally-uniform m=0 lapse-rate correction is synthesized here."""
    sp = consts.sp
    pdim = 1
    # kcos=2 scales the winds by 1/cos(lat) (inside the fused transform
    # kernel on the card). The physics kernel takes dense tensors: the fused
    # kernel and the fft route return one (contiguous() is then a no-op), an
    # einsum of the third route may return a permuted view.
    to_grid = lambda f, kcos=1: S.spec2grid_p(sp, f, kcos, pdim).contiguous()
    ucos, vcos = S.vort2vel_p(sp, state["vor"][0], state["div"][0], pdim)
    t_spec = state["t"][0]
    ug = to_grid(ucos, 2)
    vg = to_grid(vcos, 2)
    tg = to_grid(t_spec)
    qg = to_grid(state["tr"][0][:, :, 0])
    pslg = to_grid(state["ps"][0])
    phig = phisg = m0corr = None
    if consts.grid_phi:
        phisg = state["phisg"]
        m0corr = hydrostatic_m0corr(consts.gp, sp, t_spec).contiguous()
    else:
        phig = to_grid(state["phi"])

    bc = tuple(state[name] for name in BC_FIELDS)
    # A shortwave step never reads the cache: pass none. On the other steps
    # the kernel reads it in place, so an expanded view (a freshly broadcast
    # state) is materialised once; the state then carries the dense copy.
    cache = () if sw_flag else tuple(state[name].contiguous()
                                     for name in CACHE_FIELDS)
    args = (ug, vg, tg, qg, phig, pslg, bc, cache,
            state["air_absortivity_co2"])
    return args, {"phisg": phisg, "m0corr": m0corr}


def get_physical_tendencies(consts, state, ctx, utend, vtend, ttend,
                            trtend_flat):
    """Add physics tendencies at time level 0 (physics.f90:14-256) to the
    member-batched dynamics tendencies; trtend_flat is (B, ntr*kx, il, ix)
    and humidity is tracer 0.

    ctx["compute_shortwave"] (a Python bool) selects the fresh or the cached
    shortwave branch; ctx may carry "sppt_pattern" (B, kx, il, ix). Returns
    (utend, vtend, ttend, trtend_flat, state); the state comes back with the
    DIAG_FIELDS and CACHE_FIELDS written, all member-batched. With
    consts.bf16_tendencies both sets of tendencies are bfloat16 and the adds
    below stay in that type (one rounding per add), as in the JAX package."""
    kx = consts.params.kx
    sw_flag = bool(ctx["compute_shortwave"])
    args, kwargs = physics_grid_inputs(consts, state, sw_flag)
    ut, vt, tt, qt, diag, new_cache = dispatch_grid_physics(
        grid_physics, consts, sw_flag, *args, **kwargs,
        sppt_pattern=ctx.get("sppt_pattern"))

    state = dict(state)
    state.update(zip(DIAG_FIELDS, diag))
    state.update(zip(CACHE_FIELDS, new_cache))

    utend = utend + ut
    vtend = vtend + vt
    ttend = ttend + tt
    trtend_flat = torch.cat([trtend_flat[:, :kx] + qt, trtend_flat[:, kx:]],
                            dim=1)
    return utend, vtend, ttend, trtend_flat, state
