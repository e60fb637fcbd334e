"""Model assembly: constants container, state allocation, the full
initialization sequence, and the per-step update.

Reference call-stack parity: initialization.f90:13-91 for `initialize`,
speedy.f90:20-74 (do_single_step) for the per-step sequence. The step is
written member-batched: the fields it carries have a leading member axis B
(B = 1 is the single-member run), everything else is shared by all members.
The N-step loop is a Python loop or a replay of CUDA graphs of the step
(parallel/ensemble.py); the calendar scalars of each step stay on the host,
and what the step needs of them reaches it as device tables
(coupler_tables).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from .. import constants as pc
from .. import resolve_device
from ..coupling.coupler import couple_sea_land, initialize_coupler
from ..coupling.forcing import set_forcing
from ..coupling.interpolation import (N_COUPLER_ROWS, N_COUPLER_WEIGHTS,
                                     CouplerTables, coupler_rows)
from ..coupling.land import land_model_init
from ..coupling.sea import sea_model_init
from ..ops import glue_kernels as GK
from ..ops import spectral as S
from ..ops.column_kernels import (ColumnTables, PhysicsTables,
                                  build_column_tables, build_physics_tables)
from ..ops.geometry import Geometry, build_geometry
from ..params import ModelParams
from ..physics import sppt as sppt_mod
from ..physics.driver import get_physical_tendencies
from ..physics.longwave_radiation import radset
from ..physics.surface_fluxes import set_orog_land_sfc_drag
from ..registry import MODEL_STATE_VARS, internal_shape, is_tlev
from ..utils.calendar import ModelCalendar
from .diagnostics import check_diagnostics
from .geopotential import build_geopot
from .implicit import _tref_profile, build_hordif, build_implicit
from .prognostics import initialize_from_rest_state
from .timestep import step

__all__ = ["Consts", "build_consts", "allocate_state", "initialize",
           "build_step_ctx", "coupler_tables", "daily_forcing", "step_body",
           "make_single_step", "SpeedyError",
           "DYNAMIC_FIELDS", "EPHEMERAL_FIELDS", "CARRY_FIELDS",
           "split_state", "add_member_axis", "ensure_member_axis",
           "single_member_ndim", "band_consts", "shard_consts"]


class SpeedyError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Consts:
    """Static tables and flags the step functions read. Every tensor lies on
    one device (`device`) in the model dtype."""

    params: ModelParams
    sp: Any                 # SpectralTransform
    geom: Geometry          # numpy, model dtype: feeds host-side scalars
    hd: Any                 # HorDiffusion
    gp: Any                 # GeopotTables
    implicit: Any           # ImplicitTables for the current dt
    fband: Any              # (301, 4)
    col: ColumnTables       # level/latitude tables of the grid-dynamics kernel
    phys: PhysicsTables     # level/latitude tables of the physics kernel
    sppt: Any = None        # SpptTables when params.sppt_on
    # NB: increase_co2 / land_coupling_flag / sst_anomaly_coupling_flag are
    # NOT consts: they are runtime-settable state scalars (0-d device
    # tensors), matching the reference registry. See allocate_state.
    sea_coupling_flag: int = 0  # compile-time in the reference (sea_model.f90:14-20)
    physics_on: bool = True
    # Reconstruct the physics-path geopotential by grid-space hydrostatic
    # integration of the already-transformed temperature (inside the physics
    # kernel on the card) instead of inverse-transforming the phi stack:
    # exact commutation of two linear operators, kx field-levels of synthesis
    # saved per step. Differs from the reference-ordered spectral path only
    # in summation order, so the CPU parity path keeps it off.
    grid_phi: bool = False
    # Emit the TENDENCY-class grid outputs (dynamics tendencies, flux-form
    # products, kinetic energy, physics tendencies) in bfloat16 from inside
    # the two column kernels, so that the direct transforms read 2-byte
    # operands (bfloat16 tables, float32 accumulation; spectral results stay
    # float32). Rounds each per-step increment at about 2^-9 relative; the
    # prognostic state and the synthesis stay full precision. float32 on the
    # dense transform route only. Off by default on every device: its effect
    # on the climate has not been measured with this package. Kept by the
    # batched runner, stripped by the initialization (both bootstrap steps
    # run at full precision), as in the JAX package.
    bf16_tendencies: bool = False

    def with_implicit(self, im) -> "Consts":
        return dataclasses.replace(self, implicit=im)

    @functools.cached_property
    def update_tables(self):
        """The spectral-update kernel's tables for these sp, hd, implicit
        and col (ops/glue_kernels.py::build_update_tables), built at first
        use, once per Consts: a Consts is never changed in place, and
        with_implicit gives each start-up time step a Consts of its own."""
        return GK.build_update_tables(self)

    @property
    def device(self) -> torch.device:
        return self.sp.device


def build_consts(params: ModelParams, device="cuda", physics_on: bool = True,
                 sea_coupling_flag: int = 0, grid_phi: bool | None = None,
                 bf16_tendencies: bool = False) -> tuple[Consts, Geometry]:
    """Build all static tables on `device`. Returns (consts, numpy geometry).

    physics_on defaults to True, as in the JAX package. grid_phi (see Consts)
    defaults to on for a CUDA device and off on the CPU. bf16_tendencies
    (see Consts) is taken for precision="f32" on the dense transform route
    and refused by name otherwise: the JAX package silently widens the
    bfloat16 operands there, which rounds for nothing. params.sppt_on=True
    builds the SPPT tables (Consts.sppt); with the physics on, the pattern
    then multiplies the physics tendencies of every step. The zonal
    transform path follows params.fft_mode; "auto" takes the dense matmul
    path on CUDA and torch.fft on the CPU."""
    device = resolve_device(device)
    if grid_phi is None:
        grid_phi = device.type == "cuda"
    if params.fft_mode not in ("auto", "matmul", "fft"):
        raise ValueError(
            f"fft_mode must be 'auto', 'matmul' or 'fft', got "
            f"{params.fft_mode!r}")
    use_matmul = (params.fft_mode == "matmul"
                  or (params.fft_mode == "auto" and device.type == "cuda"))
    if device.type == "cuda":
        # float32 products on the card run in full float32: a TF32 Legendre
        # product (about three decimal digits) would not hold the model's
        # 1e-5 agreement. This is PyTorch's default; stated and set here.
        torch.backends.cuda.matmul.allow_tf32 = False

    geom_np = build_geometry(params)
    sp = S.build_spectral(params, geom_np, use_matmul_fft=use_matmul,
                          device=device)
    if bf16_tendencies and params.precision != "f32":
        raise ValueError(
            f"bf16_tendencies=True needs precision='f32', got "
            f"{params.precision!r}: the bfloat16 outputs and the 2-byte "
            f"transform operands exist for float32 only")
    if bf16_tendencies and not sp.use_dense_legendre:
        raise ValueError(
            f"bf16_tendencies=True needs the dense transform route "
            f"(fft_mode 'matmul', or 'auto' on a CUDA device, at T30, the "
            f"truncation the 2-byte operand mode is built for); "
            f"fft_mode={params.fft_mode!r} at T{params.trunc} on "
            f"{device.type} takes another route, which has no bfloat16 "
            f"operand branch")
    hd = build_hordif(params, geom_np, device)
    gp = build_geopot(params, geom_np, device)
    im = build_implicit(params, geom_np, hd, 2.0 * params.delt, device)
    fband = torch.from_numpy(radset().astype(params.np_dtype)).to(device)
    col = build_column_tables(geom_np, _tref_profile(geom_np),
                              params.np_dtype, device)
    geom = Geometry(*(np.asarray(a, dtype=params.np_dtype) for a in geom_np))
    phys = build_physics_tables(geom, gp, device)
    sppt = (sppt_mod.build_sppt_tables(params, sp.el2.cpu().numpy(), device)
            if params.sppt_on else None)
    consts = Consts(params=params, sp=sp, geom=geom, hd=hd, gp=gp,
                    implicit=im, fband=fband, col=col, phys=phys, sppt=sppt,
                    sea_coupling_flag=sea_coupling_flag,
                    physics_on=physics_on, grid_phi=grid_phi,
                    bf16_tendencies=bool(bf16_tendencies))
    return consts, geom_np


def allocate_state(params: ModelParams, n_months: int = 1,
                   device="cuda") -> dict:
    """Zero-filled single-member model state (the analog of
    ModelState_allocate, model_state.f90:358) in internal layouts, plus
    runtime extras, as tensors on `device`. With params.sppt_on the state
    also carries the SPPT spectrum sppt_spec (2, kx, mx, nx), zero until
    initialize draws it, and the member's noise key sppt_key (two uint32
    words in an int64 tensor; the JAX package's jax.random.key(0))."""
    device = resolve_device(device)
    rdt = params.dtype
    state = {}
    for spec in MODEL_STATE_VARS:
        if spec.name == "current_step":
            continue  # host-side counter
        shape = internal_shape(params, spec, n_months=n_months)
        # Complex-kind (spectral) variables are stored as REAL pairs with a
        # leading c axis of size 2 (ops/spectral.py).
        dtype = {"c": rdt, "r": rdt, "i": torch.int32,
                 "l": torch.bool}[spec.kind]
        cpre = (2,) if spec.kind == "c" else ()
        zeros = lambda shp: torch.zeros(shp, dtype=dtype, device=device)
        if is_tlev(spec):
            # Leapfrog time levels live as a tuple of per-level tensors (see
            # registry.internal_perm): t_levs is the leading internal axis.
            state[spec.name] = tuple(zeros(cpre + shape[1:])
                                     for _ in range(shape[0]))
        else:
            state[spec.name] = zeros(cpre + shape)
    # Defaults (model_state.f90 "Initialize default values")
    scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    state["air_absortivity_co2"] = scalar(6.0, rdt)
    state["ablco2_ref"] = scalar(6.0, rdt)
    state["error_flag"] = scalar(False, torch.bool)
    # Runtime-settable flags (reference defaults, model_state_def.py:305-311,
    # 377-383, 412-418); consumed as device values inside the step.
    state["increase_co2"] = scalar(False, torch.bool)
    state["land_coupling_flag"] = scalar(True, torch.bool)
    state["sst_anomaly_coupling_flag"] = scalar(True, torch.bool)
    if params.sppt_on:
        state.update(sppt_mod.init_sppt_state(params, device=device))
    return state


# Fields the per-step update writes. Everything else is loop-invariant during
# a run: boundary conditions, masks, climatologies, coordinates.
DYNAMIC_FIELDS = frozenset({
    # prognostics + diagnostics (timestep)
    "vor", "div", "t", "ps", "tr", "phi",
    # physics diagnostics
    "precnv", "precls", "cbmf", "tsr", "ssrd", "ssr", "slrd", "slr", "olr",
    "slru", "ustr", "vstr", "shf", "evap", "hfluxn", "tt_rsw", "rad_tau2",
    "rad_flux", "rad_st4a", "rad_strat_corr", "qcloud_equiv",
    # daily forcing
    "flux_solar_in", "flux_ozone_lower", "flux_ozone_upper",
    "zenit_correction", "stratospheric_correction", "snowc", "alb_land",
    "alb_sea", "alb_surface", "tcorh", "qcorh", "air_absortivity_co2",
    # coupled land/sea state
    "stlcl_obs", "snowdcl_obs", "soilwcl_obs", "land_temp", "snow_depth",
    "soil_avail_water", "stl_lm", "sstcl_ob", "sicecl_ob", "ticecl_ob",
    "sstan_ob", "sstan_am", "sst_am", "sice_am", "tice_am", "sst_om",
    "sice_om", "tice_om", "ssti_om",
    # runtime flags / stochastic physics
    "error_flag", "compute_shortwave",
    "sppt_spec", "sppt_key",
})


# Subset of DYNAMIC_FIELDS that the physics recomputes from scratch every
# step BEFORE any consumer reads them (the land/sea coupler consumes hfluxn,
# shf and evap of the SAME step). With physics off nothing writes them: they
# stay single-member (no member axis) and the coupler reads them as zero
# fluxes shared by all members. With physics on every step writes them
# member-batched, whatever layout they had on the way in.
EPHEMERAL_FIELDS = frozenset({
    "rad_flux", "rad_st4a", "slrd", "slr", "olr", "precnv", "precls",
    "cbmf", "ustr", "vstr", "shf", "evap", "slru", "hfluxn",
})

# The fields that carry a leading member axis in the batched layout.
CARRY_FIELDS = DYNAMIC_FIELDS - EPHEMERAL_FIELDS


def _single_member_ndims() -> dict:
    """Number of axes of each state field in the single-member layout."""
    # Runtime extras that the registry does not list: the blow-up flag and
    # the forcing's spectral corrections (real pairs (2, mx, nx)).
    # The SPPT spectrum is a real pair (2, kx, mx, nx), its key two words.
    nd = {"error_flag": 0, "tcorh": 3, "qcorh": 3, "sppt_spec": 4,
          "sppt_key": 1}
    for spec in MODEL_STATE_VARS:
        nd[spec.name] = (len(spec.dims) - (1 if is_tlev(spec) else 0)
                         + (1 if spec.kind == "c" else 0))
    return nd


_NDIM = _single_member_ndims()


def single_member_ndim(name: str) -> int:
    """Number of axes of state field `name` in the single-member layout (a
    leapfrog field's per-level tensors)."""
    return _NDIM[name]


def split_state(state: dict, carry_fields=DYNAMIC_FIELDS):
    """(dynamic, static) partition of the state dict."""
    dyn = {k: v for k, v in state.items() if k in carry_fields}
    static = {k: v for k, v in state.items() if k not in carry_fields}
    return dyn, static


def _map_levels(fn, val):
    return tuple(fn(a) for a in val) if isinstance(val, tuple) else fn(val)


def add_member_axis(state: dict, n_members: int) -> dict:
    """Single-member state -> member-batched layout: the CARRY_FIELDS get a
    leading member axis of size n_members (an expanded view: members share
    storage until the step writes new tensors), the rest stays shared."""
    rep = lambda a: a.expand(n_members, *a.shape)
    return {k: (_map_levels(rep, v) if k in CARRY_FIELDS else v)
            for k, v in state.items()}


def ensure_member_axis(state: dict, n_members: int) -> dict:
    """Give a member axis to every carried field that lacks one. The forcing
    and the coupler compute some carried fields from shared inputs alone
    (climatology interpolations, tcorh); those come out without a member
    axis and are expanded here, so the batched layout holds after every
    step. Costs no device work: expand is a view."""
    out = dict(state)
    for name in CARRY_FIELDS:
        val = out.get(name)
        if val is None:
            continue
        base = _NDIM[name]
        fix = lambda a: (a.expand(n_members, *a.shape)
                         if a.dim() == base else a)
        out[name] = _map_levels(fix, val)
    return out


# The per-latitude vectors of a Geometry: a band keeps its rows of them.
_LATITUDE_FIELDS = ("radang", "coriol", "sia", "coa", "cosg", "cosgr",
                    "cosgr2")


def band_consts(consts: Consts, n_space: int, index: int,
                group=None) -> Consts:
    """The Consts of latitude band `index` of `n_space` (a space-sharded
    mesh's step; `group` is the "space" process group its direct transforms
    reduce over): the band transform (parallel/shard_transforms.py, never on
    the kernel route) and the band's rows of every per-latitude table, the
    geometry's latitude vectors (the daily forcing's zonal fields, the
    surface fluxes), the grid-dynamics kernel's rcos and coriol and the
    physics kernel's sqrtcoa. The m=0 geopotential correction reads the
    band transform's cpol_inv_full. Everything else (levels, spectral
    tables, SPPT's spectral amplitudes) is the same on every band. Without
    a group the transforms raise: such Consts serve the column kernels."""
    from ..parallel.shard_transforms import band_transform

    sp = band_transform(consts.sp, n_space, index, group)
    rows = sp.band.rows
    geom = consts.geom._replace(**{
        f: getattr(consts.geom, f)[rows] for f in _LATITUDE_FIELDS})
    col = consts.col._replace(rcos=consts.col.rcos[rows].contiguous(),
                              coriol=consts.col.coriol[rows].contiguous())
    phys = consts.phys._replace(
        sqrtcoa=consts.phys.sqrtcoa[rows].contiguous())
    return dataclasses.replace(consts, sp=sp, geom=geom, col=col, phys=phys)


def shard_consts(consts: Consts, mesh) -> Consts:
    """The Consts of this rank's latitude band on `mesh` (band_consts with
    the mesh's "space" size, this rank's band and the "space" group);
    `consts` itself where "space" has one rank."""
    from ..parallel.mesh import space_band

    n_space, index, group = space_band(mesh)
    if n_space == 1:
        return consts
    return band_consts(consts, n_space, index, group)


def _physics_fn(consts):
    return get_physical_tendencies if consts.physics_on else None


def _drop_member_axis(state: dict, physics_on: bool = False) -> dict:
    """Member-batched state with B = 1 -> single-member layout. With the
    physics on the ephemeral diagnostics are member-batched too."""
    first = lambda a: a[0]
    batched = DYNAMIC_FIELDS if physics_on else CARRY_FIELDS
    return {k: (_map_levels(first, v) if k in batched else v)
            for k, v in state.items()}


def initialize(consts: Consts, state: dict, host_bc: dict,
               cal: ModelCalendar) -> dict:
    """Full initialization sequence (initialization.f90:13-91):
    boundaries -> rest-state prognostics -> coupler init -> forcing ->
    first_step bootstrap. host_bc holds the numpy BC fields in internal
    (month/lat/lon-leading) layouts. Takes and returns a single-member
    state; the coupler, the forcing and the two bootstrap steps run through
    the member-batched step at B = 1 (on the card, through the CUDA kernels),
    at full precision: consts.bf16_tendencies is stripped here."""
    consts = dataclasses.replace(consts, bf16_tendencies=False)
    params = consts.params
    sp = consts.sp
    device = consts.device
    geom_np = host_bc["_geom_np"]
    rdt = params.np_dtype
    dev = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(rdt))).to(device)

    # Boundary fields (boundaries.f90:22-37) + host-side land/sea model
    # initialization (numpy; needs only the raw BC arrays).
    state = dict(state)
    for name in ("orog", "fmask_orig", "alb0", "veg_high", "veg_low",
                 "soil_wc_l1", "soil_wc_l2", "soil_wc_l3"):
        state[name] = dev(host_bc[name])

    land = land_model_init(params, {k: host_bc[k] for k in (
        "fmask_orig", "stl12", "snowd12", "veg_high", "veg_low",
        "soil_wc_l1", "soil_wc_l2", "alb0")})
    for k, v in land.items():
        state[k] = dev(v)

    sea = sea_model_init(params, {k: host_bc[k] for k in (
        "fmask_orig", "sst12", "sea_ice_frac12", "sst_anom")},
        geom_np.radang)
    for k, v in sea.items():
        state[k] = dev(v)

    phi0 = pc.GRAV * state["orog"]
    state["phi0"] = phi0
    state["phis0"] = S.grid_filter(sp, phi0)
    state["forog"] = set_orog_land_sfc_drag(state["phis0"])
    state["fband"] = consts.fband

    # Prognostics from the rest state (prognostics.f90:22-120)
    state = initialize_from_rest_state(consts, state)
    state["ablco2_ref"] = state["air_absortivity_co2"]
    # Stationary-variance SPPT spectrum (sppt.f90:92) before the bootstrap
    # steps advance it; each of those steps draws its own noise (stepno 0
    # and 1, one group each), as in the JAX package.
    if params.sppt_on:
        state["sppt_spec"] = sppt_mod.stationary_draw(consts,
                                                      state["sppt_key"])

    st = add_member_axis(state, 1)
    bad0 = check_diagnostics(consts, st, 0)

    # Coupler day-0 exchange (coupler.f90:12-32)
    st = initialize_coupler(consts, st, CouplerTables.from_host(
        *coupler_rows(cal.imont1, cal.tmonth, cal.month_idx),
        state["sst_anom"].shape[0], params.dtype, device))
    st = ensure_member_axis(st, 1)

    # Forcing, imode=0 (forcing.f90:43-48 + daily part)
    st = set_forcing(consts, st, cal.year + cal.tyear, cal.tyear)
    st["error_flag"] = st["error_flag"] | bad0

    # First-step bootstrap: dt/2, dt (time_stepping.f90:13-27), each with
    # its own implicit tables. The reference's compute_shortwave flag
    # defaults to .true. (model_state.f90:780), so both bootstrap steps run
    # the shortwave.
    im_half = build_implicit(params, geom_np, consts.hd, 0.5 * params.delt,
                             device)
    im_full = build_implicit(params, geom_np, consts.hd, params.delt, device)
    pf = _physics_fn(consts)
    st = step(consts.with_implicit(im_half), st, 1, 1, 0.5 * params.delt,
              pf, {"compute_shortwave": True, "stepno": 0})
    st = step(consts.with_implicit(im_full), st, 1, 2, params.delt,
              pf, {"compute_shortwave": True, "stepno": 1})
    state = _drop_member_axis(st, consts.physics_on)

    if bool(bad0.any()):
        raise SpeedyError("Initial state failed the diagnostics check")

    # Coordinates (initialization.f90:85-87)
    state["lev"] = dev(geom_np.fsg)
    state["lon"] = dev(360.0 / params.ix * np.arange(params.ix))
    state["lat"] = dev(geom_np.radang * 90.0 / np.arcsin(1.0))
    return state


def build_step_ctx(cal: ModelCalendar, current_step: int, n_steps: int):
    """Precompute per-step calendar scalars for an n-step run, on the host.

    Returns (ctx dict of numpy arrays of length n_steps, calendar after n
    steps). For step i: do_forcing/tyear/year_frac describe the pre-step
    date; imont1/tmonth/month_idx the post-advance date used by the coupler
    (speedy.f90:47-72), from which the runner makes the coupler's device
    tables once per run call (coupler_tables)."""
    do_forcing = np.zeros(n_steps, dtype=bool)
    compute_sw = np.zeros(n_steps, dtype=bool)
    tyear = np.zeros(n_steps)
    year_frac = np.zeros(n_steps)
    imont1 = np.zeros(n_steps, dtype=np.int32)
    tmonth = np.zeros(n_steps)
    month_idx = np.zeros(n_steps, dtype=np.int32)

    for i in range(n_steps):
        stepno = current_step + i
        do_forcing[i] = stepno % cal.nsteps == 0
        compute_sw[i] = stepno % 3 == 0
        tyear[i] = cal.tyear
        year_frac[i] = cal.year + cal.tyear
        cal.advance()
        imont1[i] = cal.imont1
        tmonth[i] = cal.tmonth
        month_idx[i] = cal.month_idx

    ctx = {
        "do_forcing": do_forcing,
        "compute_shortwave": compute_sw,
        "tyear": tyear,
        "year_frac": year_frac,
        "imont1": imont1,
        "tmonth": tmonth,
        "month_idx": month_idx,
        "stepno": np.arange(current_step, current_step + n_steps,
                            dtype=np.int32),
    }
    return ctx, cal


def coupler_tables(consts: Consts, state: dict, ctx) -> CouplerTables:
    """The coupler tables of a run call's steps: the month rows ((n_steps,
    9) int64) and weights ((n_steps, 7), the model dtype) of the coupler's
    interpolations at each step's advanced date (ctx's imont1, tmonth and
    month_idx: coupling/interpolation.py::coupler_rows, float64 on the
    host), moved to the consts' device at once. Raises IndexError for a
    step past the end of the state's SST anomaly record."""
    n_steps = len(ctx["stepno"])
    rows = np.zeros((n_steps, N_COUPLER_ROWS), dtype=np.int64)
    weights = np.zeros((n_steps, N_COUPLER_WEIGHTS))
    for i in range(n_steps):
        rows[i], weights[i] = coupler_rows(int(ctx["imont1"][i]),
                                           float(ctx["tmonth"][i]),
                                           int(ctx["month_idx"][i]))
    return CouplerTables.from_host(rows, weights, state["sst_anom"].shape[0],
                                   consts.params.dtype, consts.device)


def daily_forcing(consts: Consts, state: dict, ctx_i) -> dict:
    """The first part of a step (speedy.f90:47-50): the daily forcing when
    the step starts a day, else nothing. The calendar is on the host, so
    this is a plain branch; set_forcing builds the zonal fields in numpy
    and copies them to the device, so this part always runs eagerly, on the
    host's schedule. Returns a new state dict."""
    if ctx_i["do_forcing"]:
        return set_forcing(consts, state, float(ctx_i["year_frac"]),
                           float(ctx_i["tyear"]))
    return dict(state)


def step_body(consts: Consts, state: dict, shortwave: bool,
              coupler: CouplerTables, sppt_se=None, out=None) -> dict:
    """The rest of a step (speedy.f90:51-72) on the member-batched state:
    the leapfrog step with the physics (the shortwave variant when
    `shortwave`), the diagnostics check, the coupler exchange at the
    advanced date (`coupler`: that date's tables on the device) and, with
    SPPT, the step's noise `sppt_se` (sigma * eta, (B, 2, kx, mx, nx)).
    Nothing here reads a host value but `shortwave`, the step length and
    the consts, and nothing reads a device value back: the function a CUDA
    graph of the step records (parallel/ensemble.py::StepGraphs), keyed on
    `shortwave`.

    `out`, when given, is a dense tensor by field for the step to write
    into (the graph path passes its static buffers: for every field but the
    leapfrog pairs the tensors of `state` itself, for the pairs a second
    set): what the step writes through its kernels and its last elementwise
    passes goes straight there (timestep.step, couple_sea_land), so the
    returned state holds those tensors themselves. Without it every field
    written comes back as a new tensor."""
    nmem = state["vor"][0].shape[0]
    state = dict(state)
    if out is None:
        state["compute_shortwave"] = state["compute_shortwave"].new_full(
            (nmem,), shortwave)
    else:
        state["compute_shortwave"] = out["compute_shortwave"].fill_(
            shortwave)
    pctx = {"compute_shortwave": shortwave}
    if sppt_se is not None:
        pctx["sppt_se"] = sppt_se
    state = step(consts, state, 2, 2, 2.0 * consts.params.delt,
                 _physics_fn(consts), pctx, out=out)

    bad = check_diagnostics(consts, state, 1)
    state["error_flag"] = torch.bitwise_or(
        state["error_flag"], bad,
        out=None if out is None else out["error_flag"])

    # Coupler exchange at the advanced date (speedy.f90:69-72)
    state = couple_sea_land(consts, state, coupler, out)
    return ensure_member_axis(state, nmem)


def make_single_step(consts: Consts):
    """The full per-step update (the body of do_single_step,
    speedy.f90:20-74) as a state -> state function on the member-batched
    state: daily_forcing, then step_body. ctx_i carries the step's calendar
    scalars as Python values, its coupler tables on the device ("coupler")
    and, with SPPT, its noise ("sppt_se"). The shortwave flag is one of the
    scalars: every step is specialised on it on the host, and the physics
    kernel is launched in the matching variant."""

    def single_step(state, ctx_i):
        state = daily_forcing(consts, state, ctx_i)
        return step_body(consts, state, bool(ctx_i["compute_shortwave"]),
                         ctx_i["coupler"], ctx_i.get("sppt_se"))

    return single_step
