"""The redesigned column-parallel kernels: the column physics
(pyspeedy_tpu_torch/csrc/grid_physics.cu) and the member-tiled spectral
update (pyspeedy_tpu_torch/csrc/spectral_update.cu).

Both kernels keep their function; what changed is where values live. Here,
on the CPU, what the host hands them:

* the physics tables as the kernel receives them, in the model's scalar type,
  equal to the plain schemes' tables rounded to that type;
* the spectral update's per-row tables (the eleven (mx, nx) tables, gradx and
  the implicit inverses laid out by m row) against the plain version's
  layout, built once per Consts, so once for each of the three start-up
  time steps, and never on the CPU path;
* what the wrappers refuse, before anything is built or loaded.

The gpu-marked tests hold both kernels against their plain versions on the
card in every mode they take, and a member's result bitwise across tile
positions and batch widths. This file imports nothing of the JAX package, so
that ``python -m pytest tests/test_torch_column_redesign.py -m gpu`` runs on a
machine with a card and no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch.models import implicit as timp
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models import spectral_glue as TG
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import glue_kernels as GK
from pyspeedy_tpu_torch.params import T30L5, T30L8, T47L8, T63L8
from pyspeedy_tpu_torch.physics import convection as conv
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.physics import large_scale_condensation as lsc
from pyspeedy_tpu_torch.physics import shortwave_radiation as sw
from pyspeedy_tpu_torch.physics import vertical_diffusion as vdif

torch.set_num_threads(1)

NP_DTYPE = {"f64": np.float64, "f32": np.float32}
# The three time steps of the start-up sequence (factors of delt).
DT_FACTORS = (0.5, 1.0, 2.0)
_cache = {}


def consts_for(preset, prec, device="cpu", physics_on=True, sea=0):
    key = (preset.kx, preset.ntr, prec, device, physics_on, sea)
    if key not in _cache:
        params = dataclasses.replace(preset, precision=prec, fft_mode="matmul")
        _cache[key] = TM.build_consts(params, device=device,
                                      physics_on=physics_on,
                                      sea_coupling_flag=sea)
    return _cache[key]


# ---------------------------------------------------------------------------
# The physics kernel's tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("preset", [T30L8, T30L5], ids=["L8", "L5"])
def test_physics_tables_arrive_in_the_scalar_type(preset, prec):
    """The 17 level rows and 8 scalars the kernel copies into its
    PhysTables<T>: in the model's scalar type, each equal to what the plain
    schemes compute on the same geometry, rounded to that type."""
    consts, _ = consts_for(preset, prec)
    phys, geom, kx = consts.phys, consts.geom, preset.kx
    dtype = NP_DTYPE[prec]
    assert phys.levels.dtype == dtype and phys.levels.shape == (17 * kx + 8,)
    assert np.array_equal(phys.levels, phys.levels_host.astype(dtype))
    rows = phys.levels[:17 * kx].reshape(17, kx)
    rhref, dqmax, wcol = lsc.lsc_level_tables(geom)
    rsig, rsig1, drh0k, fvdiq2k, gate = vdif.vdiff_level_tables(geom)
    want = [geom.fsg, geom.dhs, geom.grdsig, geom.grdscp,
            np.asarray(geom.wvi)[:, 1], conv.entrainment_profile(geom),
            rhref, dqmax, wcol, sw.sw_abs1(geom), rsig, rsig1, drh0k,
            fvdiq2k, gate, consts.gp.xgeop1_host, consts.gp.xgeop2_host]
    for n, (row, w) in enumerate(zip(rows, want)):
        assert np.array_equal(row, np.asarray(w, dtype=np.float64)
                              .astype(dtype)), n
    # The scalars: computed in float64 on the host, rounded once.
    assert np.array_equal(phys.levels[17 * kx:],
                          phys.levels_host[17 * kx:].astype(dtype))


# ---------------------------------------------------------------------------
# The spectral update's tables, by m row
# ---------------------------------------------------------------------------

def _with_dt(consts, geom, factor):
    p = consts.params
    return consts.with_implicit(timp.build_implicit(
        p, geom, consts.hd, factor * p.delt, device=consts.device))


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_row_tables_hold_the_plain_versions_tables_by_m_row(prec):
    """Row m of the per-row tables: the eleven (mx, nx) tables at m in the
    kernel's order, gradx(m), then the implicit inverses of every n of the
    row laid out (kx, kx, nx), all equal to the tensors the plain version
    reads."""
    consts, _ = consts_for(T30L8, prec, physics_on=False)
    sp, hd, im = consts.sp, consts.hd, consts.implicit
    mx, nx, kx = sp.mx, sp.nx, T30L8.kx
    rows, levels = consts.update_tables
    assert rows.shape == (mx, 11 * nx + 1 + kx * kx * nx)
    assert rows.dtype == sp.rdtype and rows.is_contiguous()
    src = {"el2": sp.el2, "trfilt": sp.trfilt, "dmp": hd.dmp,
           "dmpd": hd.dmpd, "dmps": hd.dmps, "dmp1": im.dmp1,
           "dmp1d": im.dmp1d, "dmp1s": im.dmp1s, "elz": im.elz,
           "vddym": sp.vddym, "vddyp": sp.vddyp}
    for t, name in enumerate(GK.ROW_TABLES):
        assert torch.equal(rows[:, t * nx:(t + 1) * nx], src[name]), name
    assert torch.equal(rows[:, 11 * nx], sp.gradx.reshape(mx))
    xj = rows[:, 11 * nx + 1:].reshape(mx, kx, kx, nx)
    for m, n in ((0, 0), (3, 7), (mx - 1, nx - 1), (12, 20)):
        assert torch.equal(xj[m, :, :, n], im.xj_mn[m, n]), (m, n)
    assert levels.dtype == NP_DTYPE[prec]
    assert np.array_equal(levels, GK.kernel_levels(consts).astype(
        NP_DTYPE[prec]))


def test_row_tables_are_rebuilt_for_each_start_up_time_step():
    """The three start-up time steps carry implicit tables of their own, so
    each Consts gets its own packing; a repeated read returns the packing
    already built, and a new Consts (even with equal values) builds a new
    one."""
    consts, geom = consts_for(T30L8, "f64", physics_on=False)
    steps = [_with_dt(consts, geom, f) for f in DT_FACTORS]
    packs = [c.update_tables for c in steps]
    nx = consts.sp.nx
    for c, (rows, levels) in zip(steps, packs):
        assert torch.equal(rows[:, 8 * nx:9 * nx], c.implicit.elz)
        assert torch.equal(rows[:, 5 * nx:6 * nx], c.implicit.dmp1)
        assert np.array_equal(levels, GK.kernel_levels(c))
    for (a, la), (b, lb) in zip(packs, packs[1:]):
        assert not torch.equal(a, b) and not np.array_equal(la, lb)
    for c, pack in zip(steps, packs):
        assert c.update_tables is pack
    fresh = _with_dt(consts, geom, 2.0)
    rows2, _ = fresh.update_tables
    assert rows2 is not packs[2].rows and torch.equal(rows2, packs[2].rows)


def test_update_tables_are_built_at_first_use_only(monkeypatch):
    """The packing is built when the kernel's wrapper first reads it, not
    with the Consts: a CPU step, which takes the plain version, never
    builds it."""
    consts, _ = consts_for(T30L5, "f64", physics_on=False)
    c = dataclasses.replace(consts)
    assert "update_tables" not in vars(c)
    monkeypatch.setattr(GK, "build_update_tables",
                        lambda c: pytest.fail("packed"))
    specs, state = _glue_inputs(T30L5, 2, 11)
    p = T30L5
    GK.spectral_update(TG.spectral_update_plain, c, 2, 2 * p.delt, p.rob,
                       specs, *state)
    assert "update_tables" not in vars(c)
    monkeypatch.undo()
    assert c.update_tables.rows.shape[0] == c.sp.mx
    assert "update_tables" in vars(c)


# ---------------------------------------------------------------------------
# What the spectral-update wrapper refuses, before anything is built
# ---------------------------------------------------------------------------

def _glue_inputs(params, nmem, seed, dtype=torch.float64):
    kx, mx, nx, ntr = params.kx, params.mx, params.nx, params.ntr
    rng = np.random.default_rng(seed)
    mk = lambda shape, scale: torch.from_numpy(
        scale * rng.standard_normal((nmem,) + shape)).to(dtype)
    lev, plane, trac = (2, kx, mx, nx), (2, mx, nx), (2, ntr * kx, mx, nx)
    specs = [mk(lev, 1e-5) for _ in range(6 + 3 * ntr)]
    state = [mk(plane, 1e-5), mk(lev, 1e-5), mk(lev, 1e-5), mk(lev, 1e-6),
             mk(lev, 1e-6), mk(lev, 10.0), mk(lev, 10.0), mk(plane, 1e-2),
             mk(plane, 1e-2), mk(trac, 1e-3), mk(trac, 1e-3), mk(lev, 1e3),
             mk(plane, 1.0), mk(plane, 1e-3)]
    return specs, state


def _bad_glue_calls():
    consts, _ = consts_for(T30L8, "f64", physics_on=False)
    specs, state = _glue_inputs(T30L8, 2, 5)
    p = T30L8
    call = lambda c=consts, sp=specs, st=state, **kw: (c, sp, st, kw)
    # Every field on the meta device, one with a part stride of 2^31: it
    # passes the type checks and fails the layout check.
    meta = lambda x: torch.empty_like(x, device="meta")
    big = torch.empty(2 ** 31 + 2 ** 20, dtype=torch.float64,
                      device="meta").as_strided(state[1].shape,
                                                (0, 2 ** 31, 992, 32, 1))
    return {
        "kx": (call(c=dataclasses.replace(consts, params=dataclasses.replace(
            p, kx=6))), ValueError),
        "ntr": (call(c=dataclasses.replace(consts, params=dataclasses.replace(
            p, ntr=5))), ValueError),
        "spec_count": (call(sp=specs[:-1]), ValueError),
        # sp.nx is the last axis of cpol_even: nx = MAX_NX + 1 stands in.
        "nx": (call(c=dataclasses.replace(consts, sp=consts.sp._replace(
            cpol_even=torch.empty((1, consts.sp.mx, GK.MAX_NX + 1),
                                  device="meta")))), ValueError),
        "dtype": (call(st=[state[0].float()] + state[1:]), TypeError),
        "shape": (call(st=state[:1] + [state[1][:, :, :-1]] + state[2:]),
                  ValueError),
        "members": (call(st=state[:3] + [state[3][:1]] + state[4:]),
                    ValueError),
        "row_offsets": (call(sp=[meta(x) for x in specs],
                             st=[meta(state[0]), big]
                             + [meta(x) for x in state[2:]]), ValueError),
        "device": (call(), ValueError),
        "stride0_members_until_device": (
            call(st=state[:1] + [x[:1].expand_as(x) for x in state[1:]]),
            ValueError),
    }


@pytest.mark.parametrize("case", ["kx", "ntr", "nx", "spec_count", "dtype",
                                  "shape", "members", "row_offsets", "device",
                                  "stride0_members_until_device"])
def test_spectral_update_wrapper_refuses_before_building(case, monkeypatch):
    """Unsupported kx or tracer count, an nx past one block's lane, a
    missing spectrum, a wrong dtype or shape, a layout whose row offsets exceed 32 bits, and CPU
    tensors: each raises before the build, the tables or a launch (a
    freshly broadcast state, read in place on the card, passes the layout
    checks and is refused for its device)."""
    monkeypatch.setattr(GK, "_load", lambda name: pytest.fail("loaded"))
    monkeypatch.setattr(GK, "build_update_tables",
                        lambda c: pytest.fail("packed"))
    (c, specs, state, kw), exc = _bad_glue_calls()[case]
    c = dataclasses.replace(c)          # nothing packed yet
    before = dict(ck.launch_counts)
    match = ("CUDA" if case in ("device", "stride0_members_until_device")
             else "32 bits" if case == "row_offsets"
             else f"at most {GK.MAX_NX}" if case == "nx" else None)
    with pytest.raises(exc, match=match):
        GK.spectral_update_cuda(c, 2, 2 * T30L8.delt, T30L8.rob, specs,
                                *state, **kw)
    assert ck.launch_counts == before


def test_field_strides_refuse_rows_past_32_bits():
    """The kernel addresses inside a (member, m) row with 32-bit offsets:
    the part, level and n strides of a field must keep them below 2^31."""
    x = torch.empty(2 ** 31 + 2 ** 20, device="meta")
    fine = x.as_strided((3, 2, 8, 31, 32), (0, 2 ** 30, 1, 0, 0))
    assert GK.field_strides("x", fine, (3, 2, 8, 31, 32))[1] == 2 ** 30
    over = x.as_strided((3, 2, 8, 31, 32), (0, 2 ** 31, 1, 0, 0))
    with pytest.raises(ValueError, match="32 bits"):
        GK.field_strides("x", over, (3, 2, 8, 31, 32))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")


def _qsat(ta, p):
    e = np.where(ta >= 273.16,
                 6.108e-3 * np.exp(17.269 * (ta - 273.16) / (ta - 35.86)),
                 6.108e-3 * np.exp(21.875 * (ta - 273.16) / (ta - 7.66)))
    return 622.0 * e / (p - 0.378 * e)


def _physics_inputs(consts, nmem, seed):
    """Seeded columns (half with a moist boundary layer, so that convection
    fires) and boundary fields in the layouts the model hands over, on the
    card: (args, kwargs of the grid_phi mode, an SPPT pattern)."""
    p = consts.params
    kx, il, ix = p.kx, p.il, p.ix
    rng = np.random.default_rng(seed)
    fsg = np.asarray(consts.geom.fsg, dtype=np.float64)
    sh2, sh3 = (nmem, il, ix), (nmem, kx, il, ix)
    lev = lambda x: x[None, :, None, None]
    psa = 0.7 + 0.35 * rng.random(sh2)
    ta = np.clip((260.0 + 40.0 * rng.random(sh2))[:, None]
                 - 60.0 * lev(1.0 - fsg) + rng.normal(0, 3.0, sh3),
                 180.0, 330.0)
    rh = np.clip(0.15 + 0.9 * rng.random(sh3), 0.0, 1.1)
    moist = rng.random(sh2) < 0.5
    for k in (kx - 1, kx - 2):
        rh[:, k] = np.where(moist, 0.88 + 0.2 * rng.random(sh2), rh[:, k])
    qa = rh * _qsat(ta, lev(fsg) * psa[:, None])
    phi = np.zeros(sh3)
    phi[:, kx - 1] = 287.0 * ta[:, kx - 1] * 0.05
    for k in range(kx - 2, -1, -1):
        phi[:, k] = phi[:, k + 1] + 287.0 * 0.5 * (
            ta[:, k] + ta[:, k + 1]) * np.log(fsg[k + 1] / fsg[k])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        "cuda", p.dtype)
    zonal = lambda lo, hi: dev(lo + (hi - lo) * rng.random((il, 1)))
    fm = rng.random((il, ix))
    fmask = np.where(fm < 0.4, 0.0, np.where(fm > 0.7, 1.0, fm))
    sst = 271.0 + 30.0 * rng.random(sh2)
    alb_l, alb_s = 0.1 + 0.5 * rng.random(sh2), 0.07 + 0.5 * rng.random(sh2)
    bc = {"fmask_land": dev(fmask),
          "phis0": dev(fmask * 5000.0 * rng.random((il, ix))),
          "forog": dev(1.0 + 0.5 * rng.random((il, ix))), "sst_am": dev(sst),
          "alb_land": dev(alb_l), "alb_sea": dev(alb_s),
          "alb_surface": dev(alb_s + fmask * (alb_l - alb_s)),
          "snowc": dev(rng.random(sh2)),
          "land_temp": dev(250.0 + 50.0 * rng.random(sh2)),
          "soil_avail_water": dev(rng.random(sh2)),
          "zenit_correction": zonal(1.0, 2.0).expand(nmem, il, ix),
          "flux_solar_in": zonal(0.0, 450.0).expand(nmem, il, ix),
          "flux_ozone_upper": zonal(0.0, 3.0),
          "flux_ozone_lower": zonal(0.0, 3.0).expand(nmem, il, 1),
          "stratospheric_correction": zonal(0.0, 5.0).expand(il, ix),
          "ssti_om": dev(sst + rng.normal(0, 1.0, sh2))}
    args = [dev(rng.normal(0, 10, sh3)), dev(rng.normal(0, 8, sh3)), dev(ta),
            dev(qa), dev(phi), dev(np.log(psa)),
            tuple(bc[n] for n in TD.BC_FIELDS), (),
            torch.full((nmem,), 6.0, dtype=p.dtype, device="cuda")]
    grid_phi = {"phisg": dev(fmask * 3000.0 * rng.random((il, ix))),
                "m0corr": dev(rng.normal(0, 30.0, (nmem, kx, il, 1)))}
    sppt = dev(np.clip(0.33 * rng.normal(0, 1, sh3), -0.95, 0.95))
    return args, grid_phi, sppt


def _flat(result):
    return list(result[:4]) + list(result[4]) + list(result[5])


def _columns_over(got, want, limit):
    """Columns (member, lat, lon) where any output differs by more than
    `limit` of its largest value."""
    bad = None
    for g, w in zip(_flat(got), _flat(want)):
        err = (g.double() - w.double()).abs() / float(w.double().abs().max()
                                                      or 1.0)
        b = err.reshape(g.shape[0], -1, *g.shape[-2:]).amax(1) > limit
        bad = b if bad is None else bad | b
    return int(bad.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", [T30L8, T30L5], ids=["L8", "L5"])
def test_physics_kernel_matches_its_plain_version_in_every_mode(preset, prec):
    """Needs an NVIDIA GPU and nvcc: both shortwave variants, the
    geopotential read and integrated, an SPPT pattern, the coupled sea, and
    in float32 the bfloat16 tendencies, against the plain version: 1e-12 of
    each output's largest value in float64; in float32 1e-5, with at most 20
    columns over it (a threshold of the schemes), as chip_smoke.py holds it;
    in both types the bfloat16 tendencies are the rounding of the kernel's
    own values."""
    _card()
    limit, ceiling = (1e-12, 0) if prec == "f64" else (1e-5, 20)
    for sea in (0, 1):
        consts, _ = consts_for(preset, prec, device="cuda", sea=sea)
        args, gp, sppt = _physics_inputs(consts, 2, 30 + sea)
        for mode in ("phig", "grid_phi", "sppt"):
            a, kw = list(args), {}
            if mode != "phig":
                a[4], kw = None, dict(gp)
            if mode == "sppt":
                kw["sppt_pattern"] = sppt
            want = TD.grid_physics(consts, True, *a, **kw)
            got = ck.grid_physics_cuda(consts, True, *a, **kw)
            assert _columns_over(got, want, limit) <= ceiling, (sea, mode)
            a[7] = tuple(c.contiguous() for c in want[5])
            want = TD.grid_physics(consts, False, *a, **kw)
            got = ck.grid_physics_cuda(consts, False, *a, **kw)
            assert _columns_over(got, want, limit) <= ceiling, (sea, mode)
            cb = dataclasses.replace(consts, bf16_tendencies=True)
            for sw_flag in (True, False):
                b = ck.grid_physics_cuda(cb, sw_flag, *a, **kw)
                f = ck.grid_physics_cuda(consts, sw_flag, *a, **kw)
                for x, y in zip(b[:4], f[:4]):
                    assert x.dtype == torch.bfloat16
                    assert torch.equal(x, y.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_physics_member_alone_equals_member_of_the_batch(prec):
    """Needs an NVIDIA GPU and nvcc: member 0 alone (B=1) gives the bits it
    gets as member 0 of B=8, both variants."""
    _card()
    consts, _ = consts_for(T30L8, prec, device="cuda")
    args, gp, _ = _physics_inputs(consts, 8, 40)
    args[4] = None
    one = lambda x: x[:1] if x.dim() >= 3 else x
    for sw_flag in (True, False):
        batch = ck.grid_physics_cuda(consts, sw_flag, *args, **gp)
        a1 = [one(x) if torch.is_tensor(x) else x for x in args[:6]]
        a1 += [tuple(one(x) for x in args[6]),
               tuple(one(x) for x in args[7]), args[8][:1]]
        alone = ck.grid_physics_cuda(consts, sw_flag, *a1, phisg=gp["phisg"],
                                     m0corr=gp["m0corr"][:1])
        for x, y in zip(_flat(alone), _flat(batch)):
            assert torch.equal(x, y[:1])
        args[7] = tuple(c.contiguous() for c in batch[5])


def _card_glue(preset, prec, ntr, factor):
    consts, geom = consts_for(dataclasses.replace(preset, ntr=ntr), prec,
                              device="cuda", physics_on=False)
    return _with_dt(consts, geom, factor)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kx", [5, 7, 8])
def test_spectral_update_matches_its_plain_version_in_every_mode(kx, prec):
    """Needs an NVIDIA GPU and nvcc: 1 to 4 tracers, the three start-up time
    steps (j1 = 1 with dt/2 and dt, j1 = 2 with 2 dt), dense and with a
    stride-0 member axis: 1e-12 (f64) / 1e-5 (f32) of each output's largest
    value."""
    _card()
    limit = 1e-12 if prec == "f64" else 1e-5
    preset = dataclasses.replace(T30L8, kx=kx) if kx != 5 else T30L5
    for ntr in (1, 2, 4):
        for j1, factor in ((1, 0.5), (1, 1.0), (2, 2.0)):
            c = _card_glue(preset, prec, ntr, factor)
            p = c.params
            specs, state = _glue_inputs(p, 3, 7 * ntr + j1, p.dtype)
            specs = [x.cuda() for x in specs]
            state = [x.cuda() for x in state]
            for shared in (False, True):
                st = state if not shared else (
                    [state[0]] + [x[:1].expand_as(x) for x in state[1:]])
                args = (c, j1, factor * p.delt, 0.0 if j1 == 1 else p.rob,
                        specs, *st)
                got = GK.spectral_update_cuda(*args)
                want = TG.spectral_update_plain(*args)
                for g, w in zip(got, want):
                    err = float((g - w).abs().max() / w.abs().max())
                    assert err <= limit, (ntr, j1, factor, shared, err)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_spectral_update_member_is_the_same_in_any_tile_and_width(prec):
    """Needs an NVIDIA GPU and nvcc: every member's result is the same bits
    whatever tile position and lane it lands in (the batch cut at offsets
    that move each member to another tile and lane), and member 0 alone
    (B=1) equals member 0 of B=128."""
    _card()
    c = _card_glue(T30L8, prec, 1, 2.0)
    p = c.params
    specs, state = _glue_inputs(p, 128, 3, p.dtype)
    specs = [x.cuda() for x in specs]
    state = [x.cuda() for x in state]
    args = (c, 2, 2 * p.delt, p.rob)
    ref = GK.spectral_update_cuda(*args, specs, *state)
    for off in (1, 3, 5, 17):
        got = GK.spectral_update_cuda(*args, [x[off:] for x in specs],
                                      *(x[off:] for x in state))
        assert all(torch.equal(x, y[off:]) for x, y in zip(got, ref)), off
    alone = GK.spectral_update_cuda(*args, [x[:1] for x in specs],
                                    *(x[:1] for x in state))
    assert all(torch.equal(x, y[:1]) for x, y in zip(alone, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_spectral_update_library_plan_is_the_model(prec):
    """Needs an NVIDIA GPU and nvcc: the launch plan the library computes
    (pyspeedy_spectral_update_plan) is GK.update_launch_plan's at T30, T47
    and T63 for B = 1, 17, 128 and 256 on this card's SMs, and the CUDA
    runtime holds the plan's blocks an SM at once, without local memory."""
    import ctypes
    _card()
    size = 4 if prec == "f32" else 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = ctypes.CDLL(str(ck.build_kernels(["spectral_update"])[
        "spectral_update"]))
    for p in (T30L8, T47L8, T63L8):
        for nmem in (1, 17, 128, 256):
            got = GK.library_launch_plan(size, p.kx, p.ntr, p.nx, p.mx, nmem,
                                         sms)
            want = GK.update_launch_plan(p.nx, p.mx, p.kx, p.ntr, size, nmem,
                                         sms)
            assert got == {k: want[k] for k in got}, (p.trunc, nmem)
        out = (ctypes.c_int * 7)()
        assert lib.pyspeedy_spectral_update_occupancy(size, p.kx, p.ntr,
                                                      p.nx, out) == 0
        big = GK.update_launch_plan(p.nx, p.mx, p.kx, p.ntr, size, 1 << 20)
        assert (out[1], out[2], out[5], out[6]) == (
            big["threads"], big["smem"], big["lanes"], big["blocks_per_sm"])
        assert out[0] >= big["blocks_per_sm"] and out[4] == 0, tuple(out)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", [T47L8, T63L8], ids=["T47", "T63"])
def test_spectral_update_at_t47_and_t63(preset, prec):
    """Needs an NVIDIA GPU and nvcc: at nx = 49 and 65 (units of 5 and 3
    members, one block an SM) the kernel against its plain version at
    B=128, 1e-12 (f64) / 1e-5 (f32) of each output's largest value; every
    member the same bits with the batch cut at offsets that move it to
    another unit, block and place in a unit, and member 0 alone (B=1)."""
    _card()
    limit = 1e-12 if prec == "f64" else 1e-5
    c = _card_glue(preset, prec, 1, 2.0)
    p = c.params
    specs, state = _glue_inputs(p, 128, 11, p.dtype)
    specs = [x.cuda() for x in specs]
    state = [x.cuda() for x in state]
    args = (c, 2, 2 * p.delt, p.rob)
    ref = GK.spectral_update_cuda(*args, specs, *state)
    want = TG.spectral_update_plain(*args, specs, *state)
    for g, w in zip(ref, want):
        assert float((g - w).abs().max() / w.abs().max()) <= limit
    for off in (1, 2, 4, 17, 64):
        got = GK.spectral_update_cuda(*args, [x[off:] for x in specs],
                                      *(x[off:] for x in state))
        assert all(torch.equal(x, y[off:]) for x, y in zip(got, ref)), off
    alone = GK.spectral_update_cuda(*args, [x[:1] for x in specs],
                                    *(x[:1] for x in state))
    assert all(torch.equal(x, y[:1]) for x, y in zip(alone, ref))
