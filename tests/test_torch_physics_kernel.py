"""The column-physics function, the second module of the port that holds a CUDA
kernel (pyspeedy_tpu_torch/csrc/grid_physics.cu).

There is no card and no nvcc where these tests run, so what is held against
the JAX package is the kernel's plain PyTorch version,
``physics.driver.grid_physics``: against the JAX ``grid_physics`` member by
member, and against the JAX package's Pallas path as its own tests run it off
the TPU (``grid_physics_pallas(..., interpret=True)``). The kernel itself is
held against the plain version on the card by ``chip_smoke.py``.

Inputs: the JAX demo state's columns (member 0) and seeded random columns with
a moist boundary layer in half of them (member 1), so that convection, clouds
and condensation fire. Limit 1e-12 of each output's largest value in float64:
same formulation on both sides; the order of a few sums over levels and bands
differs, and no threshold of the schemes changes side at that size on these
inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyspeedy_tpu.params as jparams
import pyspeedy_tpu_torch.params as tparams
from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.ops import spectral as JS
from pyspeedy_tpu.physics import driver as JD
from pyspeedy_tpu.physics.pallas_physics import grid_physics_pallas
from pyspeedy_tpu.testing import make_demo_model as j_make_demo_model
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.physics import driver as TD

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

TOL = 1e-12
NAMES = (("utend", "vtend", "ttend", "qtend") + TD.DIAG_FIELDS
         + TD.CACHE_FIELDS)
_cache = {}


def consts_pair(preset, sea=0):
    key = (preset, sea)
    if key not in _cache:
        jconsts, _ = JM.build_consts(getattr(jparams, preset))
        jconsts = dataclasses.replace(jconsts, sea_coupling_flag=0)
        tconsts, _ = TM.build_consts(getattr(tparams, preset), device="cpu",
                                     sea_coupling_flag=sea)
        _cache[key] = (jconsts, tconsts)
    return _cache[key]


def _qsat(ta, p):
    e = np.where(ta >= 273.16,
                 6.108e-3 * np.exp(17.269 * (ta - 273.16) / (ta - 35.86)),
                 6.108e-3 * np.exp(21.875 * (ta - 273.16) / (ta - 7.66)))
    return 622.0 * e / (p - 0.378 * e)


def random_member(params, seed):
    """One member of seeded random columns (numpy): the single-member
    arguments of grid_physics plus phisg, m0corr and an SPPT pattern."""
    kx, il, ix = params.kx, params.il, params.ix
    rng = np.random.default_rng(seed)
    fsg = np.asarray(TM.build_geometry(params).fsg)
    col = lambda x: x[:, None, None]
    sh2, sh3 = (il, ix), (kx, il, ix)
    psa = 0.7 + 0.35 * rng.random(sh2)
    ta = np.clip((260.0 + 40.0 * rng.random(sh2))[None]
                 - 60.0 * col(1.0 - fsg) + rng.normal(0, 3.0, sh3),
                 180.0, 330.0)
    rh = np.clip(0.15 + 0.9 * rng.random(sh3), 0.0, 1.1)
    moist = rng.random(sh2) < 0.5
    for k in (kx - 1, kx - 2):
        rh[k] = np.where(moist, 0.88 + 0.2 * rng.random(sh2), rh[k])
    qa = rh * _qsat(ta, col(fsg) * psa[None])
    rgas = (2.0 / 7.0) * 1004.0
    phi = np.zeros(sh3)
    phi[kx - 1] = rgas * ta[kx - 1] * 0.05
    for k in range(kx - 2, -1, -1):
        phi[k] = phi[k + 1] + rgas * 0.5 * (ta[k] + ta[k + 1]) * np.log(
            fsg[k + 1] / fsg[k])
    fm = rng.random(sh2)
    fmask = np.where(fm < 0.4, 0.0, np.where(fm > 0.7, 1.0, fm))
    alb_l, alb_s = 0.1 + 0.5 * rng.random(sh2), 0.07 + 0.5 * rng.random(sh2)
    sst = 271.0 + 30.0 * rng.random(sh2)
    zonal = lambda lo, hi: lo + (hi - lo) * rng.random((il, 1))
    bc = {
        "fmask_land": fmask, "phis0": fmask * 5000.0 * rng.random(sh2),
        "forog": 1.0 + 0.5 * rng.random(sh2), "sst_am": sst,
        "alb_land": alb_l, "alb_sea": alb_s,
        "alb_surface": alb_s + fmask * (alb_l - alb_s),
        "snowc": rng.random(sh2), "land_temp": 250.0 + 50.0 * rng.random(sh2),
        "soil_avail_water": rng.random(sh2),
        "zenit_correction": zonal(1.0, 2.0), "flux_solar_in": zonal(0, 450.0),
        "flux_ozone_upper": zonal(0.0, 3.0), "flux_ozone_lower": zonal(0, 3.0),
        "stratospheric_correction": zonal(0.0, 5.0),
        "ssti_om": sst + rng.normal(0, 1.0, sh2),
    }
    return {
        "ug": rng.normal(0, 10, sh3), "vg": rng.normal(0, 8, sh3), "tg": ta,
        "qg": qa, "phig": phi, "pslg": np.log(psa),
        "bc": tuple(bc[n] for n in TD.BC_FIELDS), "ablco2": np.asarray(6.0),
        "phisg": fmask * 3000.0 * rng.random(sh2),
        "m0corr": rng.normal(0, 30.0, (kx, il, 1)),
        "sppt": np.clip(0.33 * rng.normal(0, 1, sh3), -0.95, 0.95),
    }


def demo_member():
    """The JAX demo state's columns, as test_pallas_physics.py makes them."""
    if "demo" not in _cache:
        consts, state, _ = j_make_demo_model(jparams.T30L8)
        sp = consts.sp
        g = lambda f, kcos=1: np.asarray(JS.spec2grid_p(sp, f, kcos))
        ucos, vcos = JS.vort2vel_p(sp, state["vor"][0], state["div"][0])
        rng = np.random.default_rng(11)
        p = jparams.T30L8
        _cache["demo"] = {
            "ug": g(ucos, 2), "vg": g(vcos, 2), "tg": g(state["t"][0]),
            "qg": g(state["tr"][0][:, 0]), "phig": g(state["phi"]),
            "pslg": g(state["ps"][0]),
            "bc": tuple(np.asarray(state[n]) for n in JD.BC_FIELDS),
            "ablco2": np.asarray(state["air_absortivity_co2"]),
            "phisg": np.asarray(state["phisg"]),
            "m0corr": rng.normal(0, 30.0, (p.kx, p.il, 1)),
            "sppt": np.clip(0.33 * rng.normal(0, 1, (p.kx, p.il, p.ix)),
                            -0.95, 0.95),
        }
    return _cache["demo"]


def members(preset):
    params = getattr(tparams, preset)
    if preset == "T30L8":
        return [demo_member(), random_member(params, 1)]
    return [random_member(params, 2), random_member(params, 3)]


def jax_result(jconsts, m, sw_flag, mode, cache=None, pallas=False):
    """The JAX package's result for one member, flattened to numpy."""
    A = jnp.asarray
    kw = {}
    phig = A(m["phig"])
    if mode == "grid_phi":
        phig, kw = None, {"phisg": A(m["phisg"]), "m0corr": A(m["m0corr"])}
    if mode == "sppt":
        kw["sppt_pattern"] = A(m["sppt"])
    cache = () if sw_flag else tuple(A(c) for c in cache)
    args = (A(m["ug"]), A(m["vg"]), A(m["tg"]), A(m["qg"]), phig,
            A(m["pslg"]), tuple(A(x) for x in m["bc"]), cache, A(m["ablco2"]))
    if pallas:
        out = grid_physics_pallas(jconsts, sw_flag, *args, interpret=True,
                                  **kw)
    else:
        out = JD.grid_physics(jconsts, sw_flag, *args, **kw)
    return [np.asarray(x) for x in jax.tree.leaves(out)]


def torch_args(ms, sw_flag, mode, caches=None, bc_layout="mixed"):
    """Member-batched arguments of the port's grid_physics from a list of
    single-member numpy dicts. Boundary fields that are equal in all members
    stay shared, (il, ix) or (il, 1), as the model hands them over; the others
    get a member axis."""
    T = lambda name: torch.from_numpy(np.stack([m[name] for m in ms]))
    bc = []
    for n in range(len(TD.BC_FIELDS)):
        planes = [m["bc"][n] for m in ms]
        if len({p.shape for p in planes}) > 1:
            planes = [np.broadcast_to(p, m_shape(ms)) for p in planes]
        shared = all(np.array_equal(planes[0], p) for p in planes[1:])
        if shared and bc_layout == "mixed":
            bc.append(torch.from_numpy(planes[0].copy()))
        else:
            x = torch.from_numpy(np.stack(planes))
            if bc_layout == "dense":
                x = x.expand(len(ms), *m_shape(ms)).contiguous()
            bc.append(x)
    kw = {}
    phig = T("phig")
    if mode == "grid_phi":
        phig = None
        kw = {"phisg": torch.from_numpy(ms[0]["phisg"].copy()),
              "m0corr": T("m0corr")}
    if mode == "sppt":
        kw["sppt_pattern"] = T("sppt")
    cache = ()
    if not sw_flag:
        cache = tuple(torch.from_numpy(np.stack([c[n] for c in caches]))
                      for n in range(len(TD.CACHE_FIELDS)))
    ablco2 = torch.from_numpy(np.stack([m["ablco2"] for m in ms]))
    return (T("ug"), T("vg"), T("tg"), T("qg"), phig, T("pslg"), tuple(bc),
            cache, ablco2), kw


def m_shape(ms):
    return ms[0]["pslg"].shape


def flat(result):
    return list(result[:4]) + list(result[4]) + list(result[5])


def compare(got, wants, tol=TOL):
    """got: the port's member-batched result; wants: per member, the JAX
    leaves."""
    got = flat(got)
    assert len(got) == len(NAMES) == len(wants[0])
    for n, name in enumerate(NAMES):
        for b, want in enumerate(wants):
            g, w = got[n][b].numpy(), want[n]
            assert g.shape == w.shape, (name, g.shape, w.shape)
            scale = max(np.abs(w).max(), 1e-300)
            err = np.abs(g - w).max() / scale
            assert err <= tol, (name, b, err)


def phisg_shared(ms):
    """The grid_phi mode takes one shared phisg: give every member the first
    one's."""
    return [dict(m, phisg=ms[0]["phisg"]) for m in ms]


@pytest.mark.parametrize("mode", ["phig", "grid_phi", "sppt"])
@pytest.mark.parametrize("preset", ["T30L8", "T30L5"])
def test_plain_physics_matches_jax(preset, mode):
    """Both shortwave variants; the step without shortwave reads the cache
    the JAX shortwave step made."""
    jconsts, tconsts = consts_pair(preset)
    ms = phisg_shared(members(preset))
    want_sw = [jax_result(jconsts, m, True, mode) for m in ms]
    args, kw = torch_args(ms, True, mode)
    compare(TD.grid_physics(tconsts, True, *args, **kw), want_sw)
    # The random member must exercise the branches (at kx = 5 the
    # convection sweep is empty and the scheme never fires).
    cbmf, precnv, precls = want_sw[1][4:7]
    assert (precls > 0).mean() > 0.2
    if preset == "T30L8":
        assert 0.02 < (cbmf > 0).mean() < 0.9, (cbmf > 0).mean()
        assert (precnv > 0).mean() > 0.02
    else:
        assert not cbmf.any()

    caches = [w[-7:] for w in want_sw]
    want_ns = [jax_result(jconsts, m, False, mode, cache=c)
               for m, c in zip(ms, caches)]
    args, kw = torch_args(ms, False, mode, caches)
    got = TD.grid_physics(tconsts, False, *args, **kw)
    compare(got, want_ns)
    for c_in, c_out in zip(args[7], got[5]):
        assert c_out is c_in       # the cache passes through untouched


@pytest.mark.parametrize("sw_flag", [True, False])
def test_plain_physics_matches_jax_pallas_path(sw_flag):
    """The JAX package's kernel path, run as its own tests run it on the CPU:
    the latitude-tiled Pallas call in interpret mode."""
    jconsts, tconsts = consts_pair("T30L8")
    ms = [demo_member()]
    cache = jax_result(jconsts, ms[0], True, "phig")[-7:]
    want = jax_result(jconsts, ms[0], sw_flag, "phig", cache=cache,
                      pallas=True)
    args, kw = torch_args(ms, sw_flag, "phig", [cache])
    compare(TD.grid_physics(tconsts, sw_flag, *args, **kw), [want])


@pytest.mark.parametrize("sea", [0, 1])
def test_sea_coupling_flag(sea):
    """sea_coupling_flag > 0 evaluates the sea fluxes a second time with the
    ocean model's temperature. With ssti_om equal to sst_am the second
    evaluation repeats the first, so the result must equal the JAX result
    without coupling; with its own ssti_om only the sea rows, what is
    averaged from them and what the upward longwave makes of it may move."""
    jconsts, tconsts = consts_pair("T30L8", sea)
    base = random_member(tparams.T30L8, 4)
    i_sst, i_om = TD.BC_FIELDS.index("sst_am"), TD.BC_FIELDS.index("ssti_om")
    same = dict(base, bc=tuple(base["bc"][i_sst] if n == i_om else x
                               for n, x in enumerate(base["bc"])))
    want = jax_result(jconsts, same, True, "phig")
    args, kw = torch_args([same], True, "phig")
    compare(TD.grid_physics(tconsts, True, *args, **kw), [want])

    args, kw = torch_args([base], True, "phig")
    got = dict(zip(NAMES, flat(TD.grid_physics(tconsts, True, *args, **kw))))
    ref = dict(zip(NAMES, want))
    moved = lambda name, row: not np.allclose(
        got[name][0, row].numpy(), ref[name][row], rtol=1e-9, atol=0)
    for name in ("shf", "evap", "slru", "hfluxn"):
        assert not moved(name, 0), name                   # land rows stay
        assert moved(name, 1) == (sea == 1), name         # sea rows
    for name in ("ustr", "vstr", "cbmf", "precls", "tsr", "rad_tau2"):
        assert np.allclose(got[name][0].numpy(), ref[name], rtol=1e-9), name
    assert (not np.allclose(got["olr"][0].numpy(), ref["olr"], rtol=1e-9)
            ) == (sea == 1)
    assert not got["hfluxn"][0, 2].any()                  # third row: zeros


def test_member_independence_and_grouping():
    """A batch equals its members one by one, in any order and any batch
    size: the counterpart of the Pallas kernel's tile invariance."""
    _, tconsts = consts_pair("T30L8")
    ms = phisg_shared([random_member(tparams.T30L8, s) for s in (5, 6, 7)])
    for mode in ("phig", "grid_phi"):
        args, kw = torch_args(ms, True, mode)
        both = flat(TD.grid_physics(tconsts, True, *args, **kw))
        for b in (2, 0):
            a1, k1 = torch_args([ms[b]], True, mode)
            one = flat(TD.grid_physics(tconsts, True, *a1, **k1))
            for name, x, y in zip(NAMES, both, one):
                assert torch.equal(x[b:b + 1], y), (mode, name, b)
        order = [2, 0, 1]
        a2, k2 = torch_args([ms[b] for b in order], True, mode)
        perm = flat(TD.grid_physics(tconsts, True, *a2, **k2))
        for name, x, y in zip(NAMES, both, perm):
            assert torch.equal(x[order], y), (mode, name)


def test_columns_do_not_depend_on_their_neighbours():
    """Rolling every field along longitude rolls every output: nothing reads
    across columns."""
    _, tconsts = consts_pair("T30L8")
    m = random_member(tparams.T30L8, 8)
    roll = lambda x: np.roll(x, 7, axis=-1) if x.shape[-1] > 1 else x
    rolled = {k: (tuple(roll(x) for x in v) if isinstance(v, tuple)
                  else (roll(v) if v.ndim >= 2 else v)) for k, v in m.items()}
    a, k = torch_args([m], True, "phig")
    b, kb = torch_args([rolled], True, "phig")
    for name, x, y in zip(NAMES, flat(TD.grid_physics(tconsts, True, *a, **k)),
                          flat(TD.grid_physics(tconsts, True, *b, **kb))):
        assert torch.equal(torch.roll(x, 7, dims=-1), y), name


def test_broadcast_inputs_equal_materialised_ones():
    """Shared (il, ix), zonal (il, 1), expanded views and a per-member CO2
    absorptivity give what dense member-batched tensors give."""
    _, tconsts = consts_pair("T30L8")
    ms = phisg_shared([random_member(tparams.T30L8, 9)] * 2)
    ms[1] = dict(ms[1], tg=ms[1]["tg"] + 1.0)
    args, kw = torch_args(ms, True, "phig", bc_layout="mixed")
    shapes = {tuple(x.shape) for x in args[6]}
    assert {(48, 96), (48, 1)} <= shapes        # really shared and zonal
    want = flat(TD.grid_physics(tconsts, True, *args, **kw))
    dense = list(args)
    dense[6] = tuple(x.expand(2, 48, 96).contiguous() for x in args[6])
    got = flat(TD.grid_physics(tconsts, True, *dense, **kw))
    views = list(args)
    views[6] = tuple(x.expand(2, 48, x.shape[-1]) for x in args[6])
    views[8] = args[8][:1].expand(2)
    got_v = flat(TD.grid_physics(tconsts, True, *views, **kw))
    scalar = list(args)
    scalar[8] = args[8][0]
    got_s = flat(TD.grid_physics(tconsts, True, *scalar, **kw))
    for name, w, g, v, s in zip(NAMES, want, got, got_v, got_s):
        assert torch.equal(w, g) and torch.equal(w, v) and torch.equal(w, s), \
            name


def test_cpu_dispatch_never_touches_the_build(monkeypatch):
    """A CPU tensor takes the plain version: no build, no load, no launch
    counted."""
    _, tconsts = consts_pair("T30L8")

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(ck, "build_kernels", refuse)
    monkeypatch.setattr(ck, "_load", refuse)
    before = dict(ck.launch_counts)
    args, kw = torch_args([random_member(tparams.T30L8, 10)], True, "phig")
    out = flat(ck.grid_physics(TD.grid_physics, tconsts, True, *args, **kw))
    want = flat(TD.grid_physics(tconsts, True, *args, **kw))
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert ck.launch_counts == before
    assert set(before) == {
        "grid_dynamics", "grid_dynamics_bf16", "grid_physics_sw",
        "grid_physics_nosw", "grid_physics_sw_bf16", "grid_physics_nosw_bf16",
        "fused_grid2spec", "fused_grid2spec_bf16", "fused_spec2grid",
        "fused_probe", "fused_grid2spec_hires", "fused_grid2spec_hires_bf16",
        "fused_spec2grid_hires",
        "spectral_update", "dft_chain", "sppt_noise"}


def _bad_inputs():
    ms = phisg_shared([random_member(tparams.T30L8, 12)] * 2)
    good, kw = torch_args(ms, True, "phig")
    cache = tuple(torch.zeros(s, dtype=torch.float64) for s in (
        (2, 8, 48, 96), (2, 4, 8, 48, 96), (2, 2, 48, 96), (2, 48, 96),
        (2, 48, 96), (2, 48, 96), (2, 48, 96)))

    def swap(i, t, sw=True, **extra):
        bad = list(good)
        bad[i] = t
        if not sw and i != 7:
            bad[7] = cache
        return sw, bad, {**kw, **extra}

    def swap_bc(n, t):
        bc = list(good[6])
        bc[n] = t
        return swap(6, tuple(bc))

    gp_kw = {"phisg": torch.from_numpy(ms[0]["phisg"].copy()),
             "m0corr": torch.from_numpy(np.stack([m["m0corr"] for m in ms]))}
    return {
        "dtype": (swap(2, good[2].float()), TypeError),
        "half": (swap(3, good[3].half()), TypeError),
        "shape": (swap(0, good[0][:, :, :-1].contiguous()), ValueError),
        "members": (swap(5, good[5][:1]), ValueError),
        "rank": (swap(2, good[2][0]), ValueError),
        "contiguity": (swap(3, good[3].transpose(2, 3).contiguous()
                            .transpose(2, 3)), ValueError),
        "bc_count": (swap(6, good[6][:-1]), ValueError),
        "bc_shape": (swap_bc(3, good[6][3][:, :-1].contiguous()), ValueError),
        "bc_transposed": (swap_bc(0, good[6][0].t().contiguous().t()),
                          ValueError),
        "bc_strided": (swap_bc(1, torch.zeros(48, 192,
                                              dtype=torch.float64)[:, ::2]),
                       ValueError),
        "bc_dtype": (swap_bc(2, good[6][2].float()), TypeError),
        "no_phi": (swap(4, None), ValueError),
        "m0corr_shape": (swap(4, None, phisg=gp_kw["phisg"],
                              m0corr=gp_kw["m0corr"][..., 0]), ValueError),
        "no_cache": (swap(7, (), sw=False), ValueError),
        "cache_view": (swap(7, tuple(c[:1].expand(c.shape) for c in cache),
                            sw=False), ValueError),
        "ablco2_shape": (swap(8, torch.full((3,), 6.0, dtype=torch.float64)),
                         ValueError),
        "sppt_shape": (swap(2, good[2], sppt_pattern=good[2][:, :4]
                            .contiguous()), ValueError),
    }


@pytest.mark.parametrize("case", [
    "dtype", "half", "shape", "members", "rank", "contiguity", "bc_count",
    "bc_shape", "bc_transposed", "bc_strided", "bc_dtype", "no_phi",
    "m0corr_shape", "no_cache", "cache_view", "ablco2_shape", "sppt_shape"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
    """The CUDA wrapper validates before it builds or launches: wrong dtype,
    shape or layout raises (it never falls back to the plain version)."""
    _, tconsts = consts_pair("T30L8")
    monkeypatch.setattr(ck, "_load", lambda name: pytest.fail("loaded"))
    (sw_flag, bad, kw), exc = _bad_inputs()[case]
    before = dict(ck.launch_counts)
    with pytest.raises(exc):
        ck.grid_physics_cuda(tconsts, sw_flag, *bad, **kw)
    assert ck.launch_counts == before


def test_cuda_wrapper_refuses_cpu_tensors_and_accepts_the_layouts(monkeypatch):
    """Well-formed CPU tensors, in every layout the model hands over, pass
    the checks and are then refused for their device: no fallback."""
    _, tconsts = consts_pair("T30L8")
    monkeypatch.setattr(ck, "_load", lambda name: pytest.fail("loaded"))
    ms = phisg_shared([random_member(tparams.T30L8, 13)] * 2)
    for mode in ("phig", "grid_phi", "sppt"):
        args, kw = torch_args(ms, True, mode)
        args = list(args)
        args[6] = tuple(x if n % 2 else x.expand(2, 48, x.shape[-1])
                        for n, x in enumerate(args[6]))
        with pytest.raises(ValueError, match="CUDA"):
            ck.grid_physics_cuda(tconsts, True, *args, **kw)
    _, tconsts5 = consts_pair("T30L5")
    with pytest.raises(ValueError, match="kx"):
        ck.grid_physics_cuda(tconsts5, True, *args, **kw)


def test_plane_strides():
    """Member, latitude and longitude strides of the accepted layouts."""
    f = lambda x: ck._plane_strides("x", x, 3, 48, 96)
    z = lambda *s: torch.zeros(*s)
    assert f(z(48, 96)) == [0, 96, 1]
    assert f(z(48, 1)) == [0, 1, 0]
    assert f(z(3, 48, 96)) == [48 * 96, 96, 1]
    assert f(z(48, 96).expand(3, 48, 96)) == [0, 96, 1]
    assert f(z(48, 1).expand(3, 48, 96)) == [0, 1, 0]
    assert f(z(3, 48, 1)) == [48, 1, 0]
    assert f(z(3, 48, 1).expand(3, 48, 96)) == [48, 1, 0]
    assert f(z(1, 48, 96)) == [0, 96, 1]


def test_level_tables_match_the_plain_schemes():
    """The kernel's host tables hold the values the plain schemes use."""
    _, tconsts = consts_pair("T30L8")
    phys, geom, kx = tconsts.phys, tconsts.geom, 8
    rows = phys.levels_host[:17 * kx].reshape(17, kx)
    assert np.array_equal(rows[0], geom.fsg)
    assert np.array_equal(rows[1], geom.dhs)
    assert np.array_equal(rows[4], geom.wvi[:, 1])
    assert np.array_equal(rows[15], tconsts.gp.xgeop1_host)
    assert rows[5].sum() == pytest.approx(0.5)          # entrainment
    assert rows[14].tolist() == [0, 0, 0, 0, 1, 1, 0, 0]   # sigh(k) > 0.5
    assert phys.levels_host.shape == (17 * kx + 8,)
    assert torch.equal(phys.sqrtcoa, torch.sqrt(torch.from_numpy(
        np.asarray(geom.coa))))
    # What the kernel receives: the same values in the model's scalar type
    # (its PhysTables<T>), so that it converts nothing where it uses them.
    assert phys.levels.dtype == np.float64 and phys.levels.flags.c_contiguous
    assert np.array_equal(phys.levels, phys.levels_host)


def test_kernel_source_and_build_command():
    """The kernel is CUDA C++ in the package's csrc/, built by nvcc for
    sm_90a, without FMA contraction, into a shared library with a plain C
    interface; one more kernel is one more entry of the table."""
    spec = ck.KERNELS["grid_physics"]
    text = spec.source.read_text()
    assert spec.source.parent.name == "csrc" and spec.source.suffix == ".cu"
    assert f'extern "C" int {spec.symbol}' in text
    assert "torch/extension.h" not in text
    cmd = ck.build_command("grid_physics", "nvcc", "out.so")
    assert cmd[0] == "nvcc" and cmd[-1] == str(spec.source)
    assert "-fmad=false" in cmd and "-shared" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == "out.so"
    assert "-fmad=false" not in ck.build_command("grid_dynamics", "nvcc", "x")
    # The shared-memory design: tables in the scalar type, the column's
    # inputs staged with cp.async, its level arrays in shared-memory slots.
    for word in ("struct PhysTables {", "template <typename T>\nstruct PhysTables",
                 "cp.async.ca.shared.global", "struct Slots",
                 "pyspeedy_grid_physics_occupancy"):
        assert word in text, word
    assert "double fsg[" not in text
    assert set(ck.KERNEL_SOURCES) == set(ck.KERNELS) == {
        "grid_dynamics", "grid_physics", "fused_transform",
        "fused_transform_hires", "spectral_update", "dft_chain",
        "sppt_noise"}
    assert len(spec.argtypes) == 12


@pytest.mark.parametrize("kx", [5, 7, 8])
def test_convective_sums_are_taken_in_the_kernels_order(kx):
    """The updraft's entrained sums feed differences of numbers four orders
    of magnitude above the tendency they leave, so the kernel takes them in
    the plain version's order of additions: three in-place shift-add passes
    (shifts 1, 2, 4) over the column. This transcribes the kernel's loop in
    float32 and holds the plain version's suffix sums to it bitwise; a
    running sum from the lowest level up, which the kernel used before,
    differs in the last bit."""
    from pyspeedy_tpu_torch.physics.convection import _rev_cumsum
    rng = np.random.default_rng(kx)
    x = (rng.uniform(1e3, 4e4, (kx, 6, 16))
         * (rng.uniform(size=(kx, 6, 16)) > 0.3)).astype(np.float32)
    s = x.copy()
    for shift in (1, 2, 4):
        for k in range(kx):
            if k + shift < kx:
                s[k] = s[k] + s[k + shift]
    got = _rev_cumsum(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, s)
    running = np.zeros_like(x)
    acc = np.zeros_like(x[0])
    for k in range(kx - 1, -1, -1):
        acc = acc + x[k]
        running[k] = acc
    assert not np.array_equal(running, s)
    np.testing.assert_allclose(running, s, rtol=1e-6)
    text = ck.KERNELS["grid_physics"].source.read_text()
    assert "s_s[k] = s_s[k] + s_s[k + shift];" in text
    assert "fus_n = fus_bb + s_s[k]" in text


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc; `python3 chip_smoke.py` runs the same
    comparison at full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    consts, _ = TM.build_consts(tparams.T30L8, device="cuda")
    ms = phisg_shared([random_member(tparams.T30L8, s) for s in (20, 21)])
    for mode in ("phig", "grid_phi", "sppt"):
        args, kw = torch_args(ms, True, mode)
        cuda = lambda x: (tuple(cuda(a) for a in x) if isinstance(x, tuple)
                          else None if x is None else x.cuda())
        args = tuple(cuda(a) for a in args)
        kw = {k: cuda(v) for k, v in kw.items()}
        want = flat(TD.grid_physics(consts, True, *args, **kw))
        got = flat(ck.grid_physics_cuda(consts, True, *args, **kw))
        for name, g, w in zip(NAMES, got, want):
            assert float((g - w).abs().max() / w.abs().max()) <= TOL, name


@pytest.mark.gpu
def test_convective_tendency_follows_the_plain_order_on_the_card():
    """On columns with deep convection the kernel's float32 temperature
    tendency follows the plain version's to a few units in the last place
    of the largest value: both take the updraft's sums in one order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    consts, _ = TM.build_consts(tparams.T30L8, device="cuda")
    ms = phisg_shared([random_member(tparams.T30L8, s) for s in (22, 23)])
    args, kw = torch_args(ms, True, "grid_phi")
    cuda = lambda x: (tuple(cuda(a) for a in x) if isinstance(x, tuple)
                      else None if x is None else x.cuda())
    args = tuple(cuda(a) for a in args)
    kw = {k: cuda(v) for k, v in kw.items()}
    want = TD.grid_physics(consts, True, *args, **kw)
    got = ck.grid_physics_cuda(consts, True, *args, **kw)
    convective = want[4][0] > 0                       # cbmf
    assert bool(convective.any())
    err = (got[2] - want[2]).abs().amax(dim=1) / want[2].abs().max()
    assert float(err[convective].max()) <= 2e-6
