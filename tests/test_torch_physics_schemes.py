"""The seven column-physics schemes of ``pyspeedy_tpu_torch`` against their JAX
functions and against the scalar per-column oracle (tests/oracle_physics.py).

Inputs are the random columns of tests/test_physics_oracle.py (numpy, from a
seed); the same arrays go into both packages, in float64 on the CPU.

Tolerance against JAX: 1e-12 of each output's largest value. Both sides run
the same level-parallel formulation with the same order of operations; what
differs is the order inside a few sums over levels and bands and the last
bit of exp. Integer outputs (convection and cloud tops) must be equal.
Tolerance against the oracle: 1e-10 of the output's largest value (the oracle
accumulates level by level where the tensor code uses log-depth prefix sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle_physics as orc
import test_physics_oracle as tpo
from pyspeedy_tpu.physics import convection as jconv
from pyspeedy_tpu.physics import humidity as jhum
from pyspeedy_tpu.physics import large_scale_condensation as jlsc
from pyspeedy_tpu.physics import longwave_radiation as jlw
from pyspeedy_tpu.physics import shortwave_radiation as jsw
from pyspeedy_tpu.physics import surface_fluxes as jsf
from pyspeedy_tpu.physics import vertical_diffusion as jvd
from pyspeedy_tpu_torch.ops.geometry import build_geometry
from pyspeedy_tpu_torch.params import T30L8
from pyspeedy_tpu_torch.physics import convection as tconv
from pyspeedy_tpu_torch.physics import humidity as thum
from pyspeedy_tpu_torch.physics import large_scale_condensation as tlsc
from pyspeedy_tpu_torch.physics import longwave_radiation as tlw
from pyspeedy_tpu_torch.physics import shortwave_radiation as tsw
from pyspeedy_tpu_torch.physics import surface_fluxes as tsf
from pyspeedy_tpu_torch.physics import vertical_diffusion as tvd

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

JGEOM = tpo.GEOM
TGEOM = build_geometry(T30L8)
KX, N = tpo.KX, tpo.N
TOL_JAX = 1e-12
TOL_ORACLE = 1e-10
SCHEMES = ["humidity", "convection", "lsc", "clouds_shortwave", "longwave",
           "surface_fluxes", "vertical_diffusion"]


def grid(x):
    """(.., N) numpy -> (.., 1, N) pseudo lat/lon grid."""
    return np.ascontiguousarray(np.asarray(x)[..., None, :])


def grid_lat(x):
    """(.., N) numpy -> (.., il, N // il): the surface fluxes read cos(lat)
    from the geometry, so they need all il latitudes."""
    x = np.asarray(x)
    il = T30L8.il
    return np.ascontiguousarray(x.reshape(x.shape[:-1] + (il, N // il)))


def extras(seed):
    """Seeded inputs beyond the columns, shared by both sides (numpy)."""
    rng = np.random.default_rng(1000 + seed)
    r = lambda lo=0.0, hi=1.0: lo + (hi - lo) * rng.random(N)
    return {
        "precnv": np.where(rng.random(N) < 0.5, r(0, 2e-2), 0.0),
        "precls": r(0, 1e-2),
        "iptop": rng.integers(3, KX + 2, N).astype(np.int32),
        "gse": r(0.1, 0.5), "fmask": r(),
        "fsol": r(0, 300), "ozupp": r(0, 3), "ozone": r(0, 3),
        "zenit": r(1, 2), "stratz": r(0, 5), "albsfc": r(0.1, 0.6),
        "lw_tau": 0.3 + 0.7 * rng.random((4, KX, 1, N)),
        "strat_corr": rng.random((2, 1, N)),
        "dts": rng.normal(0, 5, N),
        "icnv": rng.integers(-1, 6, N).astype(np.int32),
        "ua": rng.normal(0, 10, (KX, N)), "va": rng.normal(0, 8, (KX, N)),
        "phi0": r(0, 5000), "forog": r(1, 1.5), "tsea": r(271, 301),
        "ssrd": r(0, 300), "slrd": r(200, 400), "alb_land": r(0.1, 0.6),
        "alb_sea": r(0.07, 0.6), "snowc": r(), "land_temp": r(250, 300),
        "soilw": r(), "tsea2": r(271, 301),
    }


def run(scheme, seed, side):
    """Outputs of `scheme` as a list of numpy arrays, from the JAX package
    (side="jax") or the port (side="torch"), on identical numpy inputs."""
    psa, ta, qa, qsat, rh, se, phi = tpo.random_columns(seed)
    ex = extras(seed)
    jx = side == "jax"
    A = (lambda x: jnp.asarray(grid(x))) if jx else \
        (lambda x: torch.from_numpy(grid(x)))
    raw = jnp.asarray if jx else torch.from_numpy
    geom = JGEOM if jx else TGEOM
    out = lambda xs: [np.asarray(x) for x in xs]

    if scheme == "humidity":
        hum = jhum if jx else thum
        sig = (np.asarray(JGEOM.fsg)[:, None, None] if jx else
               torch.from_numpy(np.asarray(TGEOM.fsg)).reshape(-1, 1, 1))
        r1, q1 = hum.spec_hum_to_rel_hum(A(ta), A(psa), sig, A(qa))
        q2, _ = hum.rel_hum_to_spec_hum(A(ta), A(psa), sig, A(rh))
        q3 = hum.get_qsat(A(ta[KX - 1]), A(psa), 1.0)
        return out([r1, q1, q2, q3])
    if scheme == "convection":
        conv = jconv if jx else tconv
        return out(conv.get_convection_tendencies(
            geom, A(psa), A(se), A(qa), A(qsat)))
    if scheme == "lsc":
        lsc = jlsc if jx else tlsc
        itop0 = grid(ex["iptop"])
        return out(lsc.get_large_scale_condensation_tendencies(
            geom, A(psa), A(qa), A(qsat), raw(itop0)))
    if scheme == "clouds_shortwave":
        sw = jsw if jx else tsw
        icl, cc, cs, qc = sw.clouds(
            A(qa), A(rh), A(ex["precnv"]), A(ex["precls"]),
            raw(grid(ex["iptop"])), A(ex["gse"]), A(ex["fmask"]))
        state = {
            "zenit_correction": A(ex["zenit"]), "qcloud_equiv": qc,
            "flux_solar_in": A(ex["fsol"]),
            "flux_ozone_upper": A(ex["ozupp"]),
            "flux_ozone_lower": A(ex["ozone"]),
            "alb_surface": A(ex["albsfc"]),
            "air_absortivity_co2": raw(np.asarray(6.0)),
            "stratospheric_correction": A(ex["stratz"]),
        }
        return out([icl, cc, cs, qc, *sw.get_shortwave_rad_fluxes(
            geom, state, A(psa), A(qa), icl, cc, cs)])
    if scheme == "longwave":
        lw = jlw if jx else tlw
        fband = raw(jlw.radset())
        ts = ta[KX - 1] + ex["dts"]
        fsfcu = orc.EMISFC * orc.SBC * ts**4
        fsfcd, dfabs, flux, st4a = lw.get_downward_longwave_rad_fluxes(
            geom, fband, raw(ex["lw_tau"]), A(ta))
        up = lw.get_upward_longwave_rad_fluxes(
            geom, fband, raw(ex["lw_tau"]), st4a, raw(ex["strat_corr"]),
            A(ta), A(ts), fsfcd, A(fsfcu), dfabs, flux)
        return out([fsfcd, dfabs, flux, st4a, *up])
    if scheme == "surface_fluxes":
        sf = jsf if jx else tsf
        A = (lambda x: jnp.asarray(grid_lat(x))) if jx else \
            (lambda x: torch.from_numpy(grid_lat(x)))
        fl = sf.get_surface_fluxes(
            geom, A(psa), A(ex["ua"]), A(ex["va"]), A(ta), A(qa), A(rh),
            A(phi), A(ex["phi0"]), A(ex["fmask"]), A(ex["forog"]),
            A(ex["tsea"]), A(ex["ssrd"]), A(ex["slrd"]), A(ex["alb_land"]),
            A(ex["alb_sea"]), A(ex["snowc"]), A(ex["land_temp"]),
            A(ex["soilw"]), lfluxland=True)
        names = ("ustr", "vstr", "shf", "evap", "slru", "hfluxn", "tsfc",
                 "tskin", "t0", "u0", "v0")
        return out([fl[n] for n in names] + list(fl["_carry"][:14]))
    if scheme == "vertical_diffusion":
        vd = jvd if jx else tvd
        return out(vd.get_vertical_diffusion_tend(
            geom, A(se), A(rh), A(qa), A(qsat), A(phi),
            raw(grid(ex["icnv"]))))
    raise AssertionError(scheme)


def assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert np.array_equal(got, want), what
        return
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_matches_jax(scheme, seed):
    want = run(scheme, seed, "jax")
    got = run(scheme, seed, "torch")
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, TOL_JAX, (scheme, seed, n))


def test_random_columns_exercise_the_branches():
    """Half the columns have a moist boundary layer: convection must fire in
    some and stay off in others, clouds must form, condensation must occur."""
    itop = run("convection", 0, "torch")[0]
    assert 5 < int((itop <= KX).sum()) < N - 5
    icl = run("clouds_shortwave", 2, "torch")[0]
    assert int((icl <= KX).sum()) > 5
    assert int((run("lsc", 1, "torch")[1] > 0).sum()) > 5


def _column(x, i):
    return np.asarray(x)[..., 0, i]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("scheme", ["convection", "lsc", "clouds_shortwave",
                                    "longwave", "vertical_diffusion"])
def test_scheme_matches_column_oracle(scheme, seed):
    """One column at a time through the loop-based numpy oracle."""
    psa, ta, qa, qsat, rh, se, phi = tpo.random_columns(seed)
    ex = extras(seed)
    got = run(scheme, seed, "torch")
    g = TGEOM
    scales = [max(np.abs(np.asarray(x, dtype=np.float64)).max(), 1e-300)
              for x in got]

    def check(n, i, want):
        have = _column(got[n], i)
        if got[n].dtype.kind in "iu":
            assert int(have) == int(want), (scheme, n, i)
        else:
            err = np.abs(have - np.asarray(want)).max() / scales[n]
            assert err <= TOL_ORACLE, (scheme, n, i, err)

    for i in range(0, N, 3):
        if scheme == "convection":
            want = orc.convection_column(psa[i], se[:, i], qa[:, i],
                                         qsat[:, i], g.fsg, g.dhs, g.wvi)
            for n in range(5):
                check(n, i, want[n])
        elif scheme == "lsc":
            want = orc.lsc_column(psa[i], qa[:, i], qsat[:, i],
                                  int(ex["iptop"][i]), g.fsg, g.dhs)
            for n in range(4):
                check(n, i, want[n])
        elif scheme == "clouds_shortwave":
            icl, cc, cs, qc = orc.clouds_column(
                qa[:, i], rh[:, i], ex["precnv"][i], ex["precls"][i],
                int(ex["iptop"][i]), ex["gse"][i], ex["fmask"][i])
            for n, w in enumerate((icl, cc, cs, qc)):
                check(n, i, w)
            tsr, ssrd, ssr, tt, lw_tau, rsc = orc.shortwave_column(
                psa[i], qa[:, i], icl, cc, cs, ex["fsol"][i], ex["ozupp"][i],
                ex["ozone"][i], ex["zenit"][i], ex["stratz"][i],
                ex["albsfc"][i], qc, 6.0, g.fsg, g.dhs)
            for n, w in enumerate((tsr, ssrd, ssr, tt, lw_tau, rsc), 4):
                check(n, i, w)
        elif scheme == "longwave":
            fband = tlw.radset()
            tau = ex["lw_tau"][:, :, 0, i]
            ts = ta[KX - 1, i] + ex["dts"][i]
            fsfcu = orc.EMISFC * orc.SBC * ts**4
            fsfcd, dfabs, flux, st4a = orc.longwave_down_column(
                ta[:, i], fband, tau, g.wvi)
            check(0, i, fsfcd)
            check(1, i, dfabs)
            check(2, i, flux)
            check(3, i, st4a.T)
            fsfc, ftop, dfup = orc.longwave_up_column(
                ta[:, i], ts, fsfcd, fsfcu, dfabs, flux, st4a, tau,
                ex["strat_corr"][:, 0, i], fband, g.dhs)
            for n, w in enumerate((fsfc, ftop, dfup), 4):
                check(n, i, w)
        else:
            tt, qt = orc.vdiff_column(se[:, i], rh[:, i], qa[:, i],
                                      qsat[:, i], phi[:, i],
                                      int(ex["icnv"][i]), g.fsg, g.dhs,
                                      g.sigh)
            check(2, i, tt)
            check(3, i, qt)
            assert not np.asarray(got[0]).any() and \
                not np.asarray(got[1]).any()


def test_sea_only_second_call_of_the_surface_fluxes():
    """lfluxland=False with the first call's carry (the coupled sea model's
    second evaluation): the land rows and the wind stress keep the first
    call's values, and the sea rows follow the closed formulas with the new
    sea temperature and the carried air temperature, density-wind product and
    humidity, here evaluated with the JAX package's pieces."""
    seed = 3
    psa, ta, qa, qsat, rh, se, phi = tpo.random_columns(seed)
    ex = extras(seed)
    grid = grid_lat
    A = lambda x: torch.from_numpy(grid(x))
    args = (TGEOM, A(psa), A(ex["ua"]), A(ex["va"]), A(ta), A(qa), A(rh),
            A(phi), A(ex["phi0"]), A(ex["fmask"]), A(ex["forog"]))
    rest = (A(ex["ssrd"]), A(ex["slrd"]), A(ex["alb_land"]), A(ex["alb_sea"]),
            A(ex["snowc"]), A(ex["land_temp"]), A(ex["soilw"]))
    first = tsf.get_surface_fluxes(*args, A(ex["tsea"]), *rest)
    second = tsf.get_surface_fluxes(*args, A(ex["tsea2"]), *rest,
                                    lfluxland=False, prev=first["_carry"])
    for name in ("ustr", "vstr"):
        assert torch.equal(second[name], first[name]), name
    for name in ("shf", "evap", "slru", "hfluxn"):
        assert torch.equal(second[name][0], first[name][0]), name
        assert not torch.equal(second[name][1], first[name][1]), name

    jfirst = run("surface_fluxes", seed, "jax")
    t1_sea, denvvs2, q1_sea = jfirst[12], jfirst[13], jfirst[14]
    tsea = grid(ex["tsea2"])
    shf_s = jsf.CHS * 1004.0 * denvvs2 * (tsea - t1_sea)
    qs = np.asarray(jhum.get_qsat(jnp.asarray(tsea), jnp.asarray(grid(psa)),
                                  1.0))
    evap_s = jsf.CHS * denvvs2 * (qs - q1_sea)
    slru_s = orc.EMISFC * orc.SBC * tsea**4
    hfl_s = (grid(ex["ssrd"]) * (1.0 - grid(ex["alb_sea"])) + grid(ex["slrd"])
             - slru_s + shf_s + 2501.0 * evap_s)
    for name, want in (("shf", shf_s), ("evap", evap_s), ("slru", slru_s),
                       ("hfluxn", hfl_s)):
        assert_close(second[name][1].numpy(), want, TOL_JAX, name)
    fm = grid(ex["fmask"])
    assert_close(second["tsfc"].numpy(),
                 tsea + fm * (grid(ex["land_temp"]) - tsea), TOL_JAX, "tsfc")
