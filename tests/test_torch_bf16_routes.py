"""The bf16_tendencies configuration of the port against the JAX package off
the T30 dense route: at T47 (the matmul DFT, which both packages take
through einsums there: the port's T47/T63 kernels' plain version), on the
fft route, on the latitude bands and in float64.

With the flag the column functions emit their tendency-class outputs in
bfloat16. On the dense route the direct transform reads them as 2-byte
operands (tests/test_torch_bf16.py); on every other route the JAX package
widens the bfloat16 grid to the tables' type and takes the ordinary
transform (pyspeedy_tpu/ops/spectral.py::grid2spec_p), and so does the port.
Held here against JAX on the same numpy inputs: grid_dynamics_core and
grid_physics with the flag at T47 in float32 and float64, the direct
transform of a bfloat16 grid on the fft, einsum and dense routes, a few
batched steps with the flag (T47 float32 on the matmul route, T30 float64
on the fft route), a band transform of a bfloat16 grid, and the rounding of
a float64 value to bfloat16.

bfloat16 outputs are compared by the rule of tests/test_torch_bf16.py: an
element may differ by one bfloat16 unit in the last place or by 1e-6 of the
field's largest value, and at most 1e-3 of the elements differ at all. Runs
are compared by the bounds set out at their test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.models.tendencies import grid_dynamics_core as j_core
from pyspeedy_tpu.ops import spectral as JS
from pyspeedy_tpu.ops.geometry import build_geometry as j_geometry
from pyspeedy_tpu.parallel import ensemble as JE
from pyspeedy_tpu.params import T30L8 as J_T30L8, T47L8 as J_T47L8
from pyspeedy_tpu.physics import driver as JD
from pyspeedy_tpu.testing import make_demo_model as j_make_demo_model
from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models.tendencies import grid_dynamics_core as t_core
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.ops.geometry import build_geometry as t_geometry
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.parallel import shard_transforms as PST
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8, T47L8 as T_T47L8
from pyspeedy_tpu_torch.physics import driver as TD

from test_torch_bf16 import compare_bf16

# One thread for PyTorch's CPU kernels: several test processes side by side
# would fight for the cores.
torch.set_num_threads(1)

OUT_NAMES = ("utend", "vtend", "ttend", "trtend", "psdt_g", "flux_ut",
             "flux_vt", "flux_qu", "flux_qv", "ke")
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
N_STEPS = 3
_cache = {}


def params(which, prec):
    """The JAX package's and the port's parameters of one configuration."""
    j, t, mode = {"T47": (J_T47L8, T_T47L8, "matmul"),
                  "T30 fft": (J_T30L8, T_T30L8, "fft"),
                  "T30 dense": (J_T30L8, T_T30L8, "matmul")}[which]
    return (dataclasses.replace(j, precision=prec, fft_mode=mode),
            dataclasses.replace(t, precision=prec, fft_mode=mode))


def jax_model(which, prec):
    """The JAX package's demo model of a configuration, built once: its
    initialization compiles jitted functions."""
    key = ("jax", which, prec)
    if key not in _cache:
        _cache[key] = j_make_demo_model(params(which, prec)[0])
    return _cache[key]


def consts(which, prec):
    """(JAX consts with the flag, the port's consts with the flag, on the
    CPU), built once."""
    key = ("consts", which, prec)
    if key not in _cache:
        jp, tp = params(which, prec)
        jc, _ = JM.build_consts(jp, bf16_tendencies=True)
        tc, _ = TM.build_consts(tp, device="cpu", bf16_tendencies=True)
        _cache[key] = (jc, tc)
    return _cache[key]


def rel_err(got, want):
    """Largest difference over the field's largest value (the largest
    value itself where `want` is all zero)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


# ---------------------------------------------------------------------------
# The column functions with the flag at T47
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_grid_dynamics_core_with_the_flag_matches_jax_at_t47(prec):
    """Seeded fields at 72 x 144, two members: the ten bfloat16 outputs of
    the port's plain version against JAX's under vmap, both with the flag
    (float64 rounds through float32 on both sides)."""
    jc, tc = consts("T47", prec)
    p = tc.params
    dt = np.float32 if prec == "f32" else np.float64
    rng = np.random.default_rng(47)
    mk = lambda k, scale, mean=0.0: (
        mean + scale * rng.standard_normal((2, k, p.il, p.ix))).astype(dt)
    args = (mk(p.kx, 3e-5), mk(p.kx, 1e-5), mk(p.kx, 15.0, 250.0),
            mk(p.ntr * p.kx, 2.0, 5.0), mk(p.kx, 15.0), mk(p.kx, 10.0),
            mk(2, 2e-8))
    shape = (p.il, p.ix)
    planes = (jnp.broadcast_to(jnp.asarray(jc.sp.cosgr)[:, None], shape),
              jnp.broadcast_to(jnp.asarray(jc.geom.coriol)[:, None], shape))
    want = jax.vmap(lambda *a: j_core(jc, *a, *planes))(
        *map(jnp.asarray, args))
    got = t_core(tc.col, *(torch.from_numpy(a) for a in args),
                 bf16_out=True)
    for name, g, w in zip(OUT_NAMES, got, want):
        compare_bf16(name, g, w)


def _physics_inputs(prec):
    """grid_physics arguments at T47 from the JAX float32 demo model's
    state (as tests/test_torch_presets.py builds them, the humidity raised
    so that the schemes fire), in `prec`: JAX's, and the port's with a
    member axis."""
    jconsts, jstate, _ = jax_model("T47", "f32")
    dt = jnp.float32 if prec == "f32" else jnp.float64
    sp = jconsts.sp
    g = lambda f, kcos=1: JS.spec2grid_p(sp, f, kcos).astype(dt)
    ucos, vcos = JS.vort2vel_p(sp, jstate["vor"][0], jstate["div"][0])
    grids = (g(ucos, 2), g(vcos, 2), g(jstate["t"][0]),
             1.35 * g(jstate["tr"][0][:, 0]), g(jstate["phi"]),
             g(jstate["ps"][0]))
    bc = tuple(jnp.asarray(jstate[n], dt) for n in JD.BC_FIELDS)
    co2 = jnp.asarray(jstate["air_absortivity_co2"], dt)
    T = lambda x: torch.from_numpy(np.array(x))
    targs = (*(T(x)[None] for x in grids), tuple(T(x) for x in bc), (),
             T(co2))
    return (*grids, bc, (), co2), targs


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_grid_physics_with_the_flag_matches_jax_at_t47(prec):
    """The demo model's columns at T47, a step with shortwave: the four
    bfloat16 tendencies of the port's plain version against JAX's, both
    with the flag; the diagnostics and the cache keep the model's type."""
    jc, tc = consts("T47", prec)
    jc = dataclasses.replace(jc, pallas_physics=False, grid_phi=False)
    jargs, targs = _physics_inputs(prec)
    want = JD.grid_physics(jc, True, *jargs)
    got = TD.grid_physics(tc, True, *targs)
    for name, g, w in zip(("utend", "vtend", "ttend", "qtend"), got[:4],
                          want[:4]):
        compare_bf16(name, g[0], w)
    assert all(x.dtype == tc.params.dtype for x in got[4] + got[5])


# ---------------------------------------------------------------------------
# The direct transform of a bfloat16 grid on each route
# ---------------------------------------------------------------------------

ROUTES = {"fft-f32": ("T30 fft", "f32"), "fft-f64": ("T30 fft", "f64"),
          "einsum-T47-f32": ("T47", "f32"),
          "dense-T30-f64": ("T30 dense", "f64")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_direct_transform_of_a_bf16_grid_matches_jax(route):
    """ops.spectral.grid2spec_many_p of a group of bfloat16 grids against
    pyspeedy_tpu.ops.spectral.grid2spec_p of the same grids: on the fft and
    einsum routes both widen the grid and take the ordinary transform
    (1e-5 in float32, 1e-12 in float64, and bitwise the port's transform of
    the widened grid); on the dense route at float64 both take the 2-byte
    operand chain, float64 sums and result (2^-8: a rounding of the Fourier
    intermediate may fall the other way)."""
    which, prec = ROUTES[route]
    jp, tp = params(which, prec)
    jsp = JS.build_spectral(jp, j_geometry(jp),
                            use_matmul_fft=jp.fft_mode == "matmul")
    tsp = TS.build_spectral(tp, t_geometry(tp),
                            use_matmul_fft=tp.fft_mode == "matmul",
                            device="cpu")
    assert tsp.use_dense_legendre == (which == "T30 dense")
    rng = np.random.default_rng(16)
    g32 = [rng.standard_normal(lead + (tsp.il, tsp.ix)).astype(np.float32)
           for lead in ((2, 8), (2, 1))]
    tg = [torch.from_numpy(g).to(torch.bfloat16) for g in g32]
    got = TS.grid2spec_many_p(tsp, tg, 1)
    dense = which == "T30 dense"
    limit = 2.0 ** -8 if dense else {"f32": 1e-5, "f64": 1e-12}[prec]
    for g, x, out in zip(g32, tg, got):
        want = jax.vmap(lambda a: JS.grid2spec_p(jsp, a))(
            jnp.asarray(g).astype(jnp.bfloat16))
        assert out.dtype == tsp.rdtype and want.dtype == out.numpy().dtype
        assert rel_err(out.numpy(), want) <= limit
        wide = TS.grid2spec_p(tsp, x.to(tsp.rdtype), 1)
        if dense:
            assert 1e-6 < rel_err(out.numpy(), wide.numpy()) < 1e-2
        else:
            assert torch.equal(out, wide)


# ---------------------------------------------------------------------------
# A few batched steps with the flag
# ---------------------------------------------------------------------------

RUNS = {"T47-f32-matmul": ("T47", "f32"), "T30-f64-fft": ("T30 fft", "f64")}
# Bounds of a run with the flag against JAX's, relative to each field's
# largest value. Both sides round the same tendencies to bfloat16, and
# differ where a value straddles a bfloat16 rounding boundary by the other
# side's last bits. In float64 that is practically never: the float64
# runs' own limit (tests/test_torch_presets.py). In float32, near the rest
# state, the tendencies are small differences of large terms and many
# round the other way: the bounds of tests/test_torch_bf16.py, the JAX
# package's own between its bfloat16 and float32 runs (the humidity held
# as the temperature).
RUN_BOUNDS = {"f32": {"t": 1e-3, "ps": 1e-3, "tr": 1e-3, "vor": 5e-2,
                      "div": 5e-2},
              "f64": dict.fromkeys(PROGNOSTICS + ("phi", "precnv", "precls",
                                                  "hfluxn"), 1e-10)}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_batched_steps_with_the_flag_match_jax(run):
    """N_STEPS full-physics steps of the batched runner with the flag from
    the JAX initial state carried across (B=2, member 1 perturbed in t),
    against JAX's batched runner with the flag, within RUN_BOUNDS; and the
    flag moves the port's run off its run without it (more than 1e-8)."""
    which, prec = RUNS[run]
    jconsts, jstate, jcal = jax_model(which, prec)
    jb_consts = dataclasses.replace(jconsts, bf16_tendencies=True)
    _, tc = consts(which, prec)
    p = tc.params
    rng = np.random.default_rng(17)
    tri = np.arange(p.mx)[:, None] + np.arange(p.nx)[None, :] <= p.trunc
    noise = 1e-2 * rng.standard_normal((2, 2, p.kx, p.mx, p.nx)) * tri
    noise[0] = 0.0
    noise[:, 1, :, 0, :] = 0.0
    noise = noise.astype(np.float32 if prec == "f32" else np.float64)
    jb = JE.broadcast_state(jstate, 2)
    jb["t"] = (jb["t"][0] + noise, jb["t"][1] + noise)
    ctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), 2, N_STEPS)
    jout = jax.tree.map(np.asarray, JE.make_run_steps_batched(
        jb_consts, phase=2)(jb, ctx))
    assert not bool(jout["error_flag"].any())

    tb = TE.broadcast_state(interop.state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu", dtype=p.dtype), 2)
    tnoise = torch.from_numpy(noise)
    tb["t"] = (tb["t"][0] + tnoise, tb["t"][1] + tnoise)
    tctx, _ = TM.build_step_ctx(dataclasses.replace(jcal), 2, N_STEPS)
    tout = TE.make_run_steps_batched(tc, device="cpu")(tb, tctx)
    full = TE.make_run_steps_batched(
        dataclasses.replace(tc, bf16_tendencies=False), device="cpu")(
        tb, tctx)
    assert not bool(tout["error_flag"].any())
    moved = 0.0
    for name, bound in RUN_BOUNDS[prec].items():
        for lev in range(2 if name in PROGNOSTICS else 1):
            got = tout[name][lev] if name in PROGNOSTICS else tout[name]
            want = jout[name][lev] if name in PROGNOSTICS else jout[name]
            assert got.dtype == p.dtype
            assert rel_err(got.numpy(), want) <= bound, (name, lev)
            if name in PROGNOSTICS:
                moved = max(moved, rel_err(got.numpy(),
                                           full[name][lev].numpy()))
    assert moved > 1e-8, "bf16_tendencies had no effect (dead flag?)"


# ---------------------------------------------------------------------------
# The bands and the rounding of a float64
# ---------------------------------------------------------------------------

def test_a_band_transform_of_a_bf16_grid_is_the_widened_grids(monkeypatch):
    """A latitude band of a 2-band mesh (the fft route at T30, the einsum
    route at T47, float32 and float64): the direct group of bfloat16 grids
    bitwise the group of the same grids widened to the tables' type, each
    band's partial sums; the two bands' sums together are JAX's transform
    of the bfloat16 grid (1e-5 / 1e-12)."""
    monkeypatch.setattr(PST.dist, "all_reduce", lambda *a, **k: None)
    for which, prec in (("T30 fft", "f32"), ("T47", "f64")):
        jp, tp = params(which, prec)
        tsp = TS.build_spectral(tp, t_geometry(tp),
                                use_matmul_fft=tp.fft_mode == "matmul",
                                device="cpu")
        rng = np.random.default_rng(18)
        g32 = rng.standard_normal((2, 3, tsp.il, tsp.ix)).astype(np.float32)
        grid = torch.from_numpy(g32).to(torch.bfloat16)
        total = 0.0
        for index in range(2):
            band = PST.band_transform(tsp, 2, index, group=object())
            rows = band.band.rows
            parts = PST.grid2spec_many_p(band, [grid[..., rows, :]], 1)
            wide = PST.grid2spec_many_p(
                band, [grid[..., rows, :].to(tsp.rdtype)], 1)
            assert parts[0].dtype == tsp.rdtype
            assert torch.equal(parts[0], wide[0])
            total = total + parts[0]
        jsp = JS.build_spectral(jp, j_geometry(jp),
                                use_matmul_fft=jp.fft_mode == "matmul")
        want = jax.vmap(lambda a: JS.grid2spec_p(jsp, a))(
            jnp.asarray(g32).astype(jnp.bfloat16))
        limit = 1e-5 if prec == "f32" else 1e-12
        assert rel_err(total.numpy(), want) <= limit, which


def test_a_float64_value_rounds_to_bfloat16_as_jax_rounds_it():
    """A float64 just past (or short of) a bfloat16 rounding tie by less
    than a float32 unit: rounded directly it goes up (down), rounded
    through float32 it lands on the tie and goes to even. JAX's
    astype(bfloat16) on the CPU rounds through float32; so does the port's
    cast (the plain versions' .to(torch.bfloat16); the kernels'
    __float2bfloat16_rn(float(v)) are held to it on the card by
    chip_smoke.py)."""
    tie = 1.0 + 2.0 ** -8                     # halfway between 1 and 1+2^-7
    vals = np.array([tie + 2.0 ** -30, tie - 2.0 ** -30, -(tie + 2.0 ** -30),
                     3.0 * (1.0 + 2.0 ** -8) + 2.0 ** -28,
                     (1.0 + 3.0 * 2.0 ** -8) - 2.0 ** -29, 0.1, -7.3e5])
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(
        jnp.float64))
    assert want[0] == 1.0 and want[1] == 1.0 and want[2] == -1.0
    direct = np.where(vals > 0, 1.0 + 2.0 ** -7, -(1.0 + 2.0 ** -7))[:3]
    assert (want[[0, 2]] != direct[[0, 2]]).all()     # a double rounding
    got = torch.from_numpy(vals).to(torch.bfloat16).double().numpy()
    assert np.array_equal(got, want)
    # The grid dynamics' ten outputs with the flag, from seeded float64
    # fields at T47: each the rounding JAX gives of the port's own float64
    # value, among them values that a direct rounding would round the other
    # way (about 2^-16 of random values are).
    _, tc = consts("T47", "f64")
    p = tc.params
    rng = np.random.default_rng(64)
    mk = lambda k, scale, mean=0.0: torch.from_numpy(
        mean + scale * rng.standard_normal((2, k, p.il, p.ix)))
    args = (mk(p.kx, 3e-5), mk(p.kx, 1e-5), mk(p.kx, 15.0, 250.0),
            mk(p.ntr * p.kx, 2.0, 5.0), mk(p.kx, 15.0), mk(p.kx, 10.0),
            mk(2, 2e-8))
    full = t_core(tc.col, *args)
    flagged = t_core(tc.col, *args, bf16_out=True)
    twice = 0
    for f, b in zip(full, flagged):
        x = f.numpy()
        want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float64))
        assert np.array_equal(b.double().numpy(), want)
        bits = x.view(np.int64)
        direct = (((bits + (1 << 44) - 1 + ((bits >> 45) & 1)) >> 45)
                  << 45).view(np.float64)
        twice += int((direct != want).sum())
    assert twice > 0
