"""The redesigned fused spectral transforms (pyspeedy_tpu_torch/csrc/
fused_transform.cu) and their grouped entry points.

The kernels fold the transforms by the structure of their tables: the
Legendre tables' hemispheric parity and zero triangle, and the DFT tables'
half-period symmetry. Here, on the CPU:

* the table facts the kernels rely on, so that a table that broke them fails
  here instead of drifting silently on the card;
* a numpy model of the kernels' arithmetic (the folds, the triangle, the
  2-byte operand roundings), held against the JAX package's
  ``grid2spec_p`` / ``spec2grid_p`` on the dense route: 1e-13 in float64 and
  1e-5 in float32 of the result's largest value (the folds change the sums
  by rounding only), 2^-8 in the 2-byte mode;
* the grouped entry points against one call per field, bitwise, and the
  step's call sites with and without grouping, bitwise;
* what the grouped CUDA wrappers refuse, before anything is built.

The gpu-marked tests hold the kernels against their plain versions on the
card, and a group against its fields launched one by one, bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspeedy_tpu.ops import geometry as jgeom
from pyspeedy_tpu.ops import spectral as JS
from pyspeedy_tpu.params import T30L8 as J_T30L8
from pyspeedy_tpu_torch.models import tendencies as TT
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import geometry as tgeom
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.ops import transform_kernels as TK
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.parallel.ensemble import broadcast_state
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.testing import make_demo_model

torch.set_num_threads(1)

TOL = {"f64": 1e-13, "f32": 1e-5}
NP_DTYPE = {"f64": np.float64, "f32": np.float32}
_cache = {}


def transforms(prec):
    """(JAX tables, port tables) of the dense route at T30, built once."""
    if prec not in _cache:
        jp = dataclasses.replace(J_T30L8, precision=prec)
        tp = dataclasses.replace(T_T30L8, precision=prec)
        jsp = JS.build_spectral(jp, jgeom.build_geometry(jp),
                                use_matmul_fft=True)
        tsp = TS.build_spectral(tp, tgeom.build_geometry(tp),
                                use_matmul_fft=True, device="cpu")
        _cache[prec] = (jsp, tsp)
    return _cache[prec]


def rel_err(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def triangle(mx, nx):
    """1 where m + n <= nx - 1 (the pairs the kernels compute), else 0."""
    return np.arange(mx)[:, None] + np.arange(nx)[None, :] <= nx - 1


def random_spec(rng, lead, dtype):
    p = J_T30L8
    return (rng.standard_normal(lead + (2, p.mx, p.nx))
            * triangle(p.mx, p.nx)).astype(dtype)


# ---------------------------------------------------------------------------
# (a) The table facts the kernels rely on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", ["cpol_dir_full", "cpol_inv_full"])
def test_legendre_tables_have_bitwise_parity_and_a_zero_triangle(prec, name):
    """L[il-1-j, m, n] == (-1)**n L[j, m, n] exactly (the parity depends on
    the array index n alone), and L == 0 exactly wherever m + n > nx - 1:
    527 of the 992 (m, n) pairs are non-zero. The kernels' tables keep the
    24 northern latitudes and the 527 pairs only."""
    _, tsp = transforms(prec)
    L = getattr(tsp, name).numpy()
    il, mx, nx = L.shape
    sign = (-1.0) ** np.arange(nx)
    assert np.array_equal(L[::-1], (sign * L).astype(L.dtype))
    tri = triangle(mx, nx)
    assert np.all(L[:, ~tri] == 0.0)
    assert int(tri.sum()) == 527 == int((np.abs(L).max(axis=0) > 0).sum())
    assert TK.T30_SHAPE == (tsp.il, tsp.ix, tsp.mx, tsp.nx)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_dft_tables_have_half_period_symmetry_to_rounding(prec):
    """D[c, i + ix/2, m] = (-1)**m D[c, i, m] for the forward table and the
    same along i for the inverse one, to rounding only (not bitwise): the
    folded DFT stages read the first half of each table."""
    _, tsp = transforms(prec)
    ih = tsp.ix // 2
    sign = (-1.0) ** np.arange(tsp.mx)
    fwd = tsp.dft_fwd_ri.double().numpy()
    inv = tsp.dft_inv_ri.double().numpy()
    assert np.abs(fwd[:, ih:] - sign * fwd[:, :ih]).max() <= 1e-15
    assert np.abs(inv[:, :, ih:] - sign[:, None] * inv[:, :, :ih]).max() \
        <= 1e-13
    assert float(tsp.dft_inv_ri[1, 0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (b) A numpy model of the kernels' arithmetic against the JAX functions
# ---------------------------------------------------------------------------

def bf16_round(x):
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def triangle_pairs(mx, nx):
    """(m, n) of the kernels' triangle rows, m-major."""
    return np.array([(m, n) for m in range(mx) for n in range(nx - m)]).T


def unpack(tsp, table, direct):
    """The kernels' folded tables (ops/spectral.py::_fold_tables) as (DFT
    (2 parity, ih, 32) or (2 parity, 32, ih), Legendre (iy, triangle))."""
    ih, iy = tsp.ix // 2, tsp.il // 2
    t = table.numpy()
    ntri = iy * triangle_pairs(tsp.mx, tsp.nx).shape[1]
    if direct:
        return t[:t.size - ntri].reshape(2, ih, -1), t[t.size - ntri:].reshape(
            iy, -1)
    return t[ntri:].reshape(2, -1, ih), t[:ntri].reshape(iy, -1)


def model_direct(tsp, grid, bf16=False):
    """The direct kernel's arithmetic, on the tables it reads, for a (...,
    il, ix) grid -> (..., 2, mx, nx): the DFT folded by half a period (sums
    against the even wavenumbers, differences against the odd ones), the
    Fourier intermediate folded by hemisphere, the Legendre sum over the
    northern latitudes and the triangle only, 0 elsewhere. With `bf16` the
    grid and the tables are bfloat16 values, the sums float32 and the Fourier
    intermediate rounded to bfloat16, as in the 2-byte operand mode."""
    D, L = unpack(tsp, tsp.fold_dir_bf16 if bf16 else tsp.fold_dir, True)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    ih, iy, h = ix // 2, il // 2, (mx + 1) // 2
    folded = (grid[..., :ih] + grid[..., ih:], grid[..., :ih] - grid[..., ih:])
    F = np.zeros(grid.shape[:-2] + (2, il, mx), grid.dtype)
    for c in range(2):
        for par in range(2):
            ms = np.arange(par, mx, 2)
            F[..., c, :, ms] = np.moveaxis(
                folded[par] @ D[par, :, c * h:c * h + len(ms)], -1, 0)
    if bf16:
        F = bf16_round(F)
    north, south = F[..., :iy, :], F[..., ::-1, :][..., :iy, :]
    tm, tn = triangle_pairs(mx, nx)
    G = np.where(tn % 2 == 0, (north + south)[..., tm], (north - south)[
        ..., tm])                                   # (..., 2, iy, triangle)
    S = np.zeros(grid.shape[:-2] + (2, mx, nx), grid.dtype)
    S[..., tm, tn] = np.einsum("jp,...cjp->...cp", L, G)
    return S


def model_inverse(tsp, p, kcos):
    """The inverse kernel's arithmetic on a (..., 2, mx, nx) pair -> (...,
    il, ix): even and odd Legendre partial sums over the triangle, F[j] =
    E + O and F[il-1-j] = E - O, the imaginary part of m = 0 ignored, the
    inverse DFT folded by half a period (g[i] = Pe + Po, g[i + ix/2] =
    Pe - Po), the 1/cos(lat) scale at the end."""
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    ih, iy, h = ix // 2, il // 2, (mx + 1) // 2
    B, L = unpack(tsp, tsp.fold_inv, False)
    tm, tn = triangle_pairs(mx, nx)
    Lh = np.zeros((iy, mx, nx), L.dtype)
    Lh[:, tm, tn] = L
    E = np.einsum("jmn,...cmn->...cjm", Lh[..., 0::2], p[..., 0::2])
    O = np.einsum("jmn,...cmn->...cjm", Lh[..., 1::2], p[..., 1::2])
    F = np.concatenate([E + O, (E - O)[..., ::-1, :]], axis=-2)
    F[..., 1, :, 0] = 0.0
    Pe = sum(F[..., c, :, 0::2] @ B[0, c * h:c * h + h] for c in range(2))
    Po = sum(F[..., c, :, 1::2] @ B[1, c * h:c * h + h - 1]
             for c in range(2))
    g = np.concatenate([Pe + Po, Pe - Po], axis=-1)
    if kcos != 1:
        g = g * tsp.cosgr.numpy()[:, None]
    return g.astype(p.dtype)


@pytest.mark.parametrize("pdim", [0, 1])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_model_of_the_direct_kernel_matches_jax(prec, pdim):
    jsp, tsp = transforms(prec)
    rng = np.random.default_rng(500 + pdim)
    lead = (3,) if pdim == 0 else (2, 3)
    grid = rng.standard_normal(lead + (tsp.il, tsp.ix)).astype(NP_DTYPE[prec])
    fn = lambda g: JS.grid2spec_p(jsp, g)
    want = fn(jnp.asarray(grid)) if pdim == 0 else jax.vmap(fn)(
        jnp.asarray(grid))
    got = np.moveaxis(model_direct(tsp, grid), -3, pdim)
    assert got.dtype == NP_DTYPE[prec]
    assert rel_err(got, want) <= TOL[prec]


@pytest.mark.parametrize("kcos", [1, 2])
@pytest.mark.parametrize("pdim", [0, 1])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_model_of_the_inverse_kernel_matches_jax(prec, pdim, kcos):
    jsp, tsp = transforms(prec)
    rng = np.random.default_rng(600 + 10 * pdim + kcos)
    lead = (3,) if pdim == 0 else (2, 3)
    spec = random_spec(rng, lead, NP_DTYPE[prec])          # (..., 2, mx, nx)
    theirs = np.moveaxis(spec, -3, pdim)                   # pair axis at pdim
    fn = lambda s: JS.spec2grid_p(jsp, s, kcos)
    want = fn(jnp.asarray(theirs)) if pdim == 0 else jax.vmap(fn)(
        jnp.asarray(theirs))
    got = model_inverse(tsp, spec, kcos)
    assert got.dtype == NP_DTYPE[prec]
    assert rel_err(got, want) <= TOL[prec]


def test_model_ignores_the_m0_imaginary_plane():
    _, tsp = transforms("f64")
    rng = np.random.default_rng(8)
    spec = random_spec(rng, (2,), np.float64)
    spec[:, 1, 0, :] = 0.0
    dirty = spec.copy()
    dirty[:, 1, 0, :] = 1e3 * rng.standard_normal((2, tsp.nx))
    assert np.array_equal(model_inverse(tsp, dirty, 1),
                          model_inverse(tsp, spec, 1))


def test_model_of_the_2_byte_operand_mode_matches_jax():
    """The 2-byte operand mode: bfloat16 grid and tables, float32 sums, the
    Fourier intermediate rounded to bfloat16. 2^-8 of the largest value: a
    bfloat16 rounding of the intermediate may fall the other way where the
    folded sum lies near a tie."""
    jsp, tsp = transforms("f32")
    rng = np.random.default_rng(700)
    g32 = rng.standard_normal((4, tsp.il, tsp.ix)).astype(np.float32)
    jg = jnp.asarray(g32).astype(jnp.bfloat16)
    grid = np.asarray(jg.astype(jnp.float32))
    assert np.array_equal(grid, bf16_round(g32))
    want = JS.grid2spec_p(jsp, jg)
    got = np.moveaxis(model_direct(tsp, grid, bf16=True), -3, 0)
    assert rel_err(got, want) <= 2.0 ** -8
    full = np.moveaxis(model_direct(tsp, grid), -3, 0)
    assert 1e-6 < rel_err(got, full) < 1e-2


# ---------------------------------------------------------------------------
# (c) The grouped plain entry points against one call per field
# ---------------------------------------------------------------------------

def _strided_fields(tsp, dtype, seed):
    """Grids and spectral pairs in the layouts the step hands over: a dense
    stack, a level slice of a flux stack, a tracer's level block, a stride-0
    member axis; pair axis at 1."""
    rng = np.random.default_rng(seed)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    t = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)
    tri = torch.from_numpy(triangle(mx, nx).astype(np.float64)).to(dtype)
    grids = [t(2, 3, il, ix), t(2, 6, il, ix)[:, 3:5], t(2, il, ix),
             t(1, 2, il, ix).expand(3, 2, il, ix)]
    pairs = [t(2, 2, 3, mx, nx) * tri,
             (t(2, 2, 2, 3, mx, nx) * tri)[:, :, 1],
             t(2, 2, mx, nx) * tri,
             (t(1, 2, 2, mx, nx) * tri).expand(3, 2, 2, mx, nx)]
    return grids, pairs


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_grouped_plain_calls_equal_one_call_per_field(prec):
    _, tsp = transforms(prec)
    dtype = tsp.rdtype
    grids, pairs = _strided_fields(tsp, dtype, 9)
    kcos = [1, 2, 2, 1]
    TK.reset_plain_chain_calls()
    many_d = TK.fused_grid2spec_many(tsp, grids, 1)
    many_i = TK.fused_spec2grid_many(tsp, pairs, kcos, 1)
    assert TK.plain_chain_calls == {"grid2spec": 4, "spec2grid": 4}
    for g, got in zip(grids, many_d):
        assert torch.equal(got, TK.fused_grid2spec(tsp, g, 1))
    for p, k, got in zip(pairs, kcos, many_i):
        assert torch.equal(got, TK.fused_spec2grid(tsp, p, k, 1))
    # ops.spectral's grouped forms, on the dense route and on the fft route
    # (a loop there), more fields than one launch takes included.
    assert all(torch.equal(a, b) for a, b in zip(
        TS.grid2spec_many_p(tsp, grids, 1), many_d))
    long = grids * 5
    assert len(long) > TK.MAX_SEGMENTS
    assert all(torch.equal(a, TS.grid2spec_p(tsp, g, 1)) for a, g in zip(
        TS.grid2spec_many_p(tsp, long, 1), long))
    tp = dataclasses.replace(T_T30L8, precision=prec)
    fft = TS.build_spectral(tp, tgeom.build_geometry(tp),
                            use_matmul_fft=False, device="cpu")
    assert all(torch.equal(a, TS.spec2grid_p(fft, p, k, 1)) for a, p, k in
               zip(TS.spec2grid_many_p(fft, pairs, kcos, 1), pairs, kcos))
    assert TS.grid2spec_many_p(tsp, [], 1) == []
    with pytest.raises(ValueError, match="kcos"):
        TS.spec2grid_many_p(tsp, pairs, [1, 2], 1)


def test_grouped_bf16_plain_calls_equal_one_call_per_field():
    _, tsp = transforms("f32")
    grids, _ = _strided_fields(tsp, torch.float32, 10)
    mixed = [grids[0].to(torch.bfloat16), grids[1], grids[2].to(
        torch.bfloat16)]
    for g, got in zip(mixed, TK.fused_grid2spec_many(tsp, mixed, 1)):
        assert got.dtype == torch.float32
        assert torch.equal(got, TK.fused_grid2spec(tsp, g, 1))


# ---------------------------------------------------------------------------
# (d) The step's call sites, grouped and one call per field
# ---------------------------------------------------------------------------

def _demo():
    if "demo" not in _cache:
        _cache["demo"] = make_demo_model(T_T30L8, device="cpu",
                                         fft_mode="matmul")
    return _cache["demo"]


def _one_call_per_field(monkeypatch):
    """The grouped forms as one call per field (a group of one each, what
    grid2spec_p / spec2grid_p make of a field)."""
    g2s, s2g = TS.grid2spec_many_p, TS.spec2grid_many_p
    monkeypatch.setattr(TS, "grid2spec_many_p", lambda sp, grids, pdim=0: [
        g2s(sp, [g], pdim)[0] for g in grids])
    monkeypatch.setattr(TS, "spec2grid_many_p", lambda sp, ps, kcos=1,
                        pdim=0: [s2g(sp, [p], [k], pdim)[0] for p, k in
                                 zip(ps, TK.kcos_list(kcos, len(ps)))])


def _record_groups(monkeypatch):
    sizes = []
    for name in ("fused_grid2spec_many", "fused_spec2grid_many"):
        fn = getattr(TK, name)

        def rec(sp, fields, *a, _fn=fn, _name=name):
            fields = list(fields)
            sizes.append((_name, len(fields)))
            return _fn(sp, fields, *a)
        monkeypatch.setattr(TK, name, rec)
    return sizes


def test_grid_tendency_specs_are_the_same_grouped(monkeypatch):
    """The step's transforms as three groups (7 inverse, 5 physics inverse
    with grid_phi, 7 + 3 ntr direct with psdt) give bitwise the tensors of one
    call per field, on the CPU."""
    consts, state1, _ = _demo()
    assert consts.physics_on and consts.sp.use_dense_legendre
    ctx = {"compute_shortwave": True, "stepno": 2}
    run = lambda: TT.grid_tendency_specs(
        consts, broadcast_state(state1, 2), 1, TD.get_physical_tendencies,
        ctx)
    sizes = _record_groups(monkeypatch)
    specs, psdt, st = run()
    ntr = consts.params.ntr
    assert sizes == [("fused_spec2grid_many", 7),
                     ("fused_spec2grid_many", 5 if consts.grid_phi else 6),
                     ("fused_grid2spec_many", 7 + 3 * ntr)]
    monkeypatch.undo()
    _one_call_per_field(monkeypatch)
    specs1, psdt1, st1 = run()
    assert len(specs) == len(specs1) == 6 + 3 * ntr
    assert all(torch.equal(a, b) for a, b in zip(specs, specs1))
    assert torch.equal(psdt, psdt1)
    assert float(psdt[..., 0, 0].abs().max()) == 0.0
    for name in ("phi", TD.DIAG_FIELDS[0], TD.CACHE_FIELDS[0]):
        assert torch.equal(st[name], st1[name])


@pytest.mark.parametrize("grid_phi", [True, False])
def test_physics_inputs_are_the_same_grouped(monkeypatch, grid_phi):
    consts, state1, _ = _demo()
    consts = dataclasses.replace(consts, grid_phi=grid_phi)
    state = broadcast_state(state1, 2)
    sizes = _record_groups(monkeypatch)
    args, kw = TD.physics_grid_inputs(consts, state, True)
    assert sizes == [("fused_spec2grid_many", 5 if grid_phi else 6)]
    monkeypatch.undo()
    _one_call_per_field(monkeypatch)
    args1, kw1 = TD.physics_grid_inputs(consts, state, True)
    for a, b in zip(args[:6], args1[:6]):
        assert (a is None and b is None) or torch.equal(a, b)
        assert a is None or a.is_contiguous()
    assert (args[4] is None) == grid_phi


# ---------------------------------------------------------------------------
# (e) What the grouped CUDA wrappers refuse, before anything is built
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a refused call must not build or load a kernel")
    monkeypatch.setattr(ck, "build_kernels", refuse)
    monkeypatch.setattr(TK, "_load", refuse)
    before = dict(ck.launch_counts), dict(TK.field_counts)
    yield
    assert (dict(ck.launch_counts), dict(TK.field_counts)) == before


def _refusals():
    _, tsp = transforms("f64")
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    g, p = z(2, il, ix), z(2, 2, mx, nx)
    d, i = TK.fused_grid2spec_many_cuda, TK.fused_spec2grid_many_cuda
    return {
        "direct_cpu": (d, ([g, g],), ValueError, "CUDA"),
        "inverse_cpu": (i, ([p, p], [1, 2]), ValueError, "CUDA"),
        "direct_shapes": (d, ([g, z(2, il, ix - 2)],), ValueError, "must be"),
        "inverse_shapes": (i, ([p, z(2, 2, mx, nx - 1)],), ValueError,
                           "must be"),
        "direct_count": (d, ([g] * (TK.MAX_SEGMENTS + 1),), ValueError,
                         "at most"),
        "inverse_count": (i, ([p] * (TK.MAX_SEGMENTS + 1),), ValueError,
                          "at most"),
        "direct_layout": (d, ([g, z(2, ix, il).transpose(-1, -2)],),
                          ValueError, "dense"),
        "inverse_layout": (i, ([z(2, 2, 4, 3, mx, nx).transpose(2, 3)], 1, 1),
                           ValueError, "copies nothing"),
        "direct_type": (d, ([g, g.float()],), TypeError, "grid is"),
        "inverse_kcos": (i, ([p, p], [1]), ValueError, "kcos"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_grouped_cuda_wrappers_refuse_without_building(case, no_build):
    _, tsp = transforms("f64")
    fn, args, exc, match = _refusals()[case]
    with pytest.raises(exc, match=match):
        fn(tsp, *args)


def test_grouped_cuda_wrappers_refuse_other_truncations(no_build):
    """The kernels are built for T30 (the one truncation the dense route
    serves); tables of another shape are refused."""
    _, tsp = transforms("f64")
    small = tsp._replace(cosgr=tsp.cosgr[:46])
    with pytest.raises(ValueError, match="T30"):
        TK.fused_spec2grid_many_cuda(small, [torch.zeros(2, 31, 32)])


def test_other_truncations_take_the_einsum_route(monkeypatch):
    """The kernels serve T30 alone, so every other truncation takes the
    einsum route, one that passes the JAX package's dense size gate included
    (T39 on a 120 x 60 grid: 3.94e6 entries per dense operator). Its
    transforms match the JAX package's dense route (1e-13 of the largest
    value, float64), and the model builds and steps on it without reaching
    the kernels' entry points."""
    shape = dict(trunc=39, ix=120, iy=30)
    jp = dataclasses.replace(J_T30L8, **shape)
    tp = dataclasses.replace(T_T30L8, fft_mode="matmul", **shape)
    assert tp.il * tp.mx * tp.mx * tp.nx <= 4_000_000
    jsp = JS.build_spectral(jp, jgeom.build_geometry(jp), use_matmul_fft=True)
    tsp = TS.build_spectral(tp, tgeom.build_geometry(tp), use_matmul_fft=True,
                            device="cpu")
    assert jsp.use_dense_legendre and not tsp.use_dense_legendre
    for name in ("fused_grid2spec_many", "fused_spec2grid_many"):
        monkeypatch.setattr(TK, name, lambda *a, _n=name: pytest.fail(_n))
    rng = np.random.default_rng(13)
    grid = rng.standard_normal((3, tp.il, tp.ix))
    want = np.asarray(JS.grid2spec_p(jsp, jnp.asarray(grid)))
    got = TS.grid2spec_p(tsp, torch.from_numpy(grid))
    assert rel_err(got, want) <= 1e-13
    for kcos in (1, 2):
        assert rel_err(TS.spec2grid_p(tsp, torch.from_numpy(want.copy()),
                                      kcos),
                       JS.spec2grid_p(jsp, jnp.asarray(want), kcos)) <= 1e-13
    consts, state1, cal = make_demo_model(tp, device="cpu", physics_on=False)
    assert not consts.sp.use_dense_legendre
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 2)
    out = TE.make_run_steps_batched(consts, device="cpu")(
        broadcast_state(state1, 2), ctx)
    for vor in out["vor"]:                              # both time levels
        assert vor.shape == (2, 2, tp.kx, tp.mx, tp.nx)
        assert bool(torch.isfinite(vor).all())


# ---------------------------------------------------------------------------
# (f) On the card
# ---------------------------------------------------------------------------

def _card_tables(prec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    tp = dataclasses.replace(T_T30L8, precision=prec, fft_mode="matmul")
    return TS.build_spectral(tp, tgeom.build_geometry(tp),
                             use_matmul_fft=True, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_kernels_match_their_plain_versions_on_the_card(prec):
    """Needs an NVIDIA GPU and nvcc: both kernels against the plain chain
    at 1e-12 (f64) / 1e-5 (f32) of the largest value, in strided layouts,
    and the 2-byte mode at 2^-8."""
    tsp = _card_tables(prec)
    grids, pairs = _strided_fields(tsp, tsp.rdtype, 11)
    grids = [g.cuda() for g in grids]
    pairs = [p.cuda() for p in pairs]
    limit = 1e-12 if prec == "f64" else 1e-5
    for g in grids:
        got, want = TK.fused_grid2spec_cuda(tsp, g, 1), TK.grid2spec_plain(
            tsp, g, 1)
        assert float((got - want).abs().max() / want.abs().max()) <= limit
    for p in pairs:
        for kcos in (1, 2):
            got = TK.fused_spec2grid_cuda(tsp, p, kcos, 1)
            want = TK.spec2grid_plain(tsp, p, kcos, 1)
            assert float((got - want).abs().max() / want.abs().max()) \
                <= limit
    g = grids[0].to(torch.bfloat16)
    got, want = TK.fused_grid2spec_cuda(tsp, g, 1), TK.grid2spec_plain(
        tsp, g, 1)
    assert got.dtype == tsp.rdtype
    assert float((got - want).abs().max() / want.abs().max()) <= 2.0 ** -8


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_a_group_equals_its_fields_launched_one_by_one_on_the_card(prec):
    """Needs an NVIDIA GPU and nvcc: one launch per group, and its outputs
    bitwise those of the fields launched alone."""
    tsp = _card_tables(prec)
    grids, pairs = _strided_fields(tsp, tsp.rdtype, 12)
    grids = [g.cuda() for g in grids]
    pairs = [p.cuda() for p in pairs]
    kcos = [2, 1, 2, 1]
    before = ck.launch_counts["fused_grid2spec"], ck.launch_counts[
        "fused_spec2grid"]
    many_d = TK.fused_grid2spec_many(tsp, grids, 1)
    many_i = TK.fused_spec2grid_many(tsp, pairs, kcos, 1)
    assert (ck.launch_counts["fused_grid2spec"],
            ck.launch_counts["fused_spec2grid"]) == (before[0] + 1,
                                                     before[1] + 1)
    for g, got in zip(grids, many_d):
        assert torch.equal(got, TK.fused_grid2spec_cuda(tsp, g, 1))
    for p, k, got in zip(pairs, kcos, many_i):
        assert torch.equal(got, TK.fused_spec2grid_cuda(tsp, p, k, 1))
