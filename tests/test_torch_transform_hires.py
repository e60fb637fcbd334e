"""Rows 3-4 at T47 and T63: the fused spectral transforms of
pyspeedy_tpu_torch/csrc/fused_transform_hires.cu and their routes.

At these shapes the folded Legendre table does not fit in one block, so a
group takes two kernels a direction: the DFT over blocks of 12 latitude
pairs, then the Legendre sums over slices of the (m, n) triangle (direct,
an equal share of the entries a slice) or of the wavenumbers m (inverse,
balanced by triangle entries), with the Fourier intermediate in a scratch.
Here, on the CPU:

* the table facts those kernels rely on, at T47 and T63;
* a numpy model of the kernels' decomposition (the latitude-pair blocks,
  the slices, the even and odd partial sums) against the JAX package's
  ``grid2spec_p`` / ``spec2grid_p``, float64, 1e-12 of the largest value;
* the route as a function of shape and device: the kernels at T30, T47 and
  T63 with the matmul DFT on a CUDA tensor, the einsum chain for a CPU
  tensor there (bitwise the einsum route's result), the einsum route at
  every other shape;
* what the T47/T63 wrappers refuse, before anything is built.

The gpu-marked tests run on the card only: the kernels against the einsum
chain, a group against its fields launched one by one, and a T47 member
alone bitwise the same member of a batch of 8 over a few steps. The module
imports no JAX at module level (the JAX tables are built inside the tests
that compare with them), so ``-m gpu`` runs it on a card without JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import geometry as tgeom
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.ops import transform_kernels as TK
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.parallel.ensemble import broadcast_state
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8
from pyspeedy_tpu_torch.params import T47L8 as T_T47L8
from pyspeedy_tpu_torch.params import T63L8 as T_T63L8
from pyspeedy_tpu_torch.testing import make_demo_model

torch.set_num_threads(1)

PRESETS = {"T47": T_T47L8, "T63": T_T63L8}
# The kernels' tiles (csrc/fused_transform_hires.cu): latitude pairs of a
# DFT item, threads of a direct Legendre slice, slices of the inverse one.
PAIRS = 12
LEG_DIR_THREADS = 256
LEG_INV_SLICES = 8
_cache = {}


def transforms(preset, prec="f64"):
    """The port's tables with the matmul DFT on the CPU, built once."""
    key = (preset, prec)
    if key not in _cache:
        tp = dataclasses.replace(PRESETS[preset], precision=prec,
                                 fft_mode="matmul")
        _cache[key] = TS.build_spectral(tp, tgeom.build_geometry(tp),
                                        use_matmul_fft=True, device="cpu")
    return _cache[key]


def jax_transforms(preset):
    """(the JAX package's spectral module, its float64 tables with the
    matmul DFT), built once."""
    from pyspeedy_tpu import params as jparams
    from pyspeedy_tpu.ops import geometry as jgeom
    from pyspeedy_tpu.ops import spectral as JS
    if ("jax", preset) not in _cache:
        jp = getattr(jparams, preset + "L8")
        _cache["jax", preset] = JS.build_spectral(
            jp, jgeom.build_geometry(jp), use_matmul_fft=True)
    return JS, _cache["jax", preset]


def rel_err(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def triangle_pairs(mx, nx):
    """(m, n) of the triangle m + n <= nx - 1, m-major (the tables' rows)."""
    return np.array([(m, n) for m in range(mx) for n in range(nx - m)]).T


def tri_offset(m, nx):
    return nx * m - m * (m - 1) // 2


def random_pair(rng, lead, mx, nx):
    tri = np.arange(mx)[:, None] + np.arange(nx)[None, :] <= nx - 1
    return rng.standard_normal(lead + (2, mx, nx)) * tri


# ---------------------------------------------------------------------------
# (a) The table facts the kernels rely on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("name", ["cpol_dir_full", "cpol_inv_full"])
def test_legendre_tables_have_bitwise_parity_and_a_zero_triangle(
        name, preset, prec):
    """L[il-1-j, m, n] == (-1)**n L[j, m, n] exactly, and L == 0 exactly
    wherever m + n > nx - 1: the kernels keep the il/2 northern latitudes
    and the triangle's 1,224 (T47) or 2,144 (T63) pairs only, in that
    order (fold_dir after the DFT table, fold_inv before it)."""
    tsp = transforms(preset, prec)
    L = getattr(tsp, name).numpy()
    il, mx, nx = L.shape
    assert np.array_equal(L[::-1], ((-1.0) ** np.arange(nx) * L).astype(
        L.dtype))
    tm, tn = triangle_pairs(mx, nx)
    outside = np.ones((mx, nx), bool)
    outside[tm, tn] = False
    assert np.all(L[:, outside] == 0.0)
    assert tm.size == {"T47": 1224, "T63": 2144}[preset]
    assert tm.size == int((np.abs(L).max(axis=0) > 0).sum())
    ntri = (il // 2) * tm.size
    table = tsp.fold_dir if name == "cpol_dir_full" else tsp.fold_inv
    legendre = table[-ntri:] if name == "cpol_dir_full" else table[:ntri]
    assert torch.equal(legendre.reshape(il // 2, -1),
                       getattr(tsp, name)[:il // 2, tm, tn])
    assert table.numel() == ntri + tsp.ix * tsp.mx       # (2, ix/2, mx)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_dft_tables_have_half_period_symmetry_to_rounding(preset, prec):
    """D[c, i + ix/2, m] = (-1)**m D[c, i, m] (forward) and the same along
    i (inverse), to rounding only: measured 3.4e-16 / 9.7e-14 (T47) and
    3.2e-16 / 1.2e-13 (T63) absolute in float64, 2.8e-16 / 8.1e-14 and
    2.8e-16 / 1.1e-13 in float32. Both DFT stages read the first half of
    each table; dft_inv_ri[1, 0] is exactly 0 (the m = 0 discard rule)."""
    tsp = transforms(preset, prec)
    ih = tsp.ix // 2
    sign = (-1.0) ** np.arange(tsp.mx)
    fwd = tsp.dft_fwd_ri.double().numpy()
    inv = tsp.dft_inv_ri.double().numpy()
    assert np.abs(fwd[:, ih:] - sign * fwd[:, :ih]).max() <= 1e-15
    assert np.abs(inv[:, :, ih:] - sign[:, None] * inv[:, :, :ih]).max() \
        <= 1e-12
    assert float(tsp.dft_inv_ri[1, 0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (b) A numpy model of the kernels' decomposition against the JAX functions
# ---------------------------------------------------------------------------

def unpack(tsp, direct):
    """The folded tables as the kernels read them: DFT (2 parity, ih, 2h)
    or (2 parity, 2h, ih), Legendre (il/2, triangle)."""
    ih, iy = tsp.ix // 2, tsp.il // 2
    ntri = iy * triangle_pairs(tsp.mx, tsp.nx).shape[1]
    t = (tsp.fold_dir if direct else tsp.fold_inv).numpy()
    if direct:
        return t[:-ntri].reshape(2, ih, -1), t[-ntri:].reshape(iy, -1)
    return t[ntri:].reshape(2, -1, ih), t[:ntri].reshape(iy, -1)


def model_direct(tsp, grid):
    """hires_dft_fwd_kernel then hires_leg_dir_kernel on a (rows, il, ix)
    grid -> (rows, 2, mx, nx). Stage 1, per block of PAIRS latitude pairs:
    the south rows p and north rows il-1-p folded by half a period, the DFT
    of each parity, the hemispheric sums (sd 0) and differences (sd 1) into
    X[row, m, c, sd, pair]. Stage 2, per slice of an equal share of the
    triangle's entries: for entry (m, n), the sum over the pairs of
    L[j, entry] X[row, m, c, n % 2, j]; zeros past the triangle."""
    D, L = unpack(tsp, True)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    ih, iy, h = ix // 2, il // 2, (mx + 1) // 2
    rows = grid.shape[0]
    X = np.zeros((rows, mx, 2, 2, iy))
    for pb in range(iy // PAIRS):
        p = np.arange(pb * PAIRS, (pb + 1) * PAIRS)
        lat = np.concatenate([p, il - 1 - p])              # the item's slots
        g = grid[:, lat]
        folded = (g[..., :ih] + g[..., ih:], g[..., :ih] - g[..., ih:])
        for par in range(2):
            F = folded[par] @ D[par]                       # (rows, slots, 2h)
            for col in range(2 * h):
                c, m = col // h, 2 * (col % h) + par
                south, north = F[:, :PAIRS, col], F[:, PAIRS:, col]
                X[:, m, c, 0, p] = south + north
                X[:, m, c, 1, p] = south - north
    tm, tn = triangle_pairs(mx, nx)
    S = np.zeros((rows, 2, mx, nx))
    ns = -(-tm.size // LEG_DIR_THREADS)
    for sl in range(ns):
        e = np.arange(sl * tm.size // ns, (sl + 1) * tm.size // ns)
        m, n = tm[e], tn[e]
        xs = X[:, m, :, n % 2, :]                          # (e, rows, c, j)
        S[:, :, m, n] = np.einsum("je,ercj->rce", L[:, e], xs)
    return S


def model_inverse(tsp, p, kcos):
    """hires_leg_inv_kernel then hires_dft_inv_kernel on a (rows, 2, mx,
    nx) pair -> (rows, il, ix). Stage 1, per slice of m (the first row
    starting at or past an equal share of the triangle's entries): the even
    and odd partial sums E, O over n of L[j, m, n] p[c, m, n]; F south =
    E + O, north = E - O, the imaginary part of m = 0 set to 0. Stage 2, per
    block of PAIRS latitude pairs: the DFT of the even and odd wavenumbers
    over half the longitudes, g[i] = Pe + Po, g[i + ix/2] = Pe - Po, then
    1/cos(lat) unless kcos == 1."""
    B, L = unpack(tsp, False)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    ih, iy, h = ix // 2, il // 2, (mx + 1) // 2
    tri = triangle_pairs(mx, nx).shape[1]
    rows = p.shape[0]
    F = np.zeros((rows, 2, il, mx))

    def m0(sl):
        e, m = sl * tri // LEG_INV_SLICES, 0
        while m < mx and tri_offset(m, nx) < e:
            m += 1
        return m

    for sl in range(LEG_INV_SLICES):
        for m in range(m0(sl), m0(sl + 1)):
            lm = L[:, tri_offset(m, nx):tri_offset(m, nx) + nx - m]
            pm = p[:, :, m, :nx - m]
            E = np.einsum("jn,rcn->rcj", lm[:, 0::2], pm[..., 0::2])
            O = np.einsum("jn,rcn->rcj", lm[:, 1::2], pm[..., 1::2])
            F[:, :, :iy, m] = E + O
            F[:, :, ::-1][:, :, :iy, m] = E - O
    F[:, 1, :, 0] = 0.0
    g = np.zeros((rows, il, ix))
    for pb in range(iy // PAIRS):
        q = np.arange(pb * PAIRS, (pb + 1) * PAIRS)
        lat = np.concatenate([q, il - 1 - q])
        Pe = sum(F[:, c][:, lat][..., 0::2] @ B[0, c * h:(c + 1) * h]
                 for c in range(2))
        Po = sum(F[:, c][:, lat][..., 1::2] @ B[1, c * h:(c + 1) * h]
                 for c in range(2))
        g[:, lat] = np.concatenate([Pe + Po, Pe - Po], axis=-1)
    if kcos != 1:
        g = g * tsp.cosgr.numpy()[:, None]
    return g


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_model_of_the_direct_kernels_matches_jax(preset):
    JS, jsp = jax_transforms(preset)
    tsp = transforms(preset)
    rng = np.random.default_rng(1300 + tsp.il)
    grid = rng.standard_normal((3, tsp.il, tsp.ix))
    want = JS.grid2spec_p(jsp, grid)                       # (2, 3, mx, nx)
    assert rel_err(model_direct(tsp, grid), np.moveaxis(want, 0, 1)) \
        <= 1e-12


@pytest.mark.parametrize("kcos", [1, 2])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_model_of_the_inverse_kernels_matches_jax(preset, kcos):
    JS, jsp = jax_transforms(preset)
    tsp = transforms(preset)
    rng = np.random.default_rng(1310 + tsp.il + kcos)
    spec = random_pair(rng, (3,), tsp.mx, tsp.nx)
    want = JS.spec2grid_p(jsp, np.moveaxis(spec, 1, 0), kcos)
    assert rel_err(model_inverse(tsp, spec, kcos), want) <= 1e-12
    dirty = spec.copy()
    dirty[:, 1, 0, :] = 1e3 * rng.standard_normal((3, tsp.nx))
    spec[:, 1, 0, :] = 0.0
    assert np.array_equal(model_inverse(tsp, dirty, kcos),
                          model_inverse(tsp, spec, kcos))


# ---------------------------------------------------------------------------
# (c) The route as a function of shape and device
# ---------------------------------------------------------------------------

def _tables(base, use_matmul, **shape):
    tp = dataclasses.replace(base, fft_mode="matmul" if use_matmul else "fft",
                             **shape)
    return TS.build_spectral(tp, tgeom.build_geometry(tp),
                             use_matmul_fft=use_matmul, device="cpu")


@pytest.mark.parametrize("case", ["T30", "T47", "T63", "T39", "T47 fft"])
def test_route_flags_by_shape(case):
    """The kernels serve T30, T47 and T63 with the matmul DFT; the dense
    tables and the 2-byte mode stay at T30; T39 on a 120 x 60 grid and the
    fft route take neither."""
    base, matmul, shape = {
        "T30": (T_T30L8, True, {}), "T47": (T_T47L8, True, {}),
        "T63": (T_T63L8, True, {}),
        "T39": (T_T30L8, True, dict(trunc=39, ix=120, iy=30)),
        "T47 fft": (T_T47L8, False, {})}[case]
    sp = _tables(base, matmul, **shape)
    assert sp.use_fused_kernels == (case in ("T30", "T47", "T63"))
    assert sp.use_dense_legendre == (case == "T30")
    assert ((sp.il, sp.ix, sp.mx, sp.nx) in TK.KERNEL_SHAPES) == (
        case != "T39")
    assert (sp.fold_dir.numel() > 1) == sp.use_fused_kernels
    assert (sp.leg_dir_dense.numel() > 1) == sp.use_dense_legendre


def _old_einsum_route(sp, grid, p, kcos):
    """The einsum route as ops/spectral.py computed T47/T63 before the
    kernels: two einsums a direction."""
    F2 = torch.einsum("...ji,cim->c...jm", grid, sp.dft_fwd_ri)
    S2 = torch.einsum("jmn,c...jm->c...mn", sp.cpol_dir_full, F2)
    G2 = torch.einsum("jmn,c...mn->c...jm", sp.cpol_inv_full, p.movedim(1, 0))
    g = torch.einsum("c...jm,cmi->...ji", G2, sp.dft_inv_ri)
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return S2.movedim(0, 1), g


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_cpu_tensors_take_the_einsum_chain_bitwise(preset, prec):
    """On the CPU, T47/T63 go through ops.transform_kernels to the einsum
    chain (counted as the kernels' plain version, no dense chain), and the
    result is bitwise that of the einsum route as it was computed before,
    grouped or one field at a time."""
    tsp = transforms(preset, prec)
    rng = np.random.default_rng(1320)
    grid = torch.from_numpy(rng.standard_normal((2, 3, tsp.il, tsp.ix))).to(
        tsp.rdtype)
    p = torch.from_numpy(random_pair(rng, (2,), tsp.mx, tsp.nx)[:, :, None]
                         .repeat(3, axis=2)).to(tsp.rdtype)
    TK.reset_einsum_chain_calls()
    TK.reset_plain_chain_calls()
    for kcos in (1, 2):
        want_d, want_i = _old_einsum_route(tsp, grid, p, kcos)
        got_d = TS.grid2spec_many_p(tsp, [grid, grid[:, 1]], 1)
        got_i = TS.spec2grid_many_p(tsp, [p, p[:, :, 2]], kcos, 1)
        assert torch.equal(got_d[0], want_d)
        assert torch.equal(got_d[1], want_d[:, :, 1])
        assert torch.equal(got_i[0], want_i)
        assert torch.equal(got_i[1], want_i[:, 2])
        assert torch.equal(TS.grid2spec_p(tsp, grid, 1), want_d)
        assert torch.equal(TS.spec2grid_p(tsp, p, kcos, 1), want_i)
    assert TK.einsum_chain_calls == {"grid2spec": 6, "spec2grid": 6}
    assert TK.plain_chain_calls == {"grid2spec": 0, "spec2grid": 0}


@pytest.mark.parametrize("preset", ["T30", "T47", "T63", "T39"])
def test_cuda_tensors_go_to_the_kernels_at_their_shapes(preset, monkeypatch):
    """A tensor off the CPU reaches the CUDA wrappers at T30, T47 and T63
    (one call a group) and never at another shape; the einsum route there
    counts no plain call."""
    base, shape = {"T30": (T_T30L8, {}), "T47": (T_T47L8, {}),
                   "T63": (T_T63L8, {}),
                   "T39": (T_T30L8, dict(trunc=39, ix=120, iy=30))}[preset]
    sp = _tables(base, True, **shape)
    calls = []
    monkeypatch.setattr(TK, "_on_cpu", lambda fields: False)
    monkeypatch.setattr(TK, "fused_grid2spec_many_cuda",
                        lambda sp, grids, pdim=0: calls.append(
                            ("direct", len(grids))) or list(grids))
    monkeypatch.setattr(TK, "fused_spec2grid_many_cuda",
                        lambda sp, pairs, kcos=1, pdim=0: calls.append(
                            ("inverse", len(pairs))) or list(pairs))
    TK.reset_einsum_chain_calls()
    grid = torch.zeros(2, sp.il, sp.ix, dtype=sp.rdtype)
    pair = torch.zeros(2, 2, sp.mx, sp.nx, dtype=sp.rdtype)
    TS.grid2spec_many_p(sp, [grid] * 3, 1)
    TS.spec2grid_many_p(sp, [pair] * 2, [1, 2], 1)
    if preset == "T39":
        assert calls == []
    else:
        assert calls == [("direct", 3), ("inverse", 2)]
    assert TK.einsum_chain_calls == {"grid2spec": 0, "spec2grid": 0}


# ---------------------------------------------------------------------------
# (d) What the T47/T63 wrappers refuse, before anything is built
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


def _refusals(preset):
    tsp = transforms(preset)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    z = lambda *s, dtype=torch.float64: torch.zeros(*s, dtype=dtype)
    g, p = z(2, il, ix), z(2, 2, mx, nx)
    d, i = TK.fused_grid2spec_many_cuda, TK.fused_spec2grid_many_cuda
    cut = tsp._replace(cosgr=tsp.cosgr[:il - 2])
    return {
        "direct_shape_of_tables": (d, (cut, [g]), ValueError, "T30, T47"),
        "inverse_shape_of_tables": (i, (cut, [p]), ValueError, "T30, T47"),
        "direct_bf16": (d, (tsp, [g, z(2, il, ix, dtype=torch.bfloat16)]),
                        TypeError, "bfloat16"),
        "direct_f32_grid": (d, (tsp, [g.float()]), TypeError, "grid is"),
        "inverse_f32_pair": (i, (tsp, [p.float()]), TypeError, "pair is"),
        "direct_cpu": (d, (tsp, [g, g]), ValueError, "CUDA"),
        "inverse_cpu": (i, (tsp, [p, p], [1, 2]), ValueError, "CUDA"),
        "direct_shapes": (d, (tsp, [g, z(2, il, ix - 2)]), ValueError,
                          "must be"),
        "inverse_shapes": (i, (tsp, [p, z(2, 2, mx, nx - 1)]), ValueError,
                           "must be"),
        "direct_count": (d, (tsp, [g] * (TK.MAX_SEGMENTS + 1)), ValueError,
                         "at most"),
        "direct_layout": (d, (tsp, [z(2, ix, il).transpose(-1, -2)]),
                          ValueError, "dense"),
        "inverse_layout": (i, (tsp, [z(2, 2, 4, 3, mx, nx).transpose(2, 3)],
                               1, 1), ValueError, "copies nothing"),
        "off_the_kernel_route": (
            d, (tsp._replace(use_fused_kernels=False), [g]), ValueError,
            "kernel route"),
    }


@pytest.mark.parametrize("case", sorted(_refusals("T47")))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_hires_wrappers_refuse_without_building(preset, case, no_build):
    fn, args, exc, match = _refusals(preset)[case]
    with pytest.raises(exc, match=match):
        fn(*args)


def test_the_probes_and_the_2_byte_mode_stay_at_t30(no_build):
    """The T47/T63 tables serve the transforms only: the probes refuse
    them, and a bfloat16 grid is refused there too."""
    tsp = transforms("T63", "f32")
    grid = torch.zeros(2, tsp.il, tsp.ix)
    with pytest.raises(ValueError, match="T30"):
        TK.fused_probe_cuda(tsp, 0, grid)
    with pytest.raises(TypeError, match="bfloat16"):
        TK.fused_grid2spec_cuda(tsp, grid.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# (e) On the card
# ---------------------------------------------------------------------------

def _card_tables(preset, prec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    tp = dataclasses.replace(PRESETS[preset], precision=prec,
                             fft_mode="matmul")
    return TS.build_spectral(tp, tgeom.build_geometry(tp),
                             use_matmul_fft=True, device="cuda")


def _card_fields(sp, seed):
    """Grids and pairs on the card in the layouts the step hands over."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(
        "cuda", sp.rdtype)
    tri = torch.from_numpy((np.arange(sp.mx)[:, None]
                            + np.arange(sp.nx)[None] <= sp.nx - 1).astype(
        np.float64)).to("cuda", sp.rdtype)
    grids = [t(3, 4, sp.il, sp.ix), t(3, 6, sp.il, sp.ix)[:, 2:5],
             t(3, sp.il, sp.ix)]
    pairs = [t(3, 2, 4, sp.mx, sp.nx) * tri,
             (t(3, 2, 2, 3, sp.mx, sp.nx) * tri)[:, :, 1],
             (t(1, 2, 2, sp.mx, sp.nx) * tri).expand(3, 2, 2, sp.mx, sp.nx)]
    return grids, pairs


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_kernels_match_the_einsum_chain_on_the_card(preset, prec):
    """Needs an NVIDIA GPU and nvcc: 1e-12 (f64) / 1e-5 (f32) of the
    largest value, in strided layouts, kcos 1 and 2."""
    sp = _card_tables(preset, prec)
    grids, pairs = _card_fields(sp, 1330)
    limit = 1e-12 if prec == "f64" else 1e-5
    for g in grids:
        got = TK.fused_grid2spec_cuda(sp, g, 1)
        want = TK.grid2spec_hires_plain(sp, g, 1)
        assert float((got - want).abs().max() / want.abs().max()) <= limit
    for p in pairs:
        for kcos in (1, 2):
            got = TK.fused_spec2grid_cuda(sp, p, kcos, 1)
            want = TK.spec2grid_hires_plain(sp, p, kcos, 1)
            assert float((got - want).abs().max() / want.abs().max()) \
                <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_a_group_equals_its_fields_one_by_one_on_the_card(preset, prec):
    """Needs an NVIDIA GPU and nvcc: one launch a group, its outputs
    bitwise those of the fields launched alone."""
    sp = _card_tables(preset, prec)
    grids, pairs = _card_fields(sp, 1331)
    kcos = [2, 1, 2]
    before = (ck.launch_counts["fused_grid2spec_hires"],
              ck.launch_counts["fused_spec2grid_hires"])
    many_d = TK.fused_grid2spec_many(sp, grids, 1)
    many_i = TK.fused_spec2grid_many(sp, pairs, kcos, 1)
    assert (ck.launch_counts["fused_grid2spec_hires"],
            ck.launch_counts["fused_spec2grid_hires"]) == (before[0] + 1,
                                                           before[1] + 1)
    for g, got in zip(grids, many_d):
        assert torch.equal(got, TK.fused_grid2spec_cuda(sp, g, 1))
    for p, k, got in zip(pairs, kcos, many_i):
        assert torch.equal(got, TK.fused_spec2grid_cuda(sp, p, k, 1))


@pytest.mark.gpu
def test_a_t47_member_alone_is_bitwise_that_member_of_a_batch():
    """Needs an NVIDIA GPU and nvcc: member 5 of 8 distinct members, run
    alone, equals that member of the batch bitwise after 6 steps of the
    full-physics T47 model through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    p = dataclasses.replace(T_T47L8, precision="f32", fft_mode="matmul")
    consts, state1, cal = make_demo_model(p, device="cuda")
    assert consts.sp.use_fused_kernels
    run = TE.make_run_steps_batched(consts, device="cuda")
    batch = broadcast_state(state1, 8)
    rng = np.random.default_rng(1332)
    tri = np.arange(p.mx)[:, None] + np.arange(p.nx)[None, :] <= p.trunc
    noise = 0.01 * rng.standard_normal(tuple(batch["t"][0].shape)) * tri
    noise[:, 1, :, 0, :] = 0.0
    noise = torch.from_numpy(noise).to("cuda", p.dtype)
    batch["t"] = (batch["t"][0] + noise, batch["t"][1] + noise)
    one = {k: ((tuple(a[5:6] for a in v) if isinstance(v, tuple)
                else v[5:6]) if k in TM.CARRY_FIELDS else v)
           for k, v in batch.items()}
    ctx = lambda: TM.build_step_ctx(dataclasses.replace(cal), 2, 6)[0]
    out8 = run(batch, ctx())
    out1 = run(one, ctx())
    for name in ("vor", "div", "t", "ps", "tr"):
        for a, b in zip(out8[name], out1[name]):
            assert torch.equal(a[5:6], b), name
    assert float((out8["t"][0] - out8["t"][0][:1]).abs().max()) > 1e-6
