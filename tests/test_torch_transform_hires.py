"""Rows 3-4 at T47 and T63: the fused spectral transforms of
pyspeedy_tpu_torch/csrc/fused_transform_hires.cu and their routes.

At these shapes the folded Legendre table does not fit in one block, so a
group takes one kernel a direction on thread-block clusters: each block of
a cluster owns a band of latitude pairs for the zonal DFT (on the tensor
cores) and a slice of the wavenumbers m for the Legendre sums, and the
Fourier intermediate goes from block to block through the cluster's shared
memory (``ops.transform_kernels.hires_cluster_plan`` gives the
decomposition; the library reports its own plan, and the card's tests hold
the two against each other). Here, on the CPU:

* the table facts those kernels rely on, at T47 and T63;
* the plan: the bands cover every latitude once, the slices every (m, n)
  entry once with equal work a block, and each block's working set fits in
  its shared memory;
* a numpy model of the cluster decomposition (the bands, the slices, the
  Fourier values sent from band to slice and back, the DFT's k loop in the
  tensor-core products' order, the inverse's Legendre items and even and
  odd partial sums) with the plan of each element type, against the JAX
  package's ``grid2spec_p`` / ``spec2grid_p``, float64, 1e-12 of the largest
  value, and the inverse also in float32 with its 3xTF32 products emulated,
  1e-5;
* the route as a function of shape and device: the kernels at T30, T47 and
  T63 with the matmul DFT on a CUDA tensor, the einsum chain for a CPU
  tensor there (bitwise the einsum route's result), the einsum route at
  every other shape;
* what the T47/T63 wrappers refuse, before anything is built.

The gpu-marked tests run on the card only: the library's plan against the
modelled decomposition, the kernels against the einsum chain, a group
against its fields launched one by one, and a member alone
bitwise the same member of a batch of 8 over a few steps, at T47 and T63. The module
imports no JAX at module level (the JAX tables are built inside the tests
that compare with them), so ``-m gpu`` runs it on a card without JAX.
"""

import dataclasses
import hashlib

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
DTYPES = {"f32": torch.float32, "f64": torch.float64}
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
# (b) The cluster plan and a numpy model of it against the JAX functions
# ---------------------------------------------------------------------------

def plan_of(preset, plan_prec):
    tsp = transforms(preset)
    return TK.hires_cluster_plan((tsp.il, tsp.ix, tsp.mx, tsp.nx),
                                 DTYPES[plan_prec])


@pytest.mark.parametrize("plan_prec", sorted(DTYPES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_the_plan_covers_every_latitude_and_entry_once(preset, plan_prec):
    """The bands hold every latitude once (pair p: p and il-1-p), the slices
    every (m, n) entry of the triangle once, every block the same number of
    entries; the MMA columns hold a step's rows, pairs and hemispheres in
    tiles of 8; a cluster is portable (at most 8 blocks)."""
    tsp = transforms(preset)
    il, mx, nx = tsp.il, tsp.mx, tsp.nx
    plan = plan_of(preset, plan_prec)
    c = plan["cluster"]
    assert c <= 8 and len(plan["bands"]) == len(plan["m_slices"]) == c
    lats = [q for b0, b1 in plan["bands"] for p in range(b0, b1)
            for q in (p, il - 1 - p)]
    assert sorted(lats) == list(range(il))
    assert all(b1 - b0 == plan["pairs_per_band"] for b0, b1 in plan["bands"])
    entries = [(m, n) for ms in plan["m_slices"] for m in ms
               for n in range(nx - m)]
    assert sorted(entries) == sorted(zip(*triangle_pairs(mx, nx)))
    work = {sum(nx - m for m in ms) for ms in plan["m_slices"]}
    assert work == {len(entries) // c}
    cols = plan["rows_per_step"] * 2 * plan["pairs_per_band"]
    assert plan["band_columns"] % 8 == 0
    assert cols <= plan["band_columns"] < cols + 8


def legendre_work(ms, nx, threads):
    """The direct kernel's Legendre sums of a block whose m are `ms` (in
    slice order) on `threads` threads: thread t sums entries t, t +
    threads, ... of the slice (the K low m's rows, then their mirrors',
    each row's n ascending). [[(local m, n), ...] a thread]."""
    slice_entries = [(ml, n) for ml, m in enumerate(ms) for n in range(nx - m)]
    return [slice_entries[t::threads] for t in range(threads)]


@pytest.mark.parametrize("plan_prec", sorted(DTYPES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_the_direct_legendre_work_and_stores_cover_each_row_once(
        preset, plan_prec):
    """The direct kernel's Legendre threads take every entry of a block's
    slice once, none more than its share rounded up; its staged stores (for
    a row and part, a run of the K low m and one of their mirrors, nx values
    each, shifted by the destination's alignment modulo a 16-byte vector,
    read back a vector at a time) write each element of those rows once, the
    entry (m, n) where m + n < nx and a zero elsewhere, whatever the
    alignment; the staged runs of a step fit in the Fourier values it has
    read."""
    tsp = transforms(preset)
    iy, mx, nx = tsp.il // 2, tsp.mx, tsp.nx
    plan = plan_of(preset, plan_prec)
    threads = 32 * plan["direct_legendre_warps"]
    vw = 16 // DTYPES[plan_prec].itemsize
    k = len(plan["m_slices"][0]) // 2
    run = k * nx
    runp = (run + 2 * (vw - 1)) // vw * vw
    assert 4 * runp <= 2 * k * 4 * iy and runp % vw == 0
    for ms in plan["m_slices"]:
        work = legendre_work(ms, nx, threads)
        flat = [e for w in work for e in w]
        assert sorted((ms[ml], n) for ml, n in flat) == \
            sorted((m, n) for m in ms for n in range(nx - m))
        assert max(len(w) for w in work) == -(-len(flat) // threads)
        for shift in range(vw):
            stage = {}
            for ml, n in flat:
                pos = (ml // k) * runp + shift + (ml % k) * nx + n
                assert pos not in stage
                stage[pos] = (ms[ml], n)
            written = {}
            for q in range(2 * runp // vw):
                r, vq = divmod(q, runp // vw)
                for v in range(vw):
                    j = vq * vw - shift + v
                    if 0 <= j < run:
                        m, n = ms[r * k] + j // nx, j % nx
                        assert (r, j) not in written
                        written[r, j] = (0 if m + n >= nx else
                                         stage[r * runp + vq * vw + v])
                        assert written[r, j] in (0, (m, n))
                        assert (written[r, j] == 0) == (m + n >= nx)
            assert len(written) == 2 * run


@pytest.mark.parametrize("plan_prec", sorted(DTYPES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_each_block_of_the_plan_fits_in_shared_memory(preset, plan_prec):
    """Each block's working set under the plan fits in the 227 KiB a block
    may use: direct, its slice of the Legendre table, the Fourier values of
    a step's rows it receives (its m, c, sum and difference, il/2 pairs)
    and its band's grid rows of the step; inverse (its own rows a step), the
    table slice, its spectral values of two steps (c, its m, n) and its
    band's Fourier values of two steps (parity, column, MMA column). The
    kernels' own layout (pitches, staging) is the library's: the compiler
    holds it to the same limit, and the card's test of the library's plan
    reads it."""
    tsp = transforms(preset)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    plan = plan_of(preset, plan_prec)
    w = DTYPES[plan_prec].itemsize
    iy, cols, rows = il // 2, 2 * ((mx + 1) // 2), plan["rows_per_step"]
    npad = plan["band_columns"]
    irows = plan["inverse_rows_per_step"]
    inpad = -(-irows * 2 * plan["pairs_per_band"] // 8) * 8
    for ms in plan["m_slices"]:
        ent = sum(nx - m for m in ms)
        direct = w * (iy * ent + rows * len(ms) * 2 * 2 * iy + npad * ix)
        inverse = w * (ent * iy + 2 * irows * 2 * len(ms) * nx
                       + 2 * 2 * cols * inpad)
        assert max(direct, inverse) <= 227 * 1024


def unpack(tsp, direct):
    """The folded tables as the kernels read them: DFT (2 parity, ih, 2h)
    or (2 parity, 2h, ih), Legendre (il/2, triangle)."""
    ih, iy = tsp.ix // 2, tsp.il // 2
    ntri = iy * triangle_pairs(tsp.mx, tsp.nx).shape[1]
    t = (tsp.fold_dir if direct else tsp.fold_inv).numpy()
    if direct:
        return t[:-ntri].reshape(2, ih, -1), t[-ntri:].reshape(iy, -1)
    return t[ntri:].reshape(2, -1, ih), t[:ntri].reshape(iy, -1)


def k_tiled(a, b, depth):
    """a (..., K) @ b (K, N) as the tensor-core products add it: one
    product of `depth` terms after the other, k ascending."""
    out = 0.0
    for k0 in range(0, a.shape[-1], depth):
        out = out + a[..., k0:k0 + depth] @ b[k0:k0 + depth]
    return out


def slots(plan, il, band):
    """The latitude of each MMA column (row of the step, pair, hemisphere)
    of a band, and that column's (row, pair)."""
    b0, b1 = band
    out = []
    for rr in range(plan["rows_per_step"]):
        for p in range(b0, b1):
            out += [(rr, p, p), (rr, p, il - 1 - p)]
    return out


def model_direct(tsp, grid, plan):
    """The direct cluster kernel on a (rows, il, ix) grid -> (rows, 2, mx,
    nx). A cluster step takes rows_per_step rows. Each block's band: its
    grid rows in MMA columns, folded by half a period, the DFT of each
    parity as k-tiled products against the folded table, the hemispheric
    sums (sd 0) and differences (sd 1) of each pair sent to the block that
    owns the column's m. Each block's slice: for entry (m, n), the sum over
    all pairs of L[p, entry] X[row, m, c, n % 2, p]; zeros past the
    triangle."""
    D, L = unpack(tsp, True)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    ih, iy, h = ix // 2, il // 2, (mx + 1) // 2
    step = plan["rows_per_step"]
    rows = grid.shape[0]
    owner = {m: (r, ms.index(m)) for r, ms in enumerate(plan["m_slices"])
             for m in ms}
    # The receive buffers of every block: (rows, its m, c, sd, pair).
    xin = [np.full((rows + step, len(ms), 2, 2, iy), np.nan)
           for ms in plan["m_slices"]]
    g = np.concatenate([grid, np.zeros((step,) + grid.shape[1:])])
    for r0 in range(0, rows, step):
        for band in plan["bands"]:
            cols = slots(plan, il, band)
            gb = np.stack([g[r0 + rr, lat] for rr, _, lat in cols])
            folded = (gb[:, :ih] + gb[:, ih:], gb[:, :ih] - gb[:, ih:])
            for par in range(2):
                F = k_tiled(folded[par], D[par], plan["mma_k"])  # (cols, 2h)
                for col in range(2 * h):
                    c, m = col // h, 2 * (col % h) + par
                    r, ml = owner[m]
                    for q in range(0, len(cols), 2):
                        rr, p, _ = cols[q]
                        south, north = F[q, col], F[q + 1, col]
                        xin[r][r0 + rr, ml, c, :, p] = (south + north,
                                                        south - north)
    S = np.zeros((rows, 2, mx, nx))
    for r, ms in enumerate(plan["m_slices"]):
        for ml, m in enumerate(ms):
            for n in range(nx - m):
                x = xin[r][:rows, ml, :, n % 2, :]             # (rows, c, p)
                S[:, :, m, n] = x @ L[:, tri_offset(m, nx) + n]
    return S


def tf32_rna(x):
    """float32 values rounded to TF32, to nearest with ties away from zero
    (cvt.rna, and the integer form of split_tf32 in the source)."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def k_tiled_3xtf32(a, b, depth):
    """a (..., K) @ b (K, N) in float32 as the warp-specialised inverse's
    3xTF32 products add it: the table b split once, hi = rna(b), lo =
    rna(b - hi); each data value a split as split_tf32 does it, hi =
    rna(a), lo = a - hi truncated; one k tile of `depth` terms after the
    other, three products a tile (lo.hi, hi.lo, hi.hi; the lo.lo term
    dropped), each summed exactly and added into the float32 sum."""
    b32 = np.asarray(b, dtype=np.float32)
    bh = tf32_rna(b32)
    bl = tf32_rna(b32 - bh)
    a32 = np.asarray(a, dtype=np.float32)
    ah = tf32_rna(a32)
    al = tf32_trunc(a32 - ah)
    out = np.zeros(a32.shape[:-1] + (b32.shape[-1],), dtype=np.float32)
    f64 = lambda x: x.astype(np.float64)
    for k0 in range(0, a32.shape[-1], depth):
        ks = slice(k0, k0 + depth)
        for x, y in ((ah, bl), (al, bh), (ah, bh)):
            out = (f64(out) + f64(x[..., ks]) @ f64(y[ks])).astype(np.float32)
    return out


def model_inverse(tsp, p, kcos, plan):
    """The inverse kernel (hires_inverse_ws_kernel) on a (rows, 2, mx, nx)
    pair -> (rows, il, ix), in the tables' type. The plan's bands and
    slices; each block's Legendre stage as its items, one a thread: (m
    pair, inverse_pairs_per_item latitude pairs, n parity), the
    item's thread summing its parity's partial sums over n (ascending) for
    the pair's low m and then its mirror, both parts, every row of the step
    (each (m, pair, parity) taken by one item); F south = E + O, north =
    E - O (the imaginary part of m = 0 set to 0) into the band's MMA
    columns; each band's DFT as k-tiled products (float32: 3xTF32 as the
    kernel splits them; float64: the DMMA's k order); g[i] = Pe + Po,
    g[i + ix/2] = Pe - Po, then 1/cos(lat) unless kcos == 1."""
    B, L = unpack(tsp, False)
    f32 = tsp.rdtype == torch.float32
    dt = np.float32 if f32 else np.float64
    B, L, p = B.astype(dt), L.astype(dt), np.asarray(p, dtype=dt)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    ih, iy, h = ix // 2, il // 2, (mx + 1) // 2
    rows = p.shape[0]
    svw, k = plan["inverse_pairs_per_item"], len(plan["m_slices"][0]) // 2
    band_of = {q: b for b, (b0, b1) in enumerate(plan["bands"])
               for q in range(b0, b1)}
    fin = [np.full((rows, 2, 2 * h, 2 * (b1 - b0)), np.nan, dtype=dt)
           for b0, b1 in plan["bands"]]
    taken = np.zeros((mx, iy, 2), dtype=int)
    for ms in plan["m_slices"]:
        # items (jl, pg, parity): the parities of one (jl, pg) are partner
        # lanes and swap their sums
        for jl in range(k):
            for pg in range(iy // svw):
                qs = np.arange(pg * svw, (pg + 1) * svw)
                for m in (ms[jl], ms[2 * k - 1 - jl]):
                    EO = []
                    for par in range(2):
                        taken[m, qs, par] += 1
                        ns = np.arange(par, nx - m, 2)
                        lm = L[qs][:, tri_offset(m, nx) + ns]   # (svw, n)
                        acc = np.zeros((rows, 2, svw), dtype=dt)
                        for j, n in enumerate(ns):
                            acc = (acc + p[:, :, m, n, None] * lm[:, j]
                                   ).astype(dt)
                        EO.append(acc)
                    for c in range(2):
                        for v, q in enumerate(qs):
                            b = band_of[q]
                            pp = q - plan["bands"][b][0]
                            col = c * h + m // 2
                            e, o = EO[0][:, c, v], EO[1][:, c, v]
                            if m == 0 and c == 1:
                                e = o = np.zeros_like(e)
                            fin[b][:, m % 2, col, 2 * pp] = e + o
                            fin[b][:, m % 2, col, 2 * pp + 1] = e - o
    assert (taken == 1).all()
    g = np.zeros((rows, il, ix), dtype=dt)
    prod = ((lambda a, t: k_tiled_3xtf32(a, t, plan["mma_k"])) if f32 else
            (lambda a, t: k_tiled(a, t, plan["mma_k"])))
    for b, band in enumerate(plan["bands"]):
        lats = [lat for _, _, lat in slots(plan, il, band)][:fin[b].shape[-1]]
        Pe = prod(np.swapaxes(fin[b][:, 0], 1, 2), B[0])
        Po = prod(np.swapaxes(fin[b][:, 1], 1, 2), B[1])
        g[:, lats] = np.concatenate([Pe + Po, Pe - Po], axis=-1)
    if kcos != 1:
        g = g * tsp.cosgr.numpy().astype(dt)[:, None]
    return g


@pytest.mark.parametrize("plan_prec", sorted(DTYPES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_model_of_the_direct_kernels_matches_jax(preset, plan_prec):
    JS, jsp = jax_transforms(preset)
    tsp = transforms(preset)
    rng = np.random.default_rng(1300 + tsp.il)
    grid = rng.standard_normal((3, tsp.il, tsp.ix))
    want = JS.grid2spec_p(jsp, grid)                       # (2, 3, mx, nx)
    got = model_direct(tsp, grid, plan_of(preset, plan_prec))
    assert rel_err(got, np.moveaxis(want, 0, 1)) <= 1e-12


@pytest.mark.parametrize("plan_prec", sorted(DTYPES))
@pytest.mark.parametrize("kcos", [1, 2])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_model_of_the_inverse_kernels_matches_jax(preset, kcos, plan_prec):
    """The inverse kernel's decomposition with the blocks of each type: in
    float64 1e-12 of the largest value; in float32, on the float32 tables
    and inputs with the 3xTF32 products emulated (k_tiled_3xtf32), 1e-5 of
    the largest value of the JAX package's float64 result. The imaginary
    part of m = 0 is never read."""
    JS, jsp = jax_transforms(preset)
    f32 = plan_prec == "f32"
    tsp = transforms(preset, plan_prec)
    plan = plan_of(preset, plan_prec)
    rng = np.random.default_rng(1310 + tsp.il + kcos)
    spec = random_pair(rng, (3,), tsp.mx, tsp.nx)
    if f32:
        spec = spec.astype(np.float32).astype(np.float64)
    want = JS.spec2grid_p(jsp, np.moveaxis(spec, 1, 0), kcos)
    assert rel_err(model_inverse(tsp, spec, kcos, plan), want) \
        <= (1e-5 if f32 else 1e-12)
    dirty = spec.copy()
    dirty[:, 1, 0, :] = 1e3 * rng.standard_normal((3, tsp.nx))
    spec[:, 1, 0, :] = 0.0
    assert np.array_equal(model_inverse(tsp, dirty, kcos, plan),
                          model_inverse(tsp, spec, kcos, plan))


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
        "direct_bf16": (d, (tsp, [g, z(2 * il * ix + 1, dtype=torch.bfloat16)[
            1:].view(2, il, ix)]), ValueError, "16-byte"),
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
    them. A bfloat16 grid is taken there, not in the 2-byte operand mode
    (bfloat16 tables) but widened by the kernel: its type passes the
    wrapper's checks (the call stops at the device), an unaligned one is
    refused."""
    tsp = transforms("T63", "f32")
    grid = torch.zeros(2, tsp.il, tsp.ix)
    with pytest.raises(ValueError, match="T30"):
        TK.fused_probe_cuda(tsp, 0, grid)
    with pytest.raises(ValueError, match="CUDA"):
        TK.fused_grid2spec_cuda(tsp, grid.to(torch.bfloat16))
    bad = torch.zeros(2 * tsp.il * tsp.ix + 8, dtype=torch.bfloat16)[
        1:1 + 2 * tsp.il * tsp.ix].view(2, tsp.il, tsp.ix)
    with pytest.raises(ValueError, match="16-byte"):
        TK.fused_grid2spec_cuda(tsp, bad)


@pytest.mark.parametrize("preset", ["T30", "T47", "T63"])
def test_a_bf16_grid_launches_its_own_instantiation(preset, monkeypatch):
    """What a group with a bfloat16 grid hands the C entry, with the device
    and the launch stubbed out: one launch per element type; at T47/T63 the
    bfloat16 grid goes to the T47/T63 library in mode 2 (float tables) or 3
    (double) with the tables' own folded values (the kernel widens the grid
    and transforms it as the tables' type does), at T30 to the T30 library
    in the same modes with the tables rounded to bfloat16, in the tables'
    type (the 2-byte operand mode); each under its own counter."""
    calls = []
    monkeypatch.setattr(TK, "_check_device", lambda fields, what: "card")
    monkeypatch.setattr(TK, "_check_tables", lambda device, *tables: None)
    monkeypatch.setattr(
        TK, "_call", lambda kernel, kind, mode, count, sp, tables, desc,
        device, what: calls.append((kernel, mode, count, tuple(tables))))
    base = {"T30": T_T30L8, "T47": T_T47L8, "T63": T_T63L8}[preset]
    saved = dict(ck.launch_counts), dict(TK.field_counts)
    try:
        for prec, mode in (("f32", 0), ("f64", 1)):
            sp = _tables(dataclasses.replace(base, precision=prec), True)
            g = torch.zeros(2, 3, sp.il, sp.ix, dtype=sp.rdtype)
            b = g.to(torch.bfloat16)
            calls.clear()
            ck.reset_launch_counts()
            TK.reset_field_counts()
            TK.fused_grid2spec_many_cuda(sp, [b, g, b[:, 1]], 1)
            hires = preset != "T30"
            lib = "fused_transform_hires" if hires else "fused_transform"
            table = sp.fold_dir if hires else sp.fold_dir_bf16
            assert table.dtype == sp.rdtype
            assert calls == [(lib, mode + 2, 2, (table.data_ptr(),)),
                             (lib, mode, 1, (sp.fold_dir.data_ptr(),))]
            counter = ("fused_grid2spec_hires" if hires
                       else "fused_grid2spec")
            assert {k: v for k, v in ck.launch_counts.items() if v} == {
                counter + "_bf16": 1, counter: 1}
            assert TK.field_counts[counter + "_bf16"] == 2
    finally:
        ck.launch_counts.update(saved[0])
        TK.field_counts.update(saved[1])


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


def direct_digest(preset, prec, grid):
    """sha256 (hex) of the direct kernel's outputs, in order, for one
    seeded group of three fields: a (40, 8) stack (320 rows), 61 rows, and
    the middle level of a (50, 3) stack (a strided member axis); 431 rows,
    so the last cluster step holds one row. The grids are in the tables'
    type, or rounded to bfloat16 with `grid` "bf16"."""
    sp = _card_tables(preset, prec)
    rng = np.random.default_rng(1334)

    def field(*lead):
        g = torch.from_numpy(rng.standard_normal(lead + (sp.il, sp.ix))).to(
            "cuda", sp.rdtype)
        return g.to(torch.bfloat16) if grid == "bf16" else g

    fields = [field(40, 8), field(61), field(50, 3)[:, 1]]
    h = hashlib.sha256()
    for out in TK.fused_grid2spec_many_cuda(sp, fields, 1):
        h.update(out.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_the_library_plan_is_the_modelled_decomposition(preset, prec):
    """Needs nvcc (and a card for the tables): the plan the library reports
    has the CPU model's blocks a cluster, bands, m pairs a block, rows a
    step, MMA columns and depth, the direct kernel's DFT and Legendre warps
    (for a grid of the tables' type and of bfloat16), the inverse's threads,
    latitude pairs a Legendre item and rows a step; each cluster block's
    shared memory fits in 227 KiB, the direct kernel's blocks an SM (two at
    T47 in float32, else one);
    a call launches one kernel a direction."""
    sp = _card_tables(preset, prec)
    plan = TK.hires_kernel_plan(sp)
    model = plan_of(preset, prec)
    for key in ("cluster", "pairs_per_band", "rows_per_step", "band_columns",
                "mma_k", "inverse_threads", "inverse_pairs_per_item",
                "inverse_rows_per_step", "direct_dft_warps",
                "direct_legendre_warps", "direct_threads"):
        assert plan[key] == model[key], key
    assert plan["m_pairs"] == len(model["m_slices"][0]) // 2
    assert max(plan["direct_smem"], plan["inverse_smem"]) <= 227 * 1024
    assert plan["direct_blocks_per_sm"] == (
        2 if (preset, prec) == ("T47", "f32") else 1)
    assert plan["direct_kernels"] == ("hires_direct_cluster_kernel",)
    assert plan["inverse_kernels"] == ("hires_inverse_ws_kernel",)
    bf16 = TK.hires_kernel_plan(sp, torch.bfloat16)
    for key in ("cluster", "rows_per_step", "direct_dft_warps",
                "direct_legendre_warps", "direct_threads"):
        assert bf16[key] == model[key], key
    assert bf16["direct_smem"] <= 227 * 1024


# The direct kernel's outputs on direct_digest's groups, recorded from the
# kernel's serial schedule (one role of warps, a whole cluster barrier a
# step) on an NVIDIA H100: the warp-specialised schedule computes every sum
# in the same order, so it must give the same bits.
DIRECT_DIGESTS = {
    ("T47", "f32", "same"):
        "31219276e33c1e812bb07b1233dd22903f40505ab45b64ef28f74b6033ee617e",
    ("T47", "f32", "bf16"):
        "dd87b214e93a799390a9f28143b246ac228cedd8a496e2be5ce34c1ed1aed7ec",
    ("T47", "f64", "same"):
        "80725175b0db3067072c6aff8ee140358f3ecb41aeb223b02aee21d391e30baf",
    ("T47", "f64", "bf16"):
        "70d3dd5d7b806615b0e77eb52405c9ea661b2736ac2cc1ed32988d7a9ce099d0",
    ("T63", "f32", "same"):
        "20e45a5e8dcad3ab2d8351edfe72d07fb192c22cfd0857f60074e49cbc49b05b",
    ("T63", "f32", "bf16"):
        "821a55d1cef33e93e8704d41fe8324ed1c514b7d9bc47bb93e550188331a8191",
    ("T63", "f64", "same"):
        "3bdee3a468e71cce61df7d4b20d4147b1b678951acf41826890d7a5966a46b31",
    ("T63", "f64", "bf16"):
        "195e6879872b8bbaf6274992b894b138fe4b710a87a2f3b3409f14df63454232",
}


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["same", "bf16"])
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_the_direct_kernel_gives_its_recorded_bits(preset, prec, grid):
    """Needs an NVIDIA GPU and nvcc: the direct kernel's outputs on seeded
    groups (T47 / T63, float / double tables, a grid of the tables' type or
    of bfloat16) hash to the recorded digests, twice."""
    want = DIRECT_DIGESTS[preset, prec, grid]
    assert direct_digest(preset, prec, grid) == want
    assert direct_digest(preset, prec, grid) == want


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
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_a_bf16_grid_matches_the_einsum_chain_on_the_card(preset, prec):
    """Needs an NVIDIA GPU and nvcc: a bfloat16 grid, in strided layouts,
    transforms within 1e-12 (f64) / 1e-5 (f32) of the largest value of the
    einsum chain on the widened grid, and bitwise as the kernel of the
    tables' type on that widened grid."""
    sp = _card_tables(preset, prec)
    grids, _ = _card_fields(sp, 1335)
    limit = 1e-12 if prec == "f64" else 1e-5
    for g in grids:
        b = g.to(torch.bfloat16)
        got = TK.fused_grid2spec_cuda(sp, b, 1)
        wide = b.to(sp.rdtype)
        want = TK.grid2spec_hires_plain(sp, wide, 1)
        assert float((got - want).abs().max() / want.abs().max()) <= limit
        assert torch.equal(got, TK.fused_grid2spec_cuda(sp, wide, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_a_bf16_group_equals_its_fields_one_by_one_on_the_card(preset, prec):
    """Needs an NVIDIA GPU and nvcc: a group of bfloat16 grids is one
    launch of the bfloat16 instantiation, its outputs bitwise those of the
    fields launched alone."""
    sp = _card_tables(preset, prec)
    grids = [g.to(torch.bfloat16) for g in _card_fields(sp, 1336)[0]]
    before = ck.launch_counts["fused_grid2spec_hires_bf16"]
    many = TK.fused_grid2spec_many(sp, grids, 1)
    assert ck.launch_counts["fused_grid2spec_hires_bf16"] == before + 1
    for g, got in zip(grids, many):
        assert torch.equal(got, TK.fused_grid2spec_cuda(sp, g, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_a_member_alone_is_bitwise_that_member_of_a_batch(preset):
    """Needs an NVIDIA GPU and nvcc: member 5 of 8 distinct members, run
    alone, equals that member of the batch bitwise after 6 steps of the
    full-physics T47 / T63 model through the kernels."""
    _member_alone_check(preset, bf16_tendencies=False)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_a_member_alone_is_bitwise_that_member_with_bf16_tendencies(preset):
    """Needs an NVIDIA GPU and nvcc: as above with bf16_tendencies, the
    direct transforms of the steps taking a bfloat16 grid."""
    _member_alone_check(preset, bf16_tendencies=True)


def _member_alone_check(preset, bf16_tendencies):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    p = dataclasses.replace(PRESETS[preset], precision="f32",
                            fft_mode="matmul")
    consts, state1, cal = make_demo_model(p, device="cuda",
                                          bf16_tendencies=bf16_tendencies)
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
    before = ck.launch_counts["fused_grid2spec_hires_bf16"]
    out8 = run(batch, ctx())
    out1 = run(one, ctx())
    assert (ck.launch_counts["fused_grid2spec_hires_bf16"] > before) \
        == bf16_tendencies
    for name in ("vor", "div", "t", "ps", "tr"):
        for a, b in zip(out8[name], out1[name]):
            assert torch.equal(a[5:6], b), name
    assert float((out8["t"][0] - out8["t"][0][:1]).abs().max()) > 1e-6
