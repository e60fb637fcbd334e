"""The fused spectral transforms, the third module of the port that holds CUDA
kernels (pyspeedy_tpu_torch/csrc/fused_transform.cu, wrappers in
pyspeedy_tpu_torch/ops/transform_kernels.py).

There is no card and no nvcc where these tests run, so what is held against
the JAX package is each kernel's plain PyTorch version, which the dispatchers
take for CPU tensors. The Pallas functions these kernels replace
(tools/exp_fused_transform.py, tools/exp_fused_probe.py) have no interpret
switch, so the JAX side is the reference those tools themselves compare
against: ``pyspeedy_tpu.ops.spectral.grid2spec_p`` / ``spec2grid_p`` on the
dense matmul route, and for the probe stages the numpy expression of each
stage. The kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``.

Limits, relative to the result's largest value: 1e-13 in float64 and 1e-5 in
float32 (the same four matrix products on both sides; XLA and torch sum the 96
and 1,488 terms in another order); 2^-8 for the 2-byte operand chain (one
bfloat16 rounding of the Fourier intermediate may fall the other way where
the float32 sum lies near a tie).
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
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import geometry as tgeom
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.ops import transform_kernels as TK
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

TOL = {"f64": 1e-13, "f32": 1e-5}
NP_DTYPE = {"f64": np.float64, "f32": np.float32}
NMEM = 2
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
        assert tsp.use_dense_legendre and jsp.use_dense_legendre
        _cache[prec] = (jsp, tsp)
    return _cache[prec]


def rel_err(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(
        want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def random_spec(rng, lead):
    """Real pair (2, *lead, mx, nx) inside the transform triangle."""
    p = J_T30L8
    tri = (np.arange(p.mx)[:, None] + np.arange(p.nx)[None, :]
           <= p.trunc + 1).astype(float)
    return rng.standard_normal((2,) + lead + (p.mx, p.nx)) * tri


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("pdim", [0, 1])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_plain_direct_transform_matches_jax(prec, pdim, k):
    jsp, tsp = transforms(prec)
    rng = np.random.default_rng(100 + 10 * pdim + k)
    lead = (k,) if pdim == 0 else (NMEM, k)
    grid = rng.standard_normal(lead + (J_T30L8.il, J_T30L8.ix)).astype(
        NP_DTYPE[prec])
    if pdim == 0:
        want = JS.grid2spec_p(jsp, jnp.asarray(grid))
    else:
        want = jax.vmap(lambda g: JS.grid2spec_p(jsp, g))(jnp.asarray(grid))
    got = TK.fused_grid2spec(tsp, torch.from_numpy(grid), pdim)
    assert got.dtype == tsp.rdtype
    assert rel_err(got, want) <= TOL[prec]


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("pdim", [0, 1])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_plain_inverse_transform_matches_jax(prec, pdim, k):
    jsp, tsp = transforms(prec)
    rng = np.random.default_rng(200 + 10 * pdim + k)
    if pdim == 0:
        spec = random_spec(rng, (k,))
    else:
        spec = np.stack([random_spec(rng, (k,)) for _ in range(NMEM)])
    spec = spec.astype(NP_DTYPE[prec])
    for kcos in (1, 2):
        if pdim == 0:
            want = JS.spec2grid_p(jsp, jnp.asarray(spec), kcos)
        else:
            want = jax.vmap(lambda s: JS.spec2grid_p(jsp, s, kcos))(
                jnp.asarray(spec))
        got = TK.fused_spec2grid(tsp, torch.from_numpy(spec), kcos, pdim)
        assert rel_err(got, want) <= TOL[prec], kcos


def test_spectral_module_takes_the_dense_route_through_these_functions(
        monkeypatch):
    """ops.spectral hands the dense route to transform_kernels; the other two
    routes never come here."""
    _, tsp = transforms("f64")
    calls = []
    monkeypatch.setattr(TK, "fused_grid2spec",
                        lambda *a: calls.append("direct") or "d")
    monkeypatch.setattr(TK, "fused_spec2grid",
                        lambda *a: calls.append("inverse") or "i")
    g = torch.zeros(tsp.il, tsp.ix, dtype=torch.float64)
    p = torch.zeros(2, tsp.mx, tsp.nx, dtype=torch.float64)
    assert TS.grid2spec_p(tsp, g) == "d" and TS.spec2grid_p(tsp, p, 2) == "i"
    assert calls == ["direct", "inverse"]
    fft = TS.build_spectral(T_T30L8, tgeom.build_geometry(T_T30L8),
                            use_matmul_fft=False, device="cpu")
    TS.spec2grid_p(fft, TS.grid2spec_p(fft, g))
    assert calls == ["direct", "inverse"]


@pytest.mark.parametrize("stage", TK.PROBE_STAGES)
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_probe_stages_match_their_numpy_expression(prec, stage):
    """The four stages as tools/exp_fused_probe.py writes them."""
    jsp, tsp = transforms(prec)
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    n = 5
    grid = np.random.default_rng(300 + stage).standard_normal(
        (n, il, ix)).astype(NP_DTYPE[prec])
    dre = np.asarray(jsp.dft_fwd_re, dtype=np.float64)
    leg = np.asarray(jsp.leg_dir_dense, dtype=np.float64)
    g64 = grid.astype(np.float64)
    f = g64.reshape(n * il, ix) @ dre
    want = {0: f, 1: f.reshape(n, il * mx),
            2: f.reshape(n, il * mx) @ leg,
            3: g64.reshape(n, il * ix)[:, :il * mx].reshape(n * il, mx) * 2.0,
            }[stage]
    got = TK.fused_probe(stage, tsp, torch.from_numpy(grid))
    assert rel_err(got, want) <= TOL[prec]
    if stage == 2:
        # p2 is the real part of the whole direct transform.
        whole = TK.fused_grid2spec(tsp, torch.from_numpy(grid), 0)[0]
        assert rel_err(got.reshape(n, mx, nx), whole) <= TOL[prec]


def test_probe_stage_out_of_range_raises():
    _, tsp = transforms("f64")
    g = torch.zeros(1, tsp.il, tsp.ix, dtype=torch.float64)
    with pytest.raises(ValueError, match="stage"):
        TK.fused_probe(4, tsp, g)


@pytest.mark.parametrize("pdim", [0, 1])
def test_bf16_operand_chain_matches_jax(pdim):
    """A bfloat16 grid against float32 tables: the 2-byte operand chain of
    the bf16_tendencies configuration, float32 result."""
    jsp, tsp = transforms("f32")
    rng = np.random.default_rng(400 + pdim)
    lead = (4,) if pdim == 0 else (NMEM, 4)
    g32 = rng.standard_normal(lead + (tsp.il, tsp.ix)).astype(np.float32)
    jg = jnp.asarray(g32).astype(jnp.bfloat16)
    tg = torch.from_numpy(g32).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jg.astype(jnp.float32)),
                          tg.float().numpy())      # both round to nearest even
    if pdim == 0:
        want = JS.grid2spec_p(jsp, jg)
    else:
        want = jax.vmap(lambda g: JS.grid2spec_p(jsp, g))(jg)
    got = TK.fused_grid2spec(tsp, tg, pdim)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel_err(got, want) <= 2.0 ** -8
    # Against the float32 transform of the same rounded grid: the table and
    # intermediate roundings, 2^-9 each, over sums of 96 and 48 terms.
    full = TK.fused_grid2spec(tsp, tg.float(), pdim)
    err = rel_err(got, full)
    assert 1e-6 < err < 1e-2
    # ops.spectral routes a bfloat16 grid here on the dense route ...
    assert torch.equal(TS.grid2spec_p(tsp, tg, pdim), got)
    # ... and widens it on the other routes, as the JAX package does.
    tp = dataclasses.replace(T_T30L8, precision="f32")
    fft = TS.build_spectral(tp, tgeom.build_geometry(tp),
                            use_matmul_fft=False, device="cpu")
    assert torch.equal(TS.grid2spec_p(fft, tg, pdim),
                       TS.grid2spec_p(fft, tg.float(), pdim))


def test_bf16_grid_needs_float32_tables():
    _, tsp = transforms("f64")
    g = torch.zeros(tsp.il, tsp.ix, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        TK.fused_grid2spec(tsp, g)


def test_kernel_tables_are_views_of_the_operators():
    """What the kernels read: the inverse Legendre operator with m fastest
    and the direct tables rounded to bfloat16 from their float32 values."""
    _, tsp = transforms("f32")
    assert torch.equal(tsp.cpol_inv_t, tsp.cpol_inv_full.permute(0, 2, 1))
    assert tsp.cpol_inv_t.is_contiguous()
    assert torch.equal(tsp.dft_fwd_ri_bf16,
                       tsp.dft_fwd_ri.to(torch.bfloat16))
    assert torch.equal(tsp.cpol_dir_full_bf16,
                       tsp.cpol_dir_full.to(torch.bfloat16))
    assert float(tsp.dft_inv_ri[1, 0].abs().max()) == 0.0


def test_m0_imaginary_plane_and_round_trip():
    """Garbage in the imaginary part of m = 0 changes nothing in the inverse
    (the zero row of the DFT table, no mask), and a truncated field comes
    back from inverse + direct as far as the reference's quadrature lets it."""
    _, tsp = transforms("f64")
    rng = np.random.default_rng(7)
    spec = torch.from_numpy(random_spec(rng, (NMEM, 3))).movedim(0, 1)
    spec = TS.truncate(tsp, spec).contiguous()
    spec[:, 1, :, 0, :] = 0.0
    dirty = spec.clone()
    dirty[:, 1, :, 0, :] = torch.from_numpy(rng.standard_normal((NMEM, 3, 32)))
    clean_g = TK.fused_spec2grid(tsp, spec, 1, 1)
    assert torch.equal(TK.fused_spec2grid(tsp, dirty, 1, 1), clean_g)
    # The reference's transform pair is not exactly orthogonal (Gaussian
    # nodes rounded to float32 first, ops/geometry.py): white noise up to the
    # truncation comes back to 7e-3 of its largest coefficient.
    back = TK.fused_grid2spec(tsp, clean_g, 1)
    assert rel_err(back, spec) <= 2e-2


def test_cpu_dispatch_never_touches_the_build(monkeypatch):
    """A CPU tensor takes the plain version: no build, no load, no launch
    counted; the plain chain counts its calls."""
    _, tsp = transforms("f64")

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(ck, "build_kernels", refuse)
    monkeypatch.setattr(TK, "_load", refuse)
    before = dict(ck.launch_counts)
    TK.reset_plain_chain_calls()
    g = torch.zeros(2, tsp.il, tsp.ix, dtype=torch.float64)
    s = TK.fused_grid2spec(tsp, g)
    TK.fused_spec2grid(tsp, s)
    TK.fused_probe(1, tsp, g)
    assert ck.launch_counts == before
    assert TK.plain_chain_calls == {"grid2spec": 1, "spec2grid": 1}


def test_rows_view_takes_strided_layouts_and_refuses_copies():
    """The layouts the step hands over collapse to member, pair and row
    strides; what would need a copy is refused."""
    mx, nx = 31, 32
    z = lambda *s: torch.zeros(*s)
    tr = z(4, 2, 3, 8, mx, nx)                     # (B, 2, ntr, kx, mx, nx)
    v = TK._rows(tr[:, :, 1], (4, 2, 8, mx, nx), "p")
    assert v.stride()[:3] == (2 * 3 * 8 * mx * nx, 3 * 8 * mx * nx, mx * nx)
    v = TK._rows(tr.flatten(2, 3), (4, 2, 24, mx, nx), "p")
    assert v.stride(2) == mx * nx
    shared = z(2, 8, mx, nx).expand(5, 2, 8, mx, nx)        # broadcast_state
    assert TK._rows(shared, (5, 2, 8, mx, nx), "p").stride(0) == 0
    flux = z(4, 16, 48, 96)[:, 8:]                 # a tracer's level slice
    assert TK._rows(flux, (4, 8, 48, 96), "g").stride()[:2] == (
        16 * 48 * 96, 48 * 96)
    with pytest.raises(ValueError, match="dense"):
        TK._rows(z(4, 2, 8, nx, mx).transpose(-1, -2), (4, 2, 8, mx, nx), "p")
    with pytest.raises(ValueError, match="copies nothing"):
        TK._rows(z(4, 8, 2, mx, nx).transpose(1, 2)[:, :, ::2],
                 (4, 2 * 4, mx, nx), "p")


def _bad_calls():
    _, tsp = transforms("f64")
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    z = lambda *s, dt=torch.float64: torch.zeros(*s, dtype=dt)
    return tsp, {
        "direct_cpu": (TK.fused_grid2spec_cuda, (z(2, il, ix),), ValueError),
        "inverse_cpu": (TK.fused_spec2grid_cuda, (z(2, mx, nx),), ValueError),
        "probe_cpu": (TK.fused_probe_cuda, (0, z(2, il, ix)), ValueError),
    }


@pytest.mark.parametrize("case", ["direct_cpu", "inverse_cpu", "probe_cpu"])
def test_cuda_wrappers_refuse_cpu_tensors(case, monkeypatch):
    """Handed a CPU tensor directly, a CUDA wrapper raises: it never falls
    back to the plain version."""
    monkeypatch.setattr(TK, "_load", lambda name: pytest.fail("loaded"))
    tsp, calls = _bad_calls()
    fn, args, exc = calls[case]
    before = dict(ck.launch_counts)
    with pytest.raises(exc, match="CUDA"):
        fn(tsp, *args)
    assert ck.launch_counts == before


def test_kernel_source_and_build_command():
    """One CUDA C++ source in the package's csrc/, hand-written (no library
    GEMM, no PyTorch headers), built by nvcc for sm_90a through the kernel
    table, holding the direct and inverse transforms and the probes."""
    spec = ck.KERNELS["fused_transform"]
    text = spec.source.read_text()
    assert spec.source.name == "fused_transform.cu"
    assert spec.source.parent.name == "csrc"
    assert f'extern "C" int {spec.symbol}' in text
    for banned in ("torch/extension.h", "cublas", "cutlass/gemm/device",
                   "#include <cutlass"):
        assert banned not in text, banned
    for kernel in ("grid2spec_kernel", "spec2grid_kernel",
                   "split_probe_kernel"):
        assert kernel in text
    for replaced in ("tools/exp_fused_transform.py:65",
                     "tools/exp_fused_transform.py:121",
                     "tools/exp_fused_probe.py:49"):
        assert replaced in text
    cmd = ck.build_command("fused_transform", "nvcc", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" not in cmd
    assert len(spec.argtypes) == 11
    assert set(spec.counters) == {"fused_grid2spec", "fused_grid2spec_bf16",
                                  "fused_spec2grid", "fused_probe"}


@pytest.mark.gpu
def test_wrappers_raise_for_a_cuda_tensor_in_a_layout_they_do_not_take():
    """Needs an NVIDIA GPU and nvcc. On the card the wrappers launch or
    raise; a layout that would need a copy is refused, never rerouted to the
    plain chain. `python3 chip_smoke.py` holds the kernels against their
    plain versions at full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    tp = dataclasses.replace(T_T30L8, fft_mode="matmul")
    tsp = TS.build_spectral(tp, tgeom.build_geometry(tp), use_matmul_fft=True,
                            device="cuda")
    il, ix, mx, nx = tsp.il, tsp.ix, tsp.mx, tsp.nx
    z = lambda *s: torch.zeros(*s, dtype=torch.float64, device="cuda")
    TK.reset_plain_chain_calls()
    with pytest.raises(ValueError, match="dense"):
        TS.spec2grid_p(tsp, z(4, 2, 8, nx, mx).transpose(-1, -2), 1, 1)
    with pytest.raises(ValueError, match="dense"):
        TS.grid2spec_p(tsp, z(4, 8, ix, il).transpose(-1, -2), 1)
    with pytest.raises(TypeError):
        TS.grid2spec_p(tsp, z(4, 8, il, ix).float(), 1)
    with pytest.raises(ValueError):
        TK.fused_probe(0, tsp, z(4, il, 2 * ix)[:, :, ::2])
    assert TK.plain_chain_calls == {"grid2spec": 0, "spec2grid": 0}
    g = torch.randn(3, 8, il, ix, dtype=torch.float64, device="cuda")
    got = TS.grid2spec_p(tsp, g, 1)
    want = TK.grid2spec_plain(tsp, g, 1)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
