"""The latitude-tiled DFT chain, the fifth module of the port that holds a CUDA
kernel (pyspeedy_tpu_torch/csrc/dft_chain.cu, wrapper and plain version in
pyspeedy_tpu_torch/ops/dft_chain.py).

There is no card and no nvcc where these tests run, so what is held against
the JAX package is the kernel's plain PyTorch version, which the dispatcher
takes for CPU tensors: against the JAX tool it comes from,
``tools/exp_dft_kernel.py``, both its XLA reference ``xla_step`` and its
Pallas kernel ``make_pallas_step`` over the two bodies
``pallas_kernel_dot`` and ``pallas_kernel_mul``, run in interpret mode (the
tool has no interpret switch: the test hands the module a ``pl`` whose
``pallas_call`` interprets). The tool is imported, not edited. The kernel is
held against the plain version on the card by ``chip_smoke.py``.

A numpy model of the kernel's arithmetic (the folded, padded tables it builds
in shared memory, the swizzled operand planes, the row groups of each
scalar type, the sums in the kernel's order, the chain between the two
products, the staged output runs) is held against the same JAX references,
so the design is checked here although the kernel itself runs only on the
card.

Inputs: seeded standard-normal Fourier pairs, as the tool makes them, at the
tool's shapes with two members. Limits, relative to each output's largest
value: 1e-12 in float64; 1e-5 in float32 (the DFTs sum 31 and 96 terms in
another order; the tool's dot body accumulates in float32 whatever its
inputs, so its bodies are compared in float32).
"""

import functools
import importlib.util
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import dft_chain as DC

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = {"f64": 1e-12, "f32": 1e-5}
NP_DTYPE = {"f64": np.float64, "f32": np.float32}
NMEM = 2
_tool = {}


def tool():
    """tools/exp_dft_kernel.py as it is. At import it creates a cache
    directory under /tmp and points JAX's persistent compilation cache
    there; both are suppressed, so the test process keeps its own
    settings."""
    if "module" not in _tool:
        spec = importlib.util.spec_from_file_location(
            "_tool_exp_dft_kernel", REPO / "tools" / "exp_dft_kernel.py")
        module = importlib.util.module_from_spec(spec)
        update = jax.config.update
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(os, "makedirs", lambda *a, **k: None)
            mp.setattr(jax.config, "update", lambda key, value: None
                       if "cache" in key else update(key, value))
            spec.loader.exec_module(module)
        _tool["module"] = module
    return _tool["module"]


def inputs(prec, seed=0):
    """Seeded Fourier pairs (NMEM, NFIELDS, KX, IL, MX) as numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (NMEM, DC.NFIELDS, DC.KX, DC.IL, DC.MX)
    return tuple(rng.standard_normal(shape).astype(NP_DTYPE[prec])
                 for _ in range(2))


def plain(prec, fre, fim):
    dtype = torch.float64 if prec == "f64" else torch.float32
    tabs = DC.device_tables(dtype, "cpu")
    return DC.dft_chain(tabs, torch.from_numpy(fre), torch.from_numpy(fim))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# A numpy model of the kernel (csrc/dft_chain.cu)
# ---------------------------------------------------------------------------

# Latitudes of a row group by scalar type (Shape<T>::LT of the source).
LAT_TILE = {"f32": 16, "f64": 8}
KQ = 16                       # wavenumbers of one parity and part
KK = 2 * KQ                   # (part, q)
IH = DC.IX // 2


def swz(k, c, pitch):
    """The source's swz: element (k, c) of a plane of `pitch` columns."""
    return k * pitch + (c ^ ((k & 3) << 2))


def folded_tables(tabs):
    """The two shared-memory table planes the kernel builds, flat: the
    inverse (parity, k = part*16 + q, i < 48) and the forward (parity,
    i < 48, c = part*16 + q), m = 2q + parity, zero where m = 31."""
    inv, fwd = (tabs[0], tabs[1]), (tabs[2], tabs[3])
    s_inv = np.zeros(2 * KK * IH, tabs[0].dtype)
    s_fwd = np.zeros(2 * IH * KK, tabs[0].dtype)
    for p in range(2):
        for k in range(KK):
            m = 2 * (k % KQ) + p
            for i in range(IH):
                if m < DC.MX:
                    s_inv[p * KK * IH + swz(k, i, IH)] = inv[k // KQ][m, i]
                    s_fwd[p * IH * KK + swz(i, k, KK)] = fwd[k // KQ][i, m]
    return s_inv, s_fwd


def plane(flat, nk, ncols):
    """A swizzled (k, column) plane read back as a dense (k, column) array."""
    k, c = np.meshgrid(np.arange(nk), np.arange(ncols), indexing="ij")
    return flat[..., swz(k, c, ncols)]


def model_kernel(prec, tabs, fre, fim):
    """The kernel's arithmetic on numpy arrays of the working type: per row
    group (member, level, tile of LT latitudes; rows rho = f*LT + jj) the
    Fourier values scattered into the (parity, k, rho) plane, the inverse
    sums Pe, Po over k in order, g = Pe +- Po, the chain, the folded sum and
    difference into the (parity, i, rho) plane, the forward sums over i in
    order, staged as (part, rho, m) and stored as one run per (part, field).
    """
    dt = NP_DTYPE[prec]
    lt = LAT_TILE[prec]
    nmem, nf, kx, il, mx = fre.shape
    rows, ntiles = nf * lt, il // lt
    s_inv, s_fwd = folded_tables(tabs)
    t_inv = plane(s_inv.reshape(2, -1), KK, IH)          # (2, k, i)
    t_fwd = plane(s_fwd.reshape(2, -1), IH, KK)          # (2, i, c)
    # The groups' Fourier values, (group, part, f, jj, m) in group order.
    src = np.stack([fre, fim], 1).reshape(nmem, 2, nf, kx, ntiles, lt, mx)
    src = src.transpose(0, 3, 4, 1, 2, 5, 6).reshape(-1, 2, nf, lt, mx)
    ngroups = src.shape[0]
    part, f, jj, m = np.meshgrid(np.arange(2), np.arange(nf), np.arange(lt),
                                 np.arange(mx), indexing="ij")
    s_f = np.zeros((ngroups, 2 * KK * rows), dt)
    s_f[:, (m & 1) * KK * rows + swz(part * KQ + (m >> 1), f * lt + jj,
                                     rows)] = src
    a_inv = plane(s_f.reshape(ngroups, 2, -1), KK, rows)   # (G, 2, k, rho)
    pe_po = np.zeros((2, ngroups, rows, IH), dt)
    for p in range(2):
        for k in range(KK):
            pe_po[p] += a_inv[:, p, k, :, None] * t_inv[p, k][None, None]
    g0, g1 = pe_po[0] + pe_po[1], pe_po[0] - pe_po[1]     # (G, rho, i)
    h0 = chain_np(g0.reshape(ngroups, nf, lt, IH))
    h1 = chain_np(g1.reshape(ngroups, nf, lt, IH))
    sd = np.stack([h0 + h1, h0 - h1], 1).reshape(ngroups, 2, rows, IH)
    i, rho = np.meshgrid(np.arange(IH), np.arange(rows), indexing="ij")
    s_h = np.zeros((ngroups, 2 * IH * rows), dt)
    for p in range(2):
        s_h[:, p * IH * rows + swz(i, rho, rows)] = sd[:, p].transpose(0, 2, 1)
    a_fwd = plane(s_h.reshape(ngroups, 2, -1), IH, rows)    # (G, 2, i, rho)
    out = np.zeros((2, ngroups, rows, KK), dt)
    for p in range(2):
        for i in range(IH):
            out[p] += a_fwd[:, p, i, :, None] * t_fwd[p, i][None, None]
    # Stage (part, rho, m): column c = part*16 + q of parity p is m = 2q + p.
    stage = np.zeros((ngroups, 2, rows, mx), dt)
    for p in range(2):
        for c in range(KK):
            if 2 * (c % KQ) + p < mx:
                stage[:, c // KQ, :, 2 * (c % KQ) + p] = out[p, :, :, c]
    stage = stage.reshape(nmem, kx, ntiles, 2, nf, lt, mx)
    ore, oim = stage.transpose(3, 0, 4, 1, 2, 5, 6).reshape(
        2, nmem, nf, kx, il, mx)
    return ore, oim


def chain_np(g):
    """The chain over axis 1 (fields) in the working type, as the kernel
    writes it: the sum of squares in field order times 1/nf."""
    dt = g.dtype.type
    acc = dt(0)
    for f in range(g.shape[1]):
        acc = acc + g[:, f] * g[:, f]
    acc = acc * (dt(1) / dt(g.shape[1]))
    th = dt(0.1) * np.tanh(acc)
    out = (g + th[:, None]) - (dt(0.01) * g) * acc[:, None]
    return np.maximum(out, dt(-3)) + np.exp(-np.abs(g)) * dt(0.05)


def test_model_tables_hold_the_folded_operators():
    """The folded planes are the tools' tables: their first half period,
    split by the parity of m, zero at m = 31; the second half period is
    (-1)^m times the first to rounding (what the fold relies on); the swizzle
    is a permutation of each plane's rows."""
    tabs = DC.make_tables(np.float64)
    t_inv = plane(folded_tables(tabs)[0].reshape(2, -1), KK, IH)
    t_fwd = plane(folded_tables(tabs)[1].reshape(2, -1), IH, KK)
    for p in range(2):
        ms = np.arange(p, DC.MX, 2)
        for part in range(2):
            cols = slice(part * KQ, part * KQ + len(ms))
            assert np.array_equal(t_inv[p, cols], tabs[part][ms, :IH])
            assert np.array_equal(t_fwd[p, :, cols], tabs[2 + part][:IH, ms])
    assert not t_inv[1, [KQ - 1, KK - 1]].any()
    assert not t_fwd[1, :, [KQ - 1, KK - 1]].any()
    sign = (-1.0) ** np.arange(DC.MX)
    assert np.abs(tabs[0][:, IH:] - sign[:, None] * tabs[0][:, :IH]).max() \
        < 1e-13
    assert np.abs(tabs[2][IH:] - sign[None] * tabs[2][:IH]).max() < 1e-15
    for pitch in (IH, KK, 48, 96):
        k, c = np.meshgrid(np.arange(8), np.arange(pitch), indexing="ij")
        idx = swz(k, c, pitch)
        assert np.array_equal(np.sort(idx, axis=1),
                              np.arange(8)[:, None] * pitch + np.arange(pitch))


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_model_of_the_kernel_matches_xla_step(prec):
    """The kernel's arithmetic (folds, padding, layouts, order of the sums,
    the chain between the products) against the tool's XLA reference."""
    t = tool()
    fre, fim = inputs(prec, seed=3)
    tabs = t.make_tables(NP_DTYPE[prec])
    want = jax.jit(jax.vmap(lambda a, b: t.xla_step(
        tuple(jnp.asarray(x) for x in tabs), a, b)))(fre, fim)
    got = model_kernel(prec, tabs, fre, fim)
    for g, w in zip(got, want):
        assert g.dtype == NP_DTYPE[prec]
        assert rel_err(g, w) <= TOL[prec]


@pytest.mark.parametrize("body", ["pallas_kernel_dot", "pallas_kernel_mul"])
def test_model_of_the_kernel_matches_the_pallas_kernel(body, monkeypatch):
    """The model in float32 against the TPU kernel it replaces, in Pallas
    interpret mode."""
    t = tool()
    monkeypatch.setattr(t, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    fre, fim = inputs("f32", seed=4)
    tabs = t.make_tables(np.float32)
    want = jax.jit(jax.vmap(t.make_pallas_step(getattr(t, body), tabs)))(
        fre, fim)
    got = model_kernel("f32", tabs, fre, fim)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= TOL["f32"]


def test_model_member_alone_is_bitwise_that_member_in_the_batch():
    """Row groups never mix members: the model's member alone is bitwise the
    same member of the batch (chip_smoke.py checks the kernel so at 256
    members)."""
    fre, fim = inputs("f64", seed=5)
    tabs = DC.make_tables(np.float64)
    both = model_kernel("f64", tabs, fre, fim)
    alone = model_kernel("f64", tabs, fre[1:], fim[1:])
    for b, a in zip(both, alone):
        assert np.array_equal(b[1:], a)


@pytest.mark.parametrize("case", ["nf", "il", "mx", "ix", "rank"])
def test_cuda_wrapper_refuses_other_shapes_before_building(case, monkeypatch):
    """The kernel is built for the tool's one shape: any other is refused
    before anything is built or loaded, whatever the device."""
    monkeypatch.setattr(ck, "build_kernels", lambda *a, **k: pytest.fail(
        "built"))
    monkeypatch.setattr(DC, "_load", lambda name: pytest.fail("loaded"))
    shape = {"nf": (1, 5, 2, DC.IL, DC.MX), "il": (1, 6, 2, 24, DC.MX),
             "mx": (1, 6, 2, DC.IL, 21), "ix": (1, 6, 2, DC.IL, DC.MX),
             "rank": (6, 2, DC.IL, DC.MX)}[case]
    x = torch.zeros(shape, dtype=torch.float64)
    tabs = DC.device_tables(torch.float64, "cpu")
    if case == "mx":
        tabs = tuple(t[:21] if t.shape[0] == DC.MX else t[:, :21]
                     for t in tabs)
    if case == "ix":
        tabs = tuple(t[:, :64] if t.shape[0] == DC.MX else t[:64]
                     for t in tabs)
    with pytest.raises(ValueError, match="tool's shape"):
        DC.dft_chain_cuda(tabs, x, x)


def test_tables_and_shapes_are_the_tools():
    """The port's copy of the tool's tables is bitwise the tool's, and so are
    its shapes."""
    t = tool()
    assert (DC.KX, DC.IL, DC.IX, DC.MX, DC.NFIELDS) == (
        t.KX, t.IL, t.IX, t.MX, t.NFIELDS)
    for dtype in (np.float32, np.float64):
        for mine, theirs in zip(DC.make_tables(dtype), t.make_tables(dtype)):
            assert mine.dtype == theirs.dtype
            assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_plain_version_matches_xla_step(prec):
    """The plain version against the tool's XLA reference, vmapped over the
    members."""
    t = tool()
    fre, fim = inputs(prec)
    tabs = tuple(jnp.asarray(x) for x in t.make_tables(NP_DTYPE[prec]))
    want = jax.jit(jax.vmap(lambda a, b: t.xla_step(tabs, a, b)))(fre, fim)
    got = plain(prec, fre, fim)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= TOL[prec]


@pytest.mark.parametrize("body", ["pallas_kernel_dot", "pallas_kernel_mul"])
def test_plain_version_matches_the_pallas_kernel(body, monkeypatch):
    """The plain version against the TPU kernel it replaces,
    make_pallas_step over each of the tool's two bodies, in Pallas interpret
    mode, float32."""
    t = tool()
    monkeypatch.setattr(t, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    fre, fim = inputs("f32", seed=1)
    step = t.make_pallas_step(getattr(t, body), t.make_tables(np.float32))
    want = jax.jit(jax.vmap(step))(fre, fim)
    got = plain("f32", fre, fim)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= TOL["f32"]


def test_chain_is_the_tools_chain():
    """The port's chain on torch tensors against the tool's on JAX arrays,
    float64, with values on both sides of the floor at -3."""
    t = tool()
    rng = np.random.default_rng(2)
    gs = [3.0 * rng.standard_normal((5, 7)) for _ in range(DC.NFIELDS)]
    want = t.chain([jnp.asarray(g) for g in gs])
    got = DC.chain([torch.from_numpy(g) for g in gs])
    # The floor at -3 is active somewhere: -3 + 0.05 exp(-|g|) there.
    assert any(bool((w < -2.95).any()) for w in want)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= 1e-14


def test_cpu_dispatch_never_touches_the_build(monkeypatch):
    """CPU tensors take the plain version: no build, no load, no launch
    counted; the plain version counts its calls."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(ck, "build_kernels", refuse)
    monkeypatch.setattr(DC, "_load", refuse)
    before = dict(ck.launch_counts)
    DC.reset_plain_calls()
    plain("f64", *inputs("f64"))
    assert DC.plain_calls == {"dft_chain": 1}
    assert ck.launch_counts == before


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    """Handed CPU tensors directly, the CUDA wrapper raises: it never falls
    back to the plain version."""
    monkeypatch.setattr(DC, "_load", lambda name: pytest.fail("loaded"))
    fre, fim = (torch.from_numpy(x) for x in inputs("f64"))
    DC.reset_plain_calls()
    with pytest.raises(ValueError, match="CUDA"):
        DC.dft_chain_cuda(DC.device_tables(torch.float64, "cpu"), fre, fim)
    assert DC.plain_calls == {"dft_chain": 0}


def test_kernel_source_and_build_command():
    """One CUDA C++ source in the package's csrc/, hand-written (no library
    kernel, no PyTorch headers), built by nvcc for sm_90a through the kernel
    table."""
    spec = ck.KERNELS["dft_chain"]
    text = spec.source.read_text()
    assert spec.source.name == "dft_chain.cu"
    assert spec.source.parent.name == "csrc"
    assert f'extern "C" int {spec.symbol}' in text
    for banned in ("torch/extension.h", "cublas", "cufft",
                   "cutlass/gemm/device", "#include <cutlass"):
        assert banned not in text.lower(), banned
    assert "dft_chain_fold_kernel" in text
    assert "mma.sync.aligned.m16n8k4.row.col.f64" in text
    assert "cp.async" in text
    assert "tools/exp_dft_kernel.py:113 make_pallas_step" in text
    cmd = ck.build_command("dft_chain", "nvcc", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert len(spec.argtypes) == 9
    assert spec.counters == ("dft_chain",)


@pytest.mark.gpu
def test_kernel_matches_the_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc. The kernel against the plain version at
    two members in float32 and float64, and each member alone bitwise the
    same member of the pair; `python3 chip_smoke.py` holds it at the tool's
    256 members."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        tabs = DC.device_tables(dtype, "cuda")
        fre, fim = (torch.from_numpy(x).cuda() for x in inputs(prec))
        before = ck.launch_counts["dft_chain"]
        got = DC.dft_chain(tabs, fre, fim)
        assert ck.launch_counts["dft_chain"] == before + 1
        want = DC.dft_chain_plain(tabs, fre, fim)
        for g, w in zip(got, want):
            assert rel_err(g.cpu().numpy(), w.cpu().numpy()) <= TOL[prec]
        for b in range(NMEM):
            alone = DC.dft_chain(tabs, fre[b:b + 1].contiguous(),
                                 fim[b:b + 1].contiguous())
            assert all(torch.equal(a[0], g[b]) for a, g in zip(alone, got))


def test_kernel_time_exits_non_zero_without_a_card(capsys):
    """`python -m pyspeedy_tpu_torch.kernel_time` measures on the card only:
    without one it says so and exits non-zero, timing nothing."""
    from pyspeedy_tpu_torch import kernel_time
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would time it")
    assert kernel_time.main() == 2
    assert "CUDA device" in capsys.readouterr().err
