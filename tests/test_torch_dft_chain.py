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
    assert "dft_chain_kernel" in text
    assert "tools/exp_dft_kernel.py:113 make_pallas_step" in text
    cmd = ck.build_command("dft_chain", "nvcc", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert len(spec.argtypes) == 9
    assert spec.counters == ("dft_chain",)


@pytest.mark.gpu
def test_kernel_matches_the_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc. The kernel against the plain version at
    two members in float32 and float64; `python3 chip_smoke.py` holds it at
    the tool's 256 members."""
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
