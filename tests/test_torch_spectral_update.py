"""The spectral update, the fourth module of the port that holds a CUDA kernel
(pyspeedy_tpu_torch/csrc/spectral_update.cu, wrapper and dispatch in
pyspeedy_tpu_torch/ops/glue_kernels.py, plain version
pyspeedy_tpu_torch/models/spectral_glue.py::spectral_update_plain).

There is no card and no nvcc where these tests run, so what is held against
the JAX package is the kernel's plain PyTorch version, which the dispatcher
takes for CPU tensors: against ``pyspeedy_tpu.models.spectral_glue.
spectral_update`` in both of its formulations (``mosaic_safe`` False and
True), for the three time steps of the start-up sequence, and against the
TPU kernel this one replaces, ``tools/exp_glue.py::member_tiled_kernel``,
which runs in Pallas interpret mode on the CPU. The kernel itself is held
against the plain version on the card by ``chip_smoke.py`` and by the
gpu-marked test at the end.

Inputs are made with numpy from a seed and handed to both packages. Limit:
1e-12 of each output's largest value in float64 (the level contractions are
summed in another order by XLA and by torch's einsum).
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pyspeedy_tpu.models import implicit as jimp
from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.models.spectral_glue import spectral_update as j_update
from pyspeedy_tpu.params import T30L8 as J_T30L8
from pyspeedy_tpu_torch.models import implicit as timp
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models import spectral_glue as TG
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import glue_kernels as GK
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12
NMEM = 4
# The three time steps of the start-up sequence (factors of delt).
DT_FACTORS = (0.5, 1.0, 2.0)
OUT_NAMES = ("ps0", "ps1", "vor0", "vor1", "div0", "div1", "t0", "t1",
             "trf0", "trf1")
_cache = {}


def import_tool(name):
    """Import tools/<name>.py as it is. At import the tools create a cache
    directory under /tmp and point JAX's persistent compilation cache there;
    both are suppressed, so the test process keeps its own settings."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    update = jax.config.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "makedirs", lambda *a, **k: None)
        mp.setattr(jax.config, "update", lambda key, value: None
                   if "cache" in key else update(key, value))
        spec.loader.exec_module(module)
    return module


def models():
    """(JAX consts, port consts, numpy geometry) of the dynamics-only T30L8
    model in float64 on the CPU, built once."""
    if "models" not in _cache:
        jconsts, geom = JM.build_consts(J_T30L8, physics_on=False)
        tconsts, _ = TM.build_consts(T_T30L8, device="cpu", physics_on=False)
        _cache["models"] = (jconsts, tconsts, geom)
    return _cache["models"]


def consts_for(factor):
    """Both packages' consts with the implicit tables of dt = factor*delt."""
    key = ("dt", factor)
    if key not in _cache:
        jconsts, tconsts, geom = models()
        dt = factor * J_T30L8.delt
        _cache[key] = (
            jconsts.with_implicit(jimp.build_implicit(
                J_T30L8, geom, jconsts.hd, dt)),
            tconsts.with_implicit(timp.build_implicit(
                T_T30L8, geom, tconsts.hd, dt, device="cpu")))
    return _cache[key]


def numpy_inputs(seed, nmem=NMEM):
    """Seeded (flux spectra, state arrays) of plausible magnitude: the
    6 + 3*ntr spectra, then psdt, vor0, vor1, div0, div1, t0, t1, ps0, ps1,
    trf0, trf1 (tracers flat), phi, tcorh, qcorh."""
    p = J_T30L8
    kx, mx, nx, ntr = p.kx, p.mx, p.nx, p.ntr
    rng = np.random.default_rng(seed)
    mk = lambda shape, scale: scale * rng.standard_normal((nmem,) + shape)
    lev, plane, trac = (2, kx, mx, nx), (2, mx, nx), (2, ntr * kx, mx, nx)
    specs = [mk(lev, 1e-5) for _ in range(6 + 3 * ntr)]
    state = [mk(plane, 1e-5), mk(lev, 1e-5), mk(lev, 1e-5), mk(lev, 1e-6),
             mk(lev, 1e-6), mk(lev, 10.0), mk(lev, 10.0), mk(plane, 1e-2),
             mk(plane, 1e-2), mk(trac, 1e-3), mk(trac, 1e-3), mk(lev, 1e3),
             mk(plane, 1.0), mk(plane, 1e-3)]
    return specs, state


def torch_update(tconsts, j1, factor, specs, state):
    eps = 0.0 if j1 == 1 else T_T30L8.rob
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return TG.spectral_update(tconsts, j1, factor * T_T30L8.delt, eps,
                              [t(x) for x in specs], *(t(x) for x in state))


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("mosaic_safe", [False, True])
@pytest.mark.parametrize("factor", DT_FACTORS)
@pytest.mark.parametrize("j1", [1, 2])
def test_plain_version_matches_jax(j1, factor, mosaic_safe):
    """The plain version against the JAX spectral_update, vmapped over the
    members, with the implicit tables of each start-up time step: all ten
    outputs."""
    jconsts, tconsts = consts_for(factor)
    specs, state = numpy_inputs(seed=int(10 * factor) + j1)
    dt = factor * J_T30L8.delt
    eps = 0.0 if j1 == 1 else J_T30L8.rob
    want = jax.jit(jax.vmap(lambda sp, *st: j_update(
        jconsts, j1, dt, eps, mosaic_safe, list(sp), *st)))(specs, *state)
    got = torch_update(tconsts, j1, factor, specs, state)
    for name, g, w in zip(OUT_NAMES, got, want):
        assert rel_err(g.numpy(), w) <= TOL, name


@pytest.mark.parametrize("j1,factor", [(1, 0.5), (2, 2.0)])
def test_plain_version_matches_the_member_tiled_pallas_kernel(j1, factor):
    """The plain version against the TPU kernel it replaces:
    tools/exp_glue.py::member_tiled_kernel over the tool's glue_one (the JAX
    spectral_update in its kernel formulation), two members per program, in
    Pallas interpret mode. The tool hands the kernel a tenth spectrum that
    the combination does not read; so does this test."""
    tool = import_tool("exp_glue")
    jconsts, tconsts = consts_for(factor)
    specs, state = numpy_inputs(seed=30 + j1)
    unused = np.random.default_rng(5).standard_normal(specs[0].shape)
    dt = factor * J_T30L8.delt
    eps = 0.0 if j1 == 1 else J_T30L8.rob
    assert tool.N_SPECS == len(specs) + 1

    def glue_one(*a):
        sp_list = list(a[:tool.N_SPECS])
        return j_update(jconsts, j1, dt, eps, True, sp_list,
                        *a[tool.N_SPECS:])

    want = tool.member_tiled_kernel(glue_one, specs + [unused] + state,
                                    mtile=2)
    got = torch_update(tconsts, j1, factor, specs, state)
    for name, g, w in zip(OUT_NAMES, got, want):
        assert rel_err(g.numpy(), w) <= TOL, name


def test_stride0_member_axis_equals_materialised_members():
    """A freshly broadcast state (one member expanded: stride 0 on the member
    axis, the layout of the first step after broadcast_state) gives what the
    same state materialised member by member gives."""
    _, tconsts = consts_for(2.0)
    specs, state = numpy_inputs(seed=3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    specs_t = [t(x) for x in specs]
    shared = [t(x[:1]).expand(NMEM, *x.shape[1:]) for x in state[1:]]
    dense = [x.contiguous() for x in shared]
    assert all(x.stride(0) == 0 for x in shared)
    psdt = t(state[0])
    a = TG.spectral_update(tconsts, 2, 2 * T_T30L8.delt, T_T30L8.rob,
                           specs_t, psdt, *shared)
    b = TG.spectral_update(tconsts, 2, 2 * T_T30L8.delt, T_T30L8.rob,
                           specs_t, psdt, *dense)
    for name, x, y in zip(OUT_NAMES, a, b):
        assert rel_err(x.numpy(), y.numpy()) <= 1e-15, name


def test_field_strides_address_the_layouts_of_the_step():
    """The five element strides the kernel reads a field through rebuild the
    field from its storage for every layout the step hands over: dense, the
    stride-0 member axis, the flattened tracer stack of a broadcast state,
    a pair axis in front (the einsum routes' movedim), a plane. A wrong shape
    is refused."""
    nmem, kx, mx, nx = 3, 8, 31, 32
    z = lambda *s: torch.arange(float(np.prod(s))).reshape(s)
    tr = z(1, 2, 1, kx, mx, nx).expand(nmem, 2, 1, kx, mx, nx)
    cases = [
        (z(nmem, 2, kx, mx, nx), (nmem, 2, kx, mx, nx)),
        (z(1, 2, kx, mx, nx).expand(nmem, 2, kx, mx, nx),
         (nmem, 2, kx, mx, nx)),
        (tr.flatten(2, 3), (nmem, 2, kx, mx, nx)),
        (z(2, nmem, kx, mx, nx).movedim(0, 1), (nmem, 2, kx, mx, nx)),
        (z(nmem, 2, kx, nx, mx).transpose(-1, -2), (nmem, 2, kx, mx, nx)),
        (z(1, 2, mx, nx).expand(nmem, 2, mx, nx), (nmem, 2, mx, nx)),
    ]
    for x, shape in cases:
        s = GK.field_strides("x", x, shape)
        x5 = x if x.dim() == 5 else x.unsqueeze(2)
        index = np.meshgrid(*(np.arange(d) for d in x5.shape), indexing="ij")
        offset = x.storage_offset() + sum(i * st for i, st in zip(index, s))
        storage = torch.as_strided(x, (x.untyped_storage().nbytes()
                                       // x.element_size(),), (1,), 0)
        assert torch.equal(storage[torch.from_numpy(offset)], x5)
    with pytest.raises(ValueError, match="expected"):
        GK.field_strides("x", z(nmem, 2, kx, nx, mx), (nmem, 2, kx, mx, nx))


def test_kernel_levels_hold_the_tables_the_plain_version_reads():
    """The per-level pack of the argument struct holds, in the source's
    order, the values of the device tables the plain version reads."""
    _, tconsts = consts_for(0.5)
    col, im, hd = tconsts.col, tconsts.implicit, tconsts.hd
    kx = T_T30L8.kx
    lv = GK.kernel_levels(tconsts)
    flat = lambda x: x.numpy().ravel()
    want = [flat(col.dhs), flat(col.dhsr), flat(col.tref), flat(col.tref3),
            flat(im.tref), flat(im.tref2), flat(im.dhsx), flat(hd.tcorv),
            flat(hd.qcorv), flat(im.xd), flat(im.xc)]
    assert lv.shape == (9 * kx + 2 * kx * kx,)
    assert np.array_equal(lv, np.concatenate(want))


def test_cpu_dispatch_never_touches_the_build(monkeypatch):
    """CPU tensors take the plain version through the model's path: no build,
    no load, no launch counted; the plain version counts its calls, one per
    spectral update."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(ck, "build_kernels", refuse)
    monkeypatch.setattr(GK, "_load", refuse)
    _, tconsts = consts_for(2.0)
    before = dict(ck.launch_counts)
    GK.reset_plain_calls()
    specs, state = numpy_inputs(seed=4, nmem=2)
    torch_update(tconsts, 2, 2.0, specs, state)
    assert GK.plain_calls == {"spectral_update": 1}
    assert ck.launch_counts == before


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    """Handed CPU tensors directly, the CUDA wrapper raises: it never falls
    back to the plain version."""
    monkeypatch.setattr(GK, "_load", lambda name: pytest.fail("loaded"))
    _, tconsts = consts_for(2.0)
    specs, state = numpy_inputs(seed=4, nmem=2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    before = dict(ck.launch_counts)
    GK.reset_plain_calls()
    with pytest.raises(ValueError, match="CUDA"):
        GK.spectral_update_cuda(tconsts, 2, 2 * T_T30L8.delt, T_T30L8.rob,
                                [t(x) for x in specs],
                                *(t(x) for x in state))
    assert ck.launch_counts == before
    assert GK.plain_calls == {"spectral_update": 0}


def test_kernel_source_and_build_command():
    """One CUDA C++ source in the package's csrc/, hand-written (no library
    kernel, no PyTorch headers), built by nvcc for sm_90a through the kernel
    table without contracted multiply-adds."""
    spec = ck.KERNELS["spectral_update"]
    text = spec.source.read_text()
    assert spec.source.name == "spectral_update.cu"
    assert spec.source.parent.name == "csrc"
    assert f'extern "C" int {spec.symbol}' in text
    for banned in ("torch/extension.h", "cublas", "cufft",
                   "cutlass/gemm/device", "#include <cutlass"):
        assert banned not in text.lower(), banned
    assert "spectral_update_kernel" in text
    assert "tools/exp_glue.py:39 member_tiled_kernel" in text
    cmd = ck.build_command("spectral_update", "nvcc", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert len(spec.argtypes) == 19
    assert spec.counters == ("spectral_update",)
    # The design: the row's tables and the staged spectra in shared memory
    # through cp.async, units of members on whole warps, one block barrier
    # a staged chunk, the launch plan that ops/glue_kernels.py models.
    for word in ("cp.async.ca.shared.global", "__syncthreads()",
                 "struct Shape", "row_base", "struct LaunchPlan",
                 "pyspeedy_spectral_update_plan"):
        assert word in text, word


# The truncations the kernel serves on the model's paths: (nx, mx).
PLAN_SHAPES = {"T30": (32, 31), "T47": (49, 48), "T63": (65, 64)}


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("nmem", [1, 17, 128, 256])
@pytest.mark.parametrize("trunc", sorted(PLAN_SHAPES))
def test_launch_plan_covers_every_point_once(trunc, nmem, itemsize):
    """The kernel's launch plan (ops/glue_kernels.py::update_launch_plan,
    the model of plan() in the source; on the card the library's plan is
    held against it): every (member, part, m, n) point of the launch is
    taken by exactly one thread of one block; a member lane is 2 nx points
    in whole warps, a block at most 256 threads of lanes; its shared memory
    fits, its blocks an SM fit 16 warps of 128 registers and the SM's shared
    memory; the grid is at most the whole waves of those (132 SMs) that a
    fixed tile of 16 members (the kernel's first member-tiled design) would
    start, and no larger a tile. At T30 and B=128 it is that design's
    launch shape: 4 lanes of 64 threads a block, 2 blocks an SM, 248 blocks
    of 16 members; at T47 and T63 two whole waves where the fixed tile made
    1.45 and 1.29."""
    nx, mx = PLAN_SHAPES[trunc]
    plan = GK.update_launch_plan(nx, mx, 8, 1, itemsize, nmem)
    g, ps, threads = plan["lanes"], plan["pslots"], plan["threads"]
    bps, tile = plan["blocks_per_sm"], plan["tile"]
    assert ps % 32 == 0 and 2 * nx <= ps < 2 * nx + 32
    assert threads == g * ps <= 256
    assert plan["smem"] <= 232448
    assert bps * (plan["smem"] + 1024) <= 233472
    assert bps * threads * 128 <= 65536
    assert tile % g == 0 and plan["tiles"] == -(-nmem // tile)
    assert plan["blocks"] == mx * plan["tiles"]
    slots = GK.H100_SMS * bps
    waves = -(-mx * -(-nmem // 16) // slots)
    assert plan["blocks"] <= waves * slots and tile <= max(16, g)
    if trunc != "T30" and nmem == 128:
        assert waves == 2 and plan["blocks"] > 1.9 * slots
    # Every thread of every block on every member of its tile.
    m, t, i = np.meshgrid(np.arange(mx), np.arange(plan["tiles"]),
                          np.arange(-(-tile // g)), indexing="ij")
    th = np.arange(threads)
    lane, pt = th // ps, th % ps
    member = (t * tile + i * g)[..., None] + lane
    live = (pt < 2 * nx) & (member < np.minimum((t + 1) * tile, nmem)[
        ..., None])
    flat = ((member * 2 + pt // nx) * mx + m[..., None]) * nx + pt % nx
    hits = np.bincount(flat[live], minlength=nmem * 2 * mx * nx)
    assert hits.shape == (nmem * 2 * mx * nx,) and (hits == 1).all()
    if trunc == "T30" and nmem == 128:
        assert (g, threads, bps, plan["blocks"], tile) == (4, 256, 2, 248, 16)


@pytest.mark.gpu
def test_kernel_matches_the_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc. The kernel against the plain version at
    B=4 in float64, dense and with a stride-0 member axis, j1 = 1 and 2;
    `python3 chip_smoke.py` holds it at full width in float32 and float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    tp = dataclasses.replace(T_T30L8, fft_mode="matmul")
    consts, geom = TM.build_consts(tp, device="cuda", physics_on=False)
    for j1, factor in ((1, 0.5), (2, 2.0)):
        c = consts.with_implicit(timp.build_implicit(
            tp, geom, consts.hd, factor * tp.delt, device="cuda"))
        specs, state = numpy_inputs(seed=7)
        cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        for shared in (False, True):
            st = [cuda(x) for x in state]
            if shared:
                st = [st[0]] + [x[:1].expand_as(x) for x in st[1:]]
            args = (c, j1, factor * tp.delt, 0.0 if j1 == 1 else tp.rob,
                    [cuda(x) for x in specs], *st)
            before = ck.launch_counts["spectral_update"]
            got = TG.spectral_update(*args)
            assert ck.launch_counts["spectral_update"] == before + 1
            want = TG.spectral_update_plain(*args)
            for name, g, w in zip(OUT_NAMES, got, want):
                assert rel_err(g.cpu().numpy(), w.cpu().numpy()) <= TOL, name
