"""The grid-dynamics function, the one module of the port that holds a CUDA
kernel (pyspeedy_tpu_torch/csrc/grid_dynamics.cu).

There is no card and no nvcc where these tests run, so what is held against
the JAX package is the kernel's plain PyTorch version,
``models.tendencies.grid_dynamics_core``: (a) against the JAX
``grid_dynamics_core`` under ``vmap`` and (b) against the JAX package's Pallas
path as its own tests run it off the TPU, ``tiled_columnwise`` in interpret
mode. The kernel itself is held against the plain version on the card by
``chip_smoke.py``. Limit 1e-12 of each output's largest value in float64:
same formulation on both sides, the order of a few sums differs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyspeedy_tpu.params as jparams
import pyspeedy_tpu_torch.params as tparams
from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.models.tendencies import grid_dynamics_core as j_core
from pyspeedy_tpu.ops.pallas_tiling import tiled_columnwise
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models.tendencies import grid_dynamics_core as t_core
from pyspeedy_tpu_torch.ops import column_kernels as ck

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

TOL = 1e-12
NMEM = 3
OUT_NAMES = ("utend", "vtend", "ttend", "trtend", "psdt_g", "flux_ut",
             "flux_vt", "flux_qu", "flux_qv", "ke")
_cache = {}


def setup(preset):
    if preset not in _cache:
        jp, tp = getattr(jparams, preset), getattr(tparams, preset)
        jconsts, _ = JM.build_consts(jp, physics_on=False)
        tconsts, _ = TM.build_consts(tp, device="cpu", physics_on=False)
        _cache[preset] = (jp, jconsts, tconsts)
    return _cache[preset]


def inputs(params, nmem=NMEM, seed=0):
    """Seeded member-batched grid fields of plausible magnitude (numpy)."""
    rng = np.random.default_rng(seed)
    kx, il, ix, ntr = params.kx, params.il, params.ix, params.ntr
    mk = lambda k, scale, mean=0.0: (
        mean + scale * rng.standard_normal((nmem, k, il, ix)))
    return (mk(kx, 3e-5), mk(kx, 1e-5), mk(kx, 15.0, 250.0),
            mk(ntr * kx, 2.0, 5.0), mk(kx, 15.0), mk(kx, 10.0), mk(2, 2e-8))


def jax_planes(jp, jconsts):
    shape = (jp.il, jp.ix)
    rcos2d = jnp.broadcast_to(jnp.asarray(jconsts.sp.cosgr)[:, None], shape)
    coriol2d = jnp.broadcast_to(
        jnp.asarray(jconsts.geom.coriol)[:, None], shape)
    return rcos2d, coriol2d


def compare(got, want):
    for name, g, w in zip(OUT_NAMES, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("preset", ["T30L8", "T30L5"])
def test_plain_core_matches_jax_core_under_vmap(preset):
    jp, jconsts, tconsts = setup(preset)
    args = inputs(jp)
    planes = jax_planes(jp, jconsts)
    want = jax.vmap(lambda *a: j_core(jconsts, *a, *planes))(
        *map(jnp.asarray, args))
    got = t_core(tconsts.col, *map(torch.from_numpy, args))
    compare(got, want)


@pytest.mark.parametrize("preset", ["T30L8", "T30L5"])
def test_plain_core_matches_jax_pallas_path(preset):
    """The JAX package's kernel path, run as its own tests run it on the
    CPU: the latitude-tiled Pallas call in interpret mode."""
    jp, jconsts, tconsts = setup(preset)
    args = inputs(jp, seed=1)
    planes = jax_planes(jp, jconsts)

    def one_member(*a):
        return tiled_columnwise(lambda *b: j_core(jconsts, *b),
                                (*a, *planes), jp.il)

    want = jax.vmap(one_member)(*map(jnp.asarray, args))
    got = t_core(tconsts.col, *map(torch.from_numpy, args))
    compare(got, want)


def test_plain_core_two_tracers_and_member_independence():
    """ntr = 2 splits the flat tracer axis per tracer, and a member's
    columns do not depend on the other members."""
    import dataclasses
    tp = dataclasses.replace(tparams.T30L8, ntr=2)
    tconsts, _ = TM.build_consts(tp, device="cpu", physics_on=False)
    args = [torch.from_numpy(a) for a in inputs(tp, nmem=2, seed=4)]
    both = t_core(tconsts.col, *args)
    second = t_core(tconsts.col, *[a[1:] for a in args])
    for name, b, s in zip(OUT_NAMES, both, second):
        assert torch.equal(b[1:], s), name
    # Tracer 1 alone gives tracer 1's slice of the two-tracer result.
    kx = tp.kx
    one = list(args)
    one[3] = args[3][:, kx:].contiguous()
    tp1 = tparams.T30L8
    tconsts1, _ = TM.build_consts(tp1, device="cpu", physics_on=False)
    single = t_core(tconsts1.col, *one)
    for idx in (3, 7, 8):      # trtend, flux_qu, flux_qv
        assert torch.equal(both[idx][:, kx:], single[idx]), OUT_NAMES[idx]


def test_cpu_dispatch_never_touches_the_build(monkeypatch):
    """A CPU tensor takes the plain version: no build, no load, no launch
    counted."""
    _, _, tconsts = setup("T30L8")

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(ck, "build_kernels", refuse)
    monkeypatch.setattr(ck, "_load", refuse)
    before = dict(ck.launch_counts)
    args = [torch.from_numpy(a) for a in inputs(tparams.T30L8, nmem=1)]
    out = ck.grid_dynamics(t_core, tconsts.col, *args)
    want = t_core(tconsts.col, *args)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert ck.launch_counts == before


def _bad_inputs():
    good = [torch.from_numpy(a) for a in inputs(tparams.T30L8, nmem=2)]

    def swap(i, t):
        bad = list(good)
        bad[i] = t
        return bad

    return {
        "dtype": (swap(2, good[2].float()), TypeError),
        "half": ([a.half() for a in good], TypeError),
        "shape": (swap(1, good[1][:, :, :-1].contiguous()), ValueError),
        "members": (swap(4, good[4][:1]), ValueError),
        "tracer_axis": (swap(3, good[3][:, :5].contiguous()), ValueError),
        "pxy": (swap(6, good[6][:, :1].contiguous()), ValueError),
        "contiguity": (swap(0, good[0].transpose(2, 3).contiguous()
                            .transpose(2, 3)), ValueError),
        "rank": ([a[0] for a in good], ValueError),
    }


@pytest.mark.parametrize("case", ["dtype", "half", "shape", "members",
                                  "tracer_axis", "pxy", "contiguity", "rank"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
    """The CUDA wrapper validates before it builds or launches: wrong dtype,
    shape or contiguity raises, and so does a CPU tensor handed to it
    directly (it never falls back to the plain version)."""
    _, _, tconsts = setup("T30L8")
    monkeypatch.setattr(ck, "_load", lambda name: pytest.fail("loaded"))
    bad, exc = _bad_inputs()[case]
    before = dict(ck.launch_counts)
    with pytest.raises(exc):
        ck.grid_dynamics_cuda(tconsts.col, *bad)
    assert ck.launch_counts == before


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    _, _, tconsts = setup("T30L8")
    monkeypatch.setattr(ck, "_load", lambda name: pytest.fail("loaded"))
    good = [torch.from_numpy(a) for a in inputs(tparams.T30L8, nmem=1)]
    with pytest.raises(ValueError, match="CUDA"):
        ck.grid_dynamics_cuda(tconsts.col, *good)


def test_wrong_level_count_raises():
    _, _, tconsts8 = setup("T30L8")
    args5 = [torch.from_numpy(a) for a in inputs(tparams.T30L5, nmem=1)]
    with pytest.raises(ValueError, match="kx"):
        ck.grid_dynamics_cuda(tconsts8.col, *args5)


def test_kernel_source_and_build_command():
    """The kernel is CUDA C++ in the package's csrc/, built by nvcc for
    sm_90a into a shared library with a plain C interface."""
    src = ck.KERNEL_SOURCES["grid_dynamics"]
    text = src.read_text()
    assert src.parent.name == "csrc" and src.suffix == ".cu"
    assert 'extern "C" int pyspeedy_grid_dynamics' in text
    assert "torch/extension.h" not in text
    assert "arch=compute_90a,code=sm_90a" in ck.NVCC_FLAGS
    assert "-shared" in ck.NVCC_FLAGS


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc; `python3 chip_smoke.py` runs the same
    comparison at full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    tp = tparams.T30L8
    consts, _ = TM.build_consts(tp, device="cuda", physics_on=False)
    args = [torch.from_numpy(a).cuda() for a in inputs(tp, nmem=4)]
    got = ck.grid_dynamics_cuda(consts.col, *args)
    want = t_core(consts.col, *args)
    for name, g, w in zip(OUT_NAMES, got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= TOL, name
