"""The port's real-pair spectral operators against the JAX package's, on
seeded numpy inputs in float64: both transform directions on the fft, dense
matmul and einsum paths, and every spectral-space operator, with and without
a leading member axis. Limit 1e-12 of the result's largest value: the two
packages contract in a different order (XLA dot vs torch matmul/einsum,
pocketfft vs XLA's FFT), which moves the last few bits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspeedy_tpu.ops import geometry as jgeom
from pyspeedy_tpu.ops import spectral as JS
from pyspeedy_tpu.params import T30L8 as J_T30L8, T47L8 as J_T47L8
from pyspeedy_tpu_torch.ops import geometry as tgeom
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8, T47L8 as T_T47L8

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

TOL = 1e-12
# name -> (JAX params, port params, use_matmul_fft). T30 + matmul takes the
# dense Legendre operator; T47 + matmul is too large for it and takes the
# einsum path.
PATHS = {
    "fft": (J_T30L8, T_T30L8, False),
    "dense": (J_T30L8, T_T30L8, True),
    "einsum": (J_T47L8, T_T47L8, True),
}
_cache = {}


def transforms(path):
    if path not in _cache:
        jp, tp, mm = PATHS[path]
        jsp = JS.build_spectral(jp, jgeom.build_geometry(jp),
                                use_matmul_fft=mm)
        tsp = TS.build_spectral(tp, tgeom.build_geometry(tp),
                                use_matmul_fft=mm, device="cpu")
        assert tsp.use_dense_legendre == (path == "dense")
        _cache[path] = (jp, jsp, tsp)
    return _cache[path]


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def random_spec(rng, jp, lead):
    """Real pair (2, *lead, mx, nx) inside the transform triangle."""
    m = np.arange(jp.mx)[:, None]
    n = np.arange(jp.nx)[None, :]
    tri = (m + n <= jp.trunc + 1).astype(float)
    return rng.standard_normal((2,) + lead + (jp.mx, jp.nx)) * tri


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("path", list(PATHS))
def test_transforms(path, batched):
    jp, jsp, tsp = transforms(path)
    rng = np.random.default_rng(11)
    lead = (3,) if path == "einsum" else (4,)
    nmem = 2

    if not batched:
        grid = rng.standard_normal(lead + (jp.il, jp.ix))
        spec = random_spec(rng, jp, lead)
        want_s = JS.grid2spec_p(jsp, jnp.asarray(grid))
        got_s = TS.grid2spec_p(tsp, torch.from_numpy(grid))
        assert rel_err(got_s, want_s) <= TOL
        for kcos in (1, 2):
            want_g = JS.spec2grid_p(jsp, jnp.asarray(spec), kcos)
            got_g = TS.spec2grid_p(tsp, torch.from_numpy(spec), kcos)
            assert rel_err(got_g, want_g) <= TOL
        return

    # Member axis in front, pair axis second: the layout jax.vmap gives.
    grid = rng.standard_normal((nmem,) + lead + (jp.il, jp.ix))
    spec = np.stack([random_spec(rng, jp, lead) for _ in range(nmem)])
    want_s = jax.vmap(lambda g: JS.grid2spec_p(jsp, g))(jnp.asarray(grid))
    got_s = TS.grid2spec_p(tsp, torch.from_numpy(grid), pdim=1)
    assert rel_err(got_s, want_s) <= TOL
    want_g = jax.vmap(lambda s: JS.spec2grid_p(jsp, s, 2))(jnp.asarray(spec))
    got_g = TS.spec2grid_p(tsp, torch.from_numpy(spec), 2, pdim=1)
    assert rel_err(got_g, want_g) <= TOL
    # A 2-D field (surface pressure) in the batched layout.
    want2 = jax.vmap(lambda g: JS.grid2spec_p(jsp, g))(jnp.asarray(grid[:, 0]))
    got2 = TS.grid2spec_p(tsp, torch.from_numpy(grid[:, 0]), pdim=1)
    assert rel_err(got2, want2) <= TOL


def test_m0_imaginary_part_is_dropped():
    """The reference discards the imaginary part of the m=0 coefficients:
    by the explicit mask on the fft path, by sin(0)=0 in the DFT operator on
    the matmul paths."""
    rng = np.random.default_rng(5)
    for path in ("fft", "dense"):
        jp, _, tsp = transforms(path)
        spec = random_spec(rng, jp, (2,))
        dirty = spec.copy()
        dirty[1, :, 0, :] += 3.0
        a = TS.spec2grid_p(tsp, torch.from_numpy(spec))
        b = TS.spec2grid_p(tsp, torch.from_numpy(dirty))
        assert rel_err(b, a) <= TOL, path


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("op", ["gradient_p", "vel2vort_p", "vort2vel_p"])
def test_pair_operators(op, batched):
    jp, jsp, tsp = transforms("fft")
    rng = np.random.default_rng(3)
    a = random_spec(rng, jp, (3,))
    b = random_spec(rng, jp, (3,))
    args = (a,) if op == "gradient_p" else (a, b)
    jfn, tfn = getattr(JS, op), getattr(TS, op)
    if batched:
        args = tuple(np.stack([x, 2.0 * x]) for x in args)
        want = jax.vmap(lambda *xs: jfn(jsp, *xs))(*map(jnp.asarray, args))
        got = tfn(tsp, *map(torch.from_numpy, args), pdim=1)
    else:
        want = jfn(jsp, *map(jnp.asarray, args))
        got = tfn(tsp, *map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= TOL


@pytest.mark.parametrize("op", ["truncate", "laplacian", "laplacian_inv"])
def test_pointwise_operators(op):
    jp, jsp, tsp = transforms("fft")
    x = random_spec(np.random.default_rng(9), jp, (2, 3))
    want = getattr(JS, op)(jsp, jnp.asarray(x))
    got = getattr(TS, op)(tsp, torch.from_numpy(x))
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("path", ["fft", "dense"])
def test_grid_filter(path):
    jp, jsp, tsp = transforms(path)
    g = np.random.default_rng(2).standard_normal((jp.il, jp.ix))
    assert rel_err(TS.grid_filter(tsp, torch.from_numpy(g)),
                   JS.grid_filter(jsp, jnp.asarray(g))) <= TOL


def test_float32_tables_round_like_jax():
    jp = dataclasses.replace(J_T30L8, precision="f32")
    tp = dataclasses.replace(T_T30L8, precision="f32")
    jsp = JS.build_spectral(jp, jgeom.build_geometry(jp), use_matmul_fft=True)
    tsp = TS.build_spectral(tp, tgeom.build_geometry(tp), use_matmul_fft=True,
                            device="cpu")
    assert tsp.rdtype == torch.float32
    assert np.array_equal(tsp.leg_dir_dense.numpy(),
                          np.asarray(jsp.leg_dir_dense))
    assert np.array_equal(tsp.dft_inv_ri.numpy(), np.asarray(jsp.dft_inv_ri))
