"""The T47L8 and T63L8 presets of ``pyspeedy_tpu_torch`` against the JAX
package, in float64 on the CPU: the demo model's initialization from the
synthetic boundary conditions, a few full-physics batched steps, and the
plain versions of the three kernels these presets run (kernel table rows 1,
2 and 6: the grid dynamics, the column physics, the spectral update) at
their shapes, 72 x 144 and 96 x 192 with (mx, nx) = (48, 49) and (64, 65).
Both presets take the einsum transform route in both packages.

JAX is imported inside the tests that use it, so that on the card
``python -m pytest tests/test_torch_presets.py -m gpu`` runs the
gpu-marked test, which holds the three CUDA kernels against their plain
versions at both presets, without JAX.

Tolerances are relative to each field's largest absolute value: 1e-12 for
one function, 1e-10 after a few steps (rounding at 1e-16 in the order of
sums, which the physics and the leapfrog amplify).
"""

import dataclasses

import numpy as np
import pytest
import torch

import pyspeedy_tpu_torch.params as tparams
from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models import spectral_glue as TG
from pyspeedy_tpu_torch.models.tendencies import grid_dynamics_core
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import glue_kernels as GK
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.testing import make_demo_model

# One thread for PyTorch's CPU kernels: several test processes side by side
# would fight for the cores.
torch.set_num_threads(1)

PRESETS = ["T47L8", "T63L8"]
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
NMEM = 2
_cache = {}


def jax_model(preset):
    """(consts, state, calendar) of the JAX package's full-physics demo
    model at the preset, built once."""
    key = ("jax", preset)
    if key not in _cache:
        import pyspeedy_tpu.params as jparams
        from pyspeedy_tpu.testing import make_demo_model as j_make_demo_model
        _cache[key] = j_make_demo_model(getattr(jparams, preset))
    return _cache[key]


def torch_model(preset):
    key = ("torch", preset)
    if key not in _cache:
        _cache[key] = make_demo_model(getattr(tparams, preset), device="cpu")
    return _cache[key]


def to_numpy(jstate):
    import jax
    return jax.tree.map(np.asarray, jstate)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


def spectral_noise(params, seed):
    """0.01 K of seeded temperature noise inside the truncation triangle,
    real at m = 0: (2, kx, mx, nx)."""
    rng = np.random.default_rng(seed)
    tri = (np.arange(params.mx)[:, None] + np.arange(params.nx)[None, :]
           <= params.trunc).astype(float)
    noise = 1e-2 * rng.standard_normal((2, params.kx, params.mx,
                                        params.nx)) * tri
    noise[1, :, 0, :] = 0.0
    return noise


def grid_inputs(params, nmem, seed, device="cpu"):
    """Seeded member-batched grid fields of plausible magnitude: the
    arguments of the grid dynamics."""
    rng = np.random.default_rng(seed)
    kx, il, ix, ntr = params.kx, params.il, params.ix, params.ntr
    mk = lambda k, scale, mean=0.0: torch.from_numpy(
        mean + scale * rng.standard_normal((nmem, k, il, ix))).to(
        device, params.dtype)
    return (mk(kx, 3e-5), mk(kx, 1e-5), mk(kx, 15.0, 250.0),
            mk(ntr * kx, 2.0, 5.0), mk(kx, 15.0), mk(kx, 10.0), mk(2, 2e-8))


def update_inputs(params, nmem, seed, device="cpu"):
    """Seeded arguments of the spectral update at the preset's shapes: the
    6 + 3*ntr flux spectra, then psdt and the state."""
    kx, mx, nx, ntr = params.kx, params.mx, params.nx, params.ntr
    rng = np.random.default_rng(seed)
    mk = lambda shape, scale: torch.from_numpy(
        scale * rng.standard_normal((nmem,) + shape)).to(device, params.dtype)
    lev, plane, trac = (2, kx, mx, nx), (2, mx, nx), (2, ntr * kx, mx, nx)
    specs = [mk(lev, 1e-5) for _ in range(6 + 3 * ntr)]
    state = [mk(plane, 1e-5), mk(lev, 1e-5), mk(lev, 1e-5), mk(lev, 1e-6),
             mk(lev, 1e-6), mk(lev, 10.0), mk(lev, 10.0), mk(plane, 1e-2),
             mk(plane, 1e-2), mk(trac, 1e-3), mk(trac, 1e-3), mk(lev, 1e3),
             mk(plane, 1.0), mk(plane, 1e-3)]
    return specs, state


@pytest.mark.parametrize("preset", PRESETS)
def test_initialization_matches_jax(preset):
    """make_demo_model: the synthetic boundary conditions, the rest state
    and both bootstrap steps with the full physics. Prognostics, the
    geopotential and what the physics wrote, limit 1e-10."""
    _, jstate, _ = jax_model(preset)
    tconsts, tstate, _ = torch_model(preset)
    p = tconsts.params
    assert (p.il, p.ix, p.mx, p.nx) == {"T47L8": (72, 144, 48, 49),
                                        "T63L8": (96, 192, 64, 65)}[preset]
    assert not tconsts.sp.use_dense_legendre     # the einsum route
    jnp_state = to_numpy(jstate)
    for name in PROGNOSTICS:
        for lev in range(2):
            err = rel_err(tstate[name][lev].numpy(), jnp_state[name][lev])
            assert err <= 1e-10, (name, lev, err)
    for name in ("phi", "precnv", "precls", "tsr", "olr", "hfluxn",
                 "land_temp", "sst_om"):
        assert rel_err(tstate[name].numpy(), jnp_state[name]) <= 1e-10, name


@pytest.mark.parametrize("preset", PRESETS)
def test_batched_steps_match_jax(preset):
    """3 full-physics steps of the batched runner from step 2 (shortwave on
    step 3), B=2 with member 1 perturbed in t, against the JAX batched
    runner. Limit 1e-10 on the prognostics and the physics diagnostics."""
    from pyspeedy_tpu.models import model as JM
    from pyspeedy_tpu.parallel import ensemble as JE

    jconsts, jstate, jcal = jax_model(preset)
    tconsts, _, tcal = torch_model(preset)
    n_steps = 3
    noise = np.stack([np.zeros_like(spectral_noise(tconsts.params, 9)),
                      spectral_noise(tconsts.params, 9)])
    jb = JE.broadcast_state(jstate, NMEM)
    jb["t"] = (jb["t"][0] + noise, jb["t"][1] + noise)
    ctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), 2, n_steps)
    jout = to_numpy(JE.make_run_steps_batched(jconsts, phase=2)(jb, ctx))

    tb = TE.broadcast_state(interop.state_from_numpy(
        to_numpy(jstate), device="cpu", dtype=torch.float64), NMEM)
    tnoise = torch.from_numpy(noise)
    tb["t"] = (tb["t"][0] + tnoise, tb["t"][1] + tnoise)
    tctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, n_steps)
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(tb, tctx)

    assert not bool(tout["error_flag"].any())
    for name in PROGNOSTICS:
        for lev in range(2):
            err = rel_err(tout[name][lev].numpy(), jout[name][lev])
            assert err <= 1e-10, (name, lev, err)
    for name in ("phi", "precnv", "precls", "tsr", "olr", "hfluxn"):
        assert rel_err(tout[name].numpy(), jout[name]) <= 1e-10, name
    t0 = tout["t"][0]
    assert float((t0[1] - t0[0]).abs().max()) > 1e-4


@pytest.mark.parametrize("preset", PRESETS)
def test_grid_dynamics_plain_matches_jax(preset):
    """Row 1's plain version against JAX's grid_dynamics_core under vmap,
    on seeded fields at the preset's grid. Limit 1e-12."""
    import jax
    import jax.numpy as jnp
    from pyspeedy_tpu.models.tendencies import grid_dynamics_core as j_core

    jconsts, _, _ = jax_model(preset)
    tconsts, _, _ = torch_model(preset)
    p = tconsts.params
    args = grid_inputs(p, 3, seed=4)
    shape = (p.il, p.ix)
    rcos2d = jnp.broadcast_to(jnp.asarray(jconsts.sp.cosgr)[:, None], shape)
    coriol2d = jnp.broadcast_to(jnp.asarray(jconsts.geom.coriol)[:, None],
                                shape)
    want = jax.vmap(lambda *a: j_core(jconsts, *a, rcos2d, coriol2d))(
        *(jnp.asarray(a.numpy()) for a in args))
    got = grid_dynamics_core(tconsts.col, *args)
    for n, (g, w) in enumerate(zip(got, want)):
        assert rel_err(g.numpy(), w) <= 1e-12, n


@pytest.mark.parametrize("sw_flag", [True, False])
@pytest.mark.parametrize("preset", PRESETS)
def test_physics_plain_matches_jax(preset, sw_flag):
    """Row 2's plain version against JAX's grid_physics on the demo
    model's own columns at the preset (the geopotential read from the
    grid), both shortwave variants: the tendencies, the diagnostics and the
    radiation cache. Limit 1e-12."""
    import jax
    from pyspeedy_tpu.ops import spectral as JS
    from pyspeedy_tpu.physics import driver as JD

    jconsts, jstate, _ = jax_model(preset)
    tconsts, _, _ = torch_model(preset)
    sp = jconsts.sp
    g = lambda f, kcos=1: JS.spec2grid_p(sp, f, kcos)
    ucos, vcos = JS.vort2vel_p(sp, jstate["vor"][0], jstate["div"][0])
    # Humidity raised by a third, so that convection and large-scale
    # condensation fire in the freshly initialized columns.
    grids = (g(ucos, 2), g(vcos, 2), g(jstate["t"][0]),
             1.35 * g(jstate["tr"][0][:, 0]), g(jstate["phi"]),
             g(jstate["ps"][0]))
    bc = tuple(jstate[n] for n in JD.BC_FIELDS)
    cache = () if sw_flag else tuple(jstate[n] for n in JD.CACHE_FIELDS)
    want = JD.grid_physics(jconsts, sw_flag, *grids, bc, cache,
                           jstate["air_absortivity_co2"])
    want = [np.asarray(x) for x in jax.tree.leaves(want)]

    T = lambda x: torch.from_numpy(np.array(x))[None]
    targs = (*(T(x) for x in grids),
             tuple(torch.from_numpy(np.array(x)) for x in bc),
             tuple(T(x) for x in cache),
             torch.from_numpy(np.array(jstate["air_absortivity_co2"])))
    got = TD.grid_physics(tconsts, sw_flag, *targs)
    got = list(got[:4]) + list(got[4]) + list(got[5])
    assert len(got) == len(want)
    for n, (a, b) in enumerate(zip(got, want)):
        assert rel_err(a[0].numpy(), b) <= 1e-12, n
    assert 0.01 < (want[4] > 0).mean() < 0.9                 # cbmf


@pytest.mark.parametrize("preset", PRESETS)
def test_spectral_update_plain_matches_jax(preset):
    """Row 6's plain version against JAX's spectral_update under vmap, on
    seeded inputs at the preset's (mx, nx), the leapfrog step (j1 = 2, dt =
    2 delt): all ten outputs. Limit 1e-12."""
    import jax
    from pyspeedy_tpu.models.spectral_glue import spectral_update as j_update

    jconsts, _, _ = jax_model(preset)
    tconsts, _, _ = torch_model(preset)
    p = tconsts.params
    specs, state = update_inputs(p, 3, seed=6)
    dt, eps = 2.0 * p.delt, p.rob
    want = jax.jit(jax.vmap(lambda sp, *st: j_update(
        jconsts, 2, dt, eps, False, list(sp), *st)))(
        [x.numpy() for x in specs], *(x.numpy() for x in state))
    got = TG.spectral_update(tconsts, 2, dt, eps, specs, *state)
    for n, (g, w) in enumerate(zip(got, want)):
        assert rel_err(g.numpy(), w) <= 1e-12, n


@pytest.mark.gpu
@pytest.mark.parametrize("preset", PRESETS)
def test_kernels_match_their_plain_versions_at_the_preset_on_the_card(
        preset):
    """Rows 1, 2 and 6 on the card at the preset's shapes, float64, against
    their plain versions: the grid dynamics and the spectral update on
    seeded inputs (B=4), the physics (both variants, grid_phi mode) on the
    demo model's own state, which the card initialized through all three
    kernels. Limit 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    params = getattr(tparams, preset)
    consts, state, _ = make_demo_model(params, device="cuda")
    err = lambda a, b: float((a - b).abs().max() / b.abs().max())

    args = grid_inputs(params, 4, seed=7, device="cuda")
    for a, b in zip(ck.grid_dynamics_cuda(consts.col, *args),
                    grid_dynamics_core(consts.col, *args)):
        assert err(a, b) <= 1e-12

    specs, st = update_inputs(params, 4, seed=8, device="cuda")
    dt, eps = 2.0 * params.delt, params.rob
    got = GK.spectral_update_cuda(consts, 2, dt, eps, specs, *st)
    want = TG.spectral_update_plain(consts, 2, dt, eps, specs, *st)
    for a, b in zip(got, want):
        assert err(a, b) <= 1e-12

    batched = TE.broadcast_state(state, 2)
    batched = TM.ensure_member_axis(batched, 2)
    for sw_flag in (True, False):
        pargs, kw = TD.physics_grid_inputs(consts, batched, sw_flag)
        got = ck.grid_physics_cuda(consts, sw_flag, *pargs, **kw)
        want = TD.grid_physics(consts, sw_flag, *pargs, **kw)
        flat = lambda r: list(r[:4]) + list(r[4]) + list(r[5])
        for a, b in zip(flat(got), flat(want)):
            assert float((a - b).abs().max()) <= 1e-12 * max(
                float(b.abs().max()), 1e-300)
