"""The explicit gravity-wave branch (``alph < 0.5``) of ``pyspeedy_tpu_torch``
against the JAX package, in float64 on the CPU: the tendency functions, one
step, the initialization and a batched run with the full physics.

The configuration is T30L8 with ``alph=0.0`` and ``nsteps=144`` (dt = 600
s): without the semi-implicit correction the gravity waves bound the step;
108 steps a day blow up within the first model day, 144 stay finite with
the error flag clear (the last test).

Tolerances are relative to each field's largest absolute value. Both packages
run the same formulation; what differs is the order of sums inside FFTs,
matrix products and level sums, i.e. rounding at 1e-16.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models import tendencies as TT
from pyspeedy_tpu_torch.models import timestep as TS
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.testing import make_demo_model

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side would fight for the cores.
torch.set_num_threads(1)

EXPLICIT = dict(alph=0.0, nsteps=144)
T_PARAMS = dataclasses.replace(T_T30L8, **EXPLICIT)
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
NMEM = 2
_cache = {}


def jx():
    """The JAX package's modules, imported at first use: the card's
    machine has no JAX, and there ``python -m pytest
    tests/test_torch_explicit.py -m gpu`` runs the gpu-marked test alone."""
    if "jx" not in _cache:
        import jax
        from pyspeedy_tpu.models import model as JM
        from pyspeedy_tpu.models import tendencies as JT
        from pyspeedy_tpu.models import timestep as JS
        from pyspeedy_tpu.params import T30L8
        from pyspeedy_tpu.physics import driver as JD
        from pyspeedy_tpu.testing import make_demo_model
        _cache["jx"] = types.SimpleNamespace(
            jax=jax, JM=JM, JT=JT, JS=JS, JD=JD,
            make_demo_model=make_demo_model,
            params=dataclasses.replace(T30L8, **EXPLICIT))
    return _cache["jx"]


def jax_model():
    """(consts, state, calendar) of the JAX package's full-physics explicit
    model; its initialization runs both bootstrap steps through the
    explicit branch. Built once."""
    if "jax" not in _cache:
        _cache["jax"] = jx().make_demo_model(jx().params)
    return _cache["jax"]


def torch_model():
    if "torch" not in _cache:
        _cache["torch"] = make_demo_model(T_PARAMS, device="cpu")
    return _cache["torch"]


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


def member_states():
    """The JAX initial state and a copy with the temperature perturbed
    (seeded, 0.01 K inside the truncation triangle), as two single-member
    numpy states; and both as one B=2 state of the port."""
    if "members" not in _cache:
        _, jstate, _ = jax_model()
        p = T_PARAMS
        rng = np.random.default_rng(11)
        tri = (np.arange(p.mx)[:, None] + np.arange(p.nx)[None, :]
               <= p.trunc).astype(float)
        noise = 1e-2 * rng.standard_normal((2, p.kx, p.mx, p.nx)) * tri
        noise[1, :, 0, :] = 0.0        # m = 0 coefficients are real
        s0 = jx().jax.tree.map(np.asarray, jstate)
        s1 = dict(s0)
        s1["t"] = (s0["t"][0] + noise, s0["t"][1] + noise)
        tb = TE.broadcast_state(interop.state_from_numpy(
            s0, device="cpu", dtype=torch.float64), NMEM)
        tnoise = torch.zeros((NMEM,) + noise.shape, dtype=torch.float64)
        tnoise[1] = torch.from_numpy(noise)
        tb["t"] = (tb["t"][0] + tnoise, tb["t"][1] + tnoise)
        _cache["members"] = ([s0, s1], tb)
    return _cache["members"]


def jax_members(fn):
    """fn applied to each member's single-member JAX state (as jax arrays)."""
    jstates, _ = member_states()
    jax = jx().jax
    return [fn(jax.tree.map(jax.numpy.asarray, s)) for s in jstates]


def assert_members_close(tout, jouts, tol):
    """Each tensor of the port's tuple `tout` (member axis in front) against
    the same entry of each member's JAX tuple."""
    for m, jout in enumerate(jouts):
        for n, (t, j) in enumerate(zip(tout, jout)):
            err = rel_err(t[m].numpy(), np.asarray(j))
            assert err <= tol, (m, n, err)


@pytest.mark.parametrize("j2", [0, 1])
def test_grid_point_tendencies_match_jax(j2):
    """get_grid_point_tendencies at time level j2, dynamics only: the five
    tendencies (tracers (B, 2, ntr, kx, mx, nx), as JAX's behind the member
    axis). Limit 1e-12."""
    jconsts, _, _ = jax_model()
    tconsts, _, _ = torch_model()
    _, tb = member_states()
    tout = TT.get_grid_point_tendencies(tconsts, tb, j2)
    jouts = jax_members(
        lambda s: jx().JT.get_grid_point_tendencies(jconsts, s, j2)[:5])
    p = T_PARAMS
    assert tout[4].shape == (NMEM, 2, p.ntr, p.kx, p.mx, p.nx)
    assert_members_close(tout[:5], jouts, 1e-12)


@pytest.mark.parametrize("j2", [0, 1])
def test_spectral_tendencies_match_jax(j2):
    """get_spectral_tendencies at time level j2 on seeded tendencies: the
    linear terms, and the geopotential of level j2 it writes into the
    state. Limit 1e-12."""
    jconsts, _, _ = jax_model()
    tconsts, _, _ = torch_model()
    _, tb = member_states()
    p = T_PARAMS
    rng = np.random.default_rng(5 + j2)
    divdt = 1e-10 * rng.standard_normal((NMEM, 2, p.kx, p.mx, p.nx))
    tdt = 1e-5 * rng.standard_normal((NMEM, 2, p.kx, p.mx, p.nx))
    psdt = 1e-9 * rng.standard_normal((NMEM, 2, p.mx, p.nx))
    T = torch.from_numpy
    tout = TT.get_spectral_tendencies(tconsts, tb, T(divdt), T(tdt),
                                      T(psdt), j2)
    jstates, _ = member_states()
    jouts = []
    for m, s in enumerate(jstates):
        s = jx().jax.tree.map(jx().jax.numpy.asarray, s)
        d, t, ps_, st = jx().JT.get_spectral_tendencies(
            jconsts, s, divdt[m], tdt[m], psdt[m], j2)
        jouts.append((d, t, ps_, st["phi"]))
    assert_members_close((*tout[:3], tout[3]["phi"]), jouts, 1e-12)
    # phi from level j2, not level 0, when j2 = 1.
    other = TT.get_spectral_tendencies(tconsts, tb, T(divdt), T(tdt),
                                       T(psdt), 1 - j2)[3]["phi"]
    assert not torch.equal(other, tout[3]["phi"])


@pytest.mark.parametrize("alph", [0.0, 0.5])
def test_get_tendencies_matches_jax(alph):
    """get_tendencies with the physics, on a shortwave step: the explicit
    branch (linear terms at level j2 = 1) and, for comparison, the
    semi-implicit one (level 0 and the implicit correction, with the
    explicit model's implicit tables in both packages). Limit 1e-12."""
    jconsts, _, _ = jax_model()
    tconsts, _, _ = torch_model()
    jconsts = dataclasses.replace(
        jconsts, params=dataclasses.replace(jconsts.params, alph=alph))
    tconsts = dataclasses.replace(
        tconsts, params=dataclasses.replace(tconsts.params, alph=alph))
    _, tb = member_states()
    ctx = {"compute_shortwave": True, "stepno": 3}
    tout = TT.get_tendencies(tconsts, tb, 1, TD.get_physical_tendencies, ctx)
    jouts = jax_members(lambda s: jx().JT.get_tendencies(
        jconsts, s, 1, jx().JD.get_physical_tendencies, ctx)[:5])
    assert_members_close(tout[:5], jouts, 1e-12)


@pytest.mark.parametrize("j1", [1, 2])
def test_one_explicit_step_matches_jax(j1):
    """One step of the explicit branch with the physics (j1 = 1: the
    forward half of the start-up, j1 = 2: the filtered leapfrog), both time
    levels of every prognostic. Limit 1e-12."""
    jconsts, _, _ = jax_model()
    tconsts, _, _ = torch_model()
    _, tb = member_states()
    dt = (1.0 if j1 == 1 else 2.0) * T_PARAMS.delt
    ctx = {"compute_shortwave": False, "stepno": 4}
    tout = TS.step(tconsts, tb, j1, 2, dt, TD.get_physical_tendencies, ctx)
    jouts = jax_members(lambda s: jx().JS.step(
        jconsts, s, j1, 2, dt, jx().JD.get_physical_tendencies, ctx))
    for m, jout in enumerate(jouts):
        for name in PROGNOSTICS:
            for lev in range(2):
                err = rel_err(tout[name][lev][m].numpy(),
                              np.asarray(jout[name][lev]))
                assert err <= 1e-12, (m, name, lev, err)
        assert rel_err(tout["phi"][m].numpy(), np.asarray(jout["phi"])) \
            <= 1e-12


def test_initialization_matches_jax():
    """initialize: both bootstrap steps (dt/2 and dt) through the explicit
    branch with the physics. Every prognostic and the geopotential, limit
    1e-10."""
    _, jstate, _ = jax_model()
    tconsts, tstate, _ = torch_model()
    assert tconsts.params.alph == 0.0
    jnp_state = jx().jax.tree.map(np.asarray, jstate)
    for name in PROGNOSTICS:
        for lev in range(2):
            assert rel_err(tstate[name][lev].numpy(),
                           jnp_state[name][lev]) <= 1e-10, name
    assert rel_err(tstate["phi"].numpy(), jnp_state["phi"]) <= 1e-10


def test_six_batched_steps_match_jax():
    """6 steps of the batched runner from step 2, B=2 (member 1 a copy),
    with the physics (shortwave on steps 3 and 6), against the JAX
    single-member integrator make_run_steps. Limit 1e-10 on the prognostics
    and on what the physics writes; finite, error flag clear."""
    jconsts, jstate, jcal = jax_model()
    tconsts, _, tcal = torch_model()
    n_steps = 6
    J = jx()
    ctx, _ = J.JM.build_step_ctx(dataclasses.replace(jcal), 2, n_steps)
    jout = J.jax.tree.map(np.asarray,
                          J.JM.make_run_steps(jconsts)(jstate, ctx))
    tctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, n_steps)
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(
        TE.broadcast_state(interop.state_from_numpy(
            J.jax.tree.map(np.asarray, jstate), device="cpu",
            dtype=torch.float64), NMEM), tctx)
    assert not bool(tout["error_flag"].any())
    names = [(n, lev) for n in PROGNOSTICS for lev in range(2)]
    for m in range(NMEM):
        for name, lev in names:
            err = rel_err(tout[name][lev][m].numpy(), jout[name][lev])
            assert err <= 1e-10, (m, name, lev, err)
        for name in ("phi", "precnv", "precls", "tsr", "olr", "hfluxn"):
            err = rel_err(tout[name][m].numpy(), jout[name])
            assert err <= 1e-10, (m, name, err)
    assert all(bool(torch.isfinite(tout[n][0]).all()) for n in PROGNOSTICS)


def test_a_member_alone_equals_that_member_of_a_batch(monkeypatch):
    """The explicit branch's own arithmetic (the linear terms with their
    level sum, diffusion, drag, leapfrog) gives member 1 of a batch of 3
    (distinct members) the same bits as member 1 stepped alone, from the
    same grid-point tendencies, j1 = 1 and 2. The grid-point tendencies
    come from the batch of 3 and are sliced for the member alone: on the
    CPU the library's matrix products of the transforms may round
    differently at another batch width (about 1e-21 of ps after four
    steps), which no part of this branch can undo; on the card the fused
    transform and column kernels are batch-independent by design, and
    chip_smoke.py holds a whole run of B=1 against B=8 bitwise."""
    tconsts, _, _ = torch_model()
    _, tb = member_states()
    carried = lambda k, v, f: (tuple(f(a) for a in v) if isinstance(v, tuple)
                               else f(v)) if k in TM.CARRY_FIELDS else v
    three = {k: carried(k, v, lambda a: torch.cat([a, a[1:]]))
             for k, v in tb.items()}
    alone = {k: carried(k, v, lambda a: a[1:2]) for k, v in tb.items()}
    ctx = {"compute_shortwave": True, "stepno": 3}
    grid3 = TT.get_grid_point_tendencies(tconsts, three, 1,
                                         TD.get_physical_tendencies, ctx)

    def fixed(consts, state, j2, physics_fn=None, ctx=None):
        nmem = state["vor"][0].shape[0]
        pick = (lambda a: a) if nmem == 3 else (lambda a: a[1:2])
        st = {k: carried(k, v, lambda a: a) for k, v in state.items()}
        for name in ("phi",) + TD.CACHE_FIELDS + TD.DIAG_FIELDS:
            st[name] = pick(grid3[5][name])
        return tuple(pick(x) for x in grid3[:5]) + (st,)

    monkeypatch.setattr(TT, "get_grid_point_tendencies", fixed)
    for j1, f in ((1, 1.0), (2, 2.0)):
        dt = f * T_PARAMS.delt
        out3 = TS.step(tconsts, three, j1, 2, dt)
        out1 = TS.step(tconsts, alone, j1, 2, dt)
        for name in PROGNOSTICS:
            for lev in range(2):
                assert torch.equal(out3[name][lev][1:2], out1[name][lev]), \
                    (j1, name, lev)
        assert torch.equal(out3["phi"][1:2], out1["phi"])
        t = out3["t"][0]
        assert float((t[1] - t[0]).abs().max()) > 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_a_member_does_not_depend_on_the_batch_on_the_card(precision):
    """On the card: the linear terms of the explicit branch (their level
    sum was a matrix product, whose cuBLAS algorithm may follow the number
    of members) of each member alone against the same member in a batch of
    8, and 6 steps of the explicit model with the physics (T30, the fused
    transforms and the column kernels) of member 3 alone against member 3
    of 8 distinct members: bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    params = dataclasses.replace(T_PARAMS, precision=precision,
                                 fft_mode="matmul")
    consts, state1, cal = make_demo_model(params, device="cuda")
    rng = np.random.default_rng(2)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(
        (8,) + shape)).to("cuda", params.dtype)
    p = params
    div, phi = mk(2, p.kx, p.mx, p.nx), 1e3 * mk(2, p.kx, p.mx, p.nx)
    ps, psdt = mk(2, p.mx, p.nx), mk(2, p.mx, p.nx)
    divdt, tdt = mk(2, p.kx, p.mx, p.nx), mk(2, p.kx, p.mx, p.nx)
    args = (div, ps, phi, divdt, tdt, psdt)
    together = TT.spectral_linear_tendencies(consts, *args)
    for m in range(8):
        alone = TT.spectral_linear_tendencies(
            consts, *(x[m:m + 1] for x in args))
        assert all(torch.equal(a[m:m + 1], b)
                   for a, b in zip(together, alone)), m

    b8 = TE.broadcast_state(state1, 8)
    noise = 1e-2 * mk(2, p.kx, p.mx, p.nx)
    noise[:, 1, :, 0, :] = 0.0
    b8["t"] = (b8["t"][0] + noise, b8["t"][1] + noise)
    carried = lambda k, v: (tuple(a[3:4] for a in v) if isinstance(v, tuple)
                            else v[3:4]) if k in TM.CARRY_FIELDS else v
    one = {k: carried(k, v) for k, v in b8.items()}
    run = TE.make_run_steps_batched(consts, device="cuda")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 6)
    out8, out1 = run(b8, ctx), run(one, ctx)
    for name in PROGNOSTICS:
        for lev in range(2):
            assert torch.equal(out8[name][lev][3:4], out1[name][lev]), name


@pytest.mark.parametrize("nsteps,stable", [(108, False), (144, True)])
def test_the_explicit_step_is_bounded_by_the_gravity_waves(nsteps, stable):
    """Without the semi-implicit correction the gravity waves bound the
    time step: from the demo state, a model day of the explicit T30 model
    in float32 at 108 steps a day (dt = 800 s) trips the error flag with
    non-finite values, at 144 (dt = 600 s) it stays finite with the flag
    clear. The explicit runs of this package use 144."""
    params = dataclasses.replace(T_PARAMS, precision="f32", fft_mode="matmul",
                                 nsteps=nsteps)
    consts, state, cal = make_demo_model(params, device="cpu")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, nsteps)
    out = TE.make_run_steps_batched(consts, device="cpu")(
        TE.broadcast_state(state, 1), ctx)
    finite = all(bool(torch.isfinite(a).all())
                 for name in PROGNOSTICS for a in out[name])
    assert finite == stable
    assert bool(out["error_flag"].any()) != stable
