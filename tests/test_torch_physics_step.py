"""The full-physics model of ``pyspeedy_tpu_torch`` against the JAX package, in
float64 on the CPU (where the port's kernel dispatch takes the plain PyTorch
versions): the physics driver, initialization, the batched runner for every
phase of the shortwave cadence, the daily forcing, grid_phi, the coupler.

Tolerances are relative to each field's largest absolute value. Both packages
run the same formulation; what differs is the order of sums (matrix products,
FFTs, level and band sums), i.e. rounding at 1e-16 per operation, which the
physics amplifies where it differences nearly equal numbers (precipitation,
surface fluxes: up to 1e-13 after one step) and the leapfrog carries along.

The JAX side compiles slowly with the physics on, so each jitted integrator is
built once per file and reused (one per run length).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.parallel import ensemble as JE
from pyspeedy_tpu.params import T30L8 as J_T30L8
from pyspeedy_tpu.physics import driver as JD
from pyspeedy_tpu.testing import make_demo_model as j_make_demo_model
from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.coupling.coupler import couple_sea_land
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models.geopotential import (get_geopotential,
                                                    get_geopotential_grid,
                                                    hydrostatic_m0corr)
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.testing import make_demo_model

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
_cache = {}


def jax_model():
    """(consts, state, calendar) of the JAX package's full-physics demo
    model: both bootstrap steps run the physics with shortwave."""
    if "jax" not in _cache:
        _cache["jax"] = j_make_demo_model(J_T30L8)
    return _cache["jax"]


def torch_model():
    if "torch" not in _cache:
        _cache["torch"] = make_demo_model(T_T30L8, device="cpu")
    return _cache["torch"]


def jax_run(n_steps):
    """The JAX single-member integrator for n_steps (traced shortwave flag),
    compiled once."""
    key = ("jrun", n_steps)
    if key not in _cache:
        _cache[key] = JM.make_run_steps(jax_model()[0])
    return _cache[key]


def to_torch(jstate):
    return interop.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                    device="cpu", dtype=torch.float64)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


def compare_states(tstate, jstate, tol, names=None, member=None):
    """Every floating field of the JAX state (or `names`) against the port's,
    optionally one member of a batched port state against a single-member
    JAX state."""
    tnp = interop.state_to_numpy(tstate)
    jnp_state = jax.tree.map(np.asarray, jstate)
    checked = 0
    for name, want in jnp_state.items():
        if names is not None and name not in names:
            continue
        if name in ("sppt_key", "sppt_spec"):
            continue
        got = tnp[name]
        pairs = list(zip(got, want)) if isinstance(want, tuple) else \
            [(got, want)]
        for g, w in pairs:
            if member is not None and (name in TM.DYNAMIC_FIELDS):
                g = g[member]
            if w.dtype.kind == "f":
                err = rel_err(g, w)
                assert err <= tol, (name, err)
            else:
                assert np.array_equal(g, w), name
            checked += 1
    return checked


def perturbation(nmem, seed=7):
    """Seeded noise (numpy) for the temperature of each member, 0.01 K in
    spectral amplitude inside the truncation triangle; member 0 unperturbed."""
    p = J_T30L8
    rng = np.random.default_rng(seed)
    m = np.arange(p.mx)[:, None]
    n = np.arange(p.nx)[None, :]
    tri = (m + n <= p.trunc).astype(float)
    noise = 1e-2 * rng.standard_normal((nmem, 2, p.kx, p.mx, p.nx)) * tri
    noise[0] = 0.0
    noise[:, 1, :, 0, :] = 0.0     # m = 0 coefficients are real
    return noise


def test_physics_is_the_default_as_in_jax():
    tconsts, _, _ = torch_model()
    jconsts, _, _ = jax_model()
    assert tconsts.physics_on and jconsts.physics_on
    assert not tconsts.grid_phi and not jconsts.grid_phi   # off on the CPU
    assert TD.BC_FIELDS == JD.BC_FIELDS
    assert TD.CACHE_FIELDS == JD.CACHE_FIELDS
    assert TD.DIAG_FIELDS == JD.DIAG_FIELDS
    import inspect
    assert inspect.signature(TM.build_consts).parameters[
        "physics_on"].default is True
    assert inspect.signature(make_demo_model).parameters[
        "physics_on"].default is True


def test_initialization_with_physics_matches_jax():
    """build_consts + initialize from the synthetic boundary conditions, both
    bootstrap steps with physics and shortwave: every state field (the
    radiation cache and the per-step diagnostics included), limit 1e-10."""
    _, jstate, _ = jax_model()
    _, tstate, _ = torch_model()
    assert set(jax.tree.map(np.asarray, jstate)) == set(tstate)
    assert compare_states(tstate, jstate, 1e-10) > 100
    for name in TD.CACHE_FIELDS + TD.DIAG_FIELDS:
        assert tstate[name].shape == tuple(np.shape(jstate[name])), name
    assert float(tstate["tsr"].abs().max()) > 100.0     # shortwave ran
    assert float(tstate["hfluxn"].abs().max()) > 1.0


@pytest.mark.parametrize("sw_flag", [True, False])
def test_get_physical_tendencies_matches_jax(sw_flag):
    """The state-dict glue on the demo state: tendencies added to seeded
    dynamics tendencies, and the state it writes. Limit 1e-12."""
    jconsts, jstate, _ = jax_model()
    tconsts, _, _ = torch_model()
    p = J_T30L8
    rng = np.random.default_rng(3)
    dyn = [1e-4 * rng.standard_normal((p.kx, p.il, p.ix)) for _ in range(3)]
    trt = 1e-6 * rng.standard_normal((p.ntr, p.kx, p.il, p.ix))
    jout = JD.get_physical_tendencies(
        jconsts, jstate, {"compute_shortwave": sw_flag, "stepno": 2},
        *map(jax.numpy.asarray, dyn), jax.numpy.asarray(trt))
    tstate = TE.broadcast_state(to_torch(jstate), 1)
    T = lambda a: torch.from_numpy(a)[None]
    tout = TD.get_physical_tendencies(
        tconsts, tstate, {"compute_shortwave": sw_flag, "stepno": 2},
        *map(T, dyn), T(trt.reshape(p.ntr * p.kx, p.il, p.ix)))
    for n in range(3):
        assert rel_err(tout[n][0].numpy(), jout[n]) <= 1e-12, n
    assert rel_err(tout[3][0].numpy().reshape(trt.shape), jout[3]) <= 1e-12
    names = set(TD.CACHE_FIELDS + TD.DIAG_FIELDS)
    assert compare_states(tout[4], jout[4], 1e-12, names, member=0) == 21
    for name in names:
        assert tout[4][name].shape[0] == 1, name      # member-batched


def test_six_batched_steps_match_jax():
    """From the JAX state carried over by interop: 6 steps of the batched
    runner from step 2 (shortwave on steps 3 and 6), B=2, member 1 perturbed
    in t, against the JAX batched runner with phase = 2 % 3. Limit 1e-9 on
    the prognostics and on everything the physics and the coupler write."""
    nmem, n_steps = 2, 6
    jconsts, jstate, jcal = jax_model()
    tconsts, _, tcal = torch_model()
    noise = perturbation(nmem)

    jb = JE.broadcast_state(jstate, nmem)
    jb["t"] = (jb["t"][0] + noise, jb["t"][1] + noise)
    ctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), 2, n_steps)
    assert list(np.asarray(ctx["compute_shortwave"])) == [
        False, True, False, False, True, False]
    jout = JE.make_run_steps_batched(jconsts, phase=2 % 3)(jb, ctx)

    tb = TE.broadcast_state(to_torch(jstate), nmem)
    tnoise = torch.from_numpy(noise)
    tb["t"] = (tb["t"][0] + tnoise, tb["t"][1] + tnoise)
    tctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, n_steps)
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(tb, tctx)

    assert not bool(tout["error_flag"].any())
    names = set(PROGNOSTICS) | set(TD.CACHE_FIELDS) | set(TD.DIAG_FIELDS) | {
        "phi", "land_temp", "stl_lm", "sst_om", "tice_om", "sst_am",
        "ssti_om"}
    assert compare_states(tout, jout, 1e-9, names) >= len(names)
    # Ephemerals came in shared and come back member-batched and current.
    for name in TM.EPHEMERAL_FIELDS:
        assert tout[name].shape[0] == nmem, name
        assert tout[name].shape == tuple(np.shape(jout[name])), name
    t0 = tout["t"][0]
    assert float((t0[1] - t0[0]).abs().max()) > 1e-4
    assert float((tout["hfluxn"][1] - tout["hfluxn"][0]).abs().max()) > 0.0


def _jax_states_by_step():
    """JAX single-member states at steps 2, 3 and 4 (one per phase of the
    shortwave cadence) with their calendars."""
    if "by_step" not in _cache:
        _, jstate, jcal = jax_model()
        states = {2: (jstate, dataclasses.replace(jcal))}
        for start, n in ((2, 1), (2, 2)):
            ctx, cal = JM.build_step_ctx(dataclasses.replace(jcal), start, n)
            states[start + n] = (jax_run(n)(jstate, ctx), cal)
        _cache["by_step"] = states
    return _cache["by_step"]


@pytest.mark.parametrize("n_steps", [1, 2, 4])
@pytest.mark.parametrize("start", [2, 3, 4])
def test_short_runs_from_every_phase_match_jax(start, n_steps):
    """1-, 2- and 4-step runs starting at steps 2, 3 and 4 (phases 2, 0, 1
    of the shortwave cadence), B=2 with member 1 a copy: against the JAX
    single-member integrator. Limit 1e-10; ephemerals and cache
    member-batched and current after every run."""
    jstate, jcal = _jax_states_by_step()[start]
    tconsts, _, _ = torch_model()
    ctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), start, n_steps)
    jout = jax_run(n_steps)(jstate, ctx)

    tcal = dataclasses.replace(torch_model()[2])
    if start > 2:
        _, tcal = TM.build_step_ctx(tcal, 2, start - 2)
    tctx, _ = TM.build_step_ctx(tcal, start, n_steps)
    assert list(tctx["compute_shortwave"]) == [
        (start + i) % 3 == 0 for i in range(n_steps)]
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(
        TE.broadcast_state(to_torch(jstate), 2), tctx)
    names = set(PROGNOSTICS) | set(TD.CACHE_FIELDS) | set(TD.DIAG_FIELDS) | {
        "land_temp", "sst_om", "tice_om"}
    for member in (0, 1):
        compare_states(tout, jout, 1e-10, names, member=member)
    for name in TM.EPHEMERAL_FIELDS | set(TD.CACHE_FIELDS):
        assert tout[name].shape[0] == 2, name


def test_run_across_daily_forcing_matches_jax():
    """36 steps from step 2, so the daily forcing fires at step 36 and the
    physics reads what it rewrote: the port in one run at B=1 against the JAX
    single-member integrator in nine chained 4-step runs. Limit 1e-8."""
    _, jstate, jcal = jax_model()
    tconsts, _, _ = torch_model()
    jcal = dataclasses.replace(jcal)
    jout, step = jstate, 2
    fired = 0
    for _ in range(9):
        ctx, jcal = JM.build_step_ctx(jcal, step, 4)
        fired += int(np.asarray(ctx["do_forcing"]).sum())
        jout = jax_run(4)(jout, ctx)
        step += 4
    assert fired == 1 and step == 38

    tctx, tcal_after = TM.build_step_ctx(
        dataclasses.replace(torch_model()[2]), 2, 36)
    assert tctx["do_forcing"].sum() == 1 and tctx["do_forcing"][34]
    assert tcal_after.day == 2
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(
        TE.broadcast_state(to_torch(jstate), 1), tctx)
    assert not bool(tout["error_flag"].any())
    names = set(PROGNOSTICS) | set(TD.CACHE_FIELDS) | set(TD.DIAG_FIELDS) | {
        "qcorh", "tcorh", "flux_solar_in", "alb_surface", "snowc",
        "stratospheric_correction", "land_temp", "sst_om"}
    compare_states(tout, jout, 1e-8, names, member=0)


def test_chained_calls_equal_one_run():
    """Two 3-step calls equal one 6-step call bitwise: the second call gets
    the cache and the ephemerals member-batched (the first got them shared)
    and both layouts work; unperturbed members stay identical."""
    tconsts, tstate, tcal = torch_model()
    run = TE.make_run_steps_batched(tconsts, device="cpu")
    start = TE.broadcast_state(tstate, 3)
    assert start["hfluxn"].dim() == 3 and start["tsr"].shape[0] == 3
    ctx6, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, 6)
    whole = run(start, ctx6)
    ctx_a, cal_a = TM.build_step_ctx(dataclasses.replace(tcal), 2, 3)
    ctx_b, _ = TM.build_step_ctx(cal_a, 5, 3)
    half = run(start, ctx_a)
    assert half["hfluxn"].shape[0] == 3
    chained = run(half, ctx_b)
    assert set(chained) == set(whole)
    for name, val in whole.items():
        a = val if isinstance(val, tuple) else (val,)
        b = chained[name] if isinstance(val, tuple) else (chained[name],)
        for x, y in zip(a, b):
            assert torch.equal(x, y), name
    for name in PROGNOSTICS:
        x = whole[name][0]
        assert torch.equal(x[1:], x[:1].expand_as(x[1:])), name
    # One member alone equals member 0 of the ensemble. Limit 1e-12: a
    # matrix product may block its rows differently at another batch size
    # (1e-16), and the condensation differences q against its threshold,
    # which amplifies that a few hundred times in precls.
    one = run(TE.broadcast_state(tstate, 1), ctx6)
    for name in PROGNOSTICS + ("hfluxn", "precls", "tsr"):
        a = one[name][0] if isinstance(one[name], tuple) else one[name]
        b = whole[name][0] if isinstance(whole[name], tuple) else whole[name]
        assert rel_err(b[:1].numpy(), a.numpy()) <= 1e-12, name


def test_grid_phi_matches_spectral_path():
    """consts.grid_phi reconstructs the physics-path geopotential by
    grid-space hydrostatic integration: a re-association of two commuting
    linear operators, so the operator identity holds to 1e-9 of phi and
    6-step trajectories agree to 1e-10."""
    params = dataclasses.replace(T_T30L8, fft_mode="matmul")
    consts, state, cal = make_demo_model(params, device="cpu")
    assert "phisg" in state and not consts.grid_phi
    sb = TE.broadcast_state(state, 1)

    phi = get_geopotential(consts.gp, sb["t"][0], state["phis"])
    phig_ref = TS.spec2grid_p(consts.sp, phi, 1, 1)
    tg = TS.spec2grid_p(consts.sp, sb["t"][0], 1, 1)
    phig = get_geopotential_grid(consts.gp, consts.sp, tg, sb["t"][0],
                                 state["phisg"])
    assert rel_err(phig.numpy(), phig_ref.numpy()) <= 1e-9
    # The same recursion inside grid_physics, from phisg and m0corr.
    m0 = hydrostatic_m0corr(consts.gp, consts.sp, sb["t"][0])
    assert m0.shape == (1, params.kx, params.il, 1)
    assert float(m0.abs().max()) > 0.0

    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 6)
    out_off = TE.make_run_steps_batched(consts, device="cpu")(sb, ctx)
    consts_on = dataclasses.replace(consts, grid_phi=True)
    out_on = TE.make_run_steps_batched(consts_on, device="cpu")(sb, ctx)
    for name in ("vor", "div", "t", "ps"):
        for lev in range(2):
            err = rel_err(out_on[name][lev].numpy(),
                          out_off[name][lev].numpy())
            assert 0.0 < err < 1e-10, (name, lev, err)
    assert not bool(out_on["error_flag"].any())
    on, _ = TM.build_consts(T_T30L8, device="cpu", grid_phi=True)
    assert on.grid_phi


def test_coupler_reads_each_members_own_fluxes():
    """Two members with different hfluxn, shf and evap, coupled together and
    one by one, agree member for member: the coupler indexes the land/sea
    axis of the (B, 3, il, ix) fluxes, not the member axis."""
    tconsts, tstate, tcal = torch_model()
    ctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, 1)
    tables = TM.coupler_tables(tconsts, tstate, ctx)
    args = (type(tables)(tables.rows[0], tables.w[0]),)
    rng = np.random.default_rng(5)
    both = TM.ensure_member_axis(TE.broadcast_state(tstate, 2), 2)
    p = T_T30L8
    for name in ("hfluxn", "shf", "evap"):
        both[name] = torch.from_numpy(
            100.0 * rng.standard_normal((2, 3, p.il, p.ix)))
    both["ssrd"] = torch.from_numpy(
        200.0 * rng.random((2, p.il, p.ix)))
    together = couple_sea_land(tconsts, both, *args)
    names = ("stl_lm", "land_temp", "sst_om", "tice_om", "ssti_om", "sst_am")
    for b in range(2):
        batched = TM.CARRY_FIELDS | {"hfluxn", "shf", "evap"}
        single = {k: (tuple(x[b:b + 1] for x in v) if isinstance(v, tuple)
                      else v[b:b + 1]) if k in batched else v
                  for k, v in both.items()}
        alone = couple_sea_land(tconsts, single, *args)
        for name in names:
            assert torch.equal(together[name][b:b + 1], alone[name]), (name, b)
    # The members really got different fluxes, and the land model used the
    # land row, the sea model the sea row.
    assert float((together["stl_lm"][0] - together["stl_lm"][1]).abs().max()) > 0
    assert float((together["tice_om"][0] - together["tice_om"][1]).abs().max()) > 0
    # The shared (3, il, ix) layout of the physics-off model still works.
    shared = dict(both)
    for name in ("hfluxn", "shf", "evap"):
        shared[name] = both[name][0]
    out = couple_sea_land(tconsts, shared, *args)
    assert torch.equal(out["stl_lm"][0], together["stl_lm"][0])


def test_interop_carries_the_physics_state_both_ways():
    """phisg, the radiation cache and the member-batched diagnostics cross
    between the packages unchanged, in both directions."""
    _, jstate, jcal = jax_model()
    jnp_state = jax.tree.map(np.asarray, JE.broadcast_state(jstate, 2))
    assert "phisg" in jnp_state and jnp_state["rad_tau2"].shape[0] == 2
    t = interop.state_from_numpy(jnp_state, device="cpu")
    back = interop.state_to_numpy(t)
    for name in ("phisg",) + TD.CACHE_FIELDS + TD.DIAG_FIELDS:
        assert np.array_equal(back[name], jnp_state[name]), name
        assert back[name].dtype == jnp_state[name].dtype, name
    # A port state (member-batched ephemerals after a run) goes to JAX.
    tconsts, tstate, tcal = torch_model()
    tctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, 1)
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(
        TE.broadcast_state(tstate, 2), tctx)
    as_np = interop.state_to_numpy(tout)
    assert as_np["hfluxn"].shape == (2, 3, 48, 96)
    jrun = jax_run(1)
    member0 = {k: (tuple(a[0] for a in v) if isinstance(v, tuple) else v[0])
               if k in TM.DYNAMIC_FIELDS else v for k, v in as_np.items()}
    member0 = {k: v for k, v in member0.items() if k in jstate}
    ctx2, _ = JM.build_step_ctx(
        JM.build_step_ctx(dataclasses.replace(jcal), 2, 1)[1], 3, 1)
    jnext = jrun(member0, ctx2)
    assert np.isfinite(np.asarray(jnext["t"][0])).all()
    assert not bool(jnext["error_flag"])
