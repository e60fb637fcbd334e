"""The ported model as a whole: the member-batched dynamics-only T30L8 model
of ``pyspeedy_tpu_torch`` against the JAX package, in float64 on the CPU
(where the port's grid-dynamics dispatch takes the plain PyTorch version).
The full-physics model is held against JAX in test_torch_physics_step.py.

Tolerances are relative to each field's largest absolute value. Both packages
run the same formulation; what differs is the order of sums inside matrix
products, FFTs and the level contractions of the implicit solver, i.e.
rounding at 1e-16 that the leapfrog amplifies slowly.
"""

import ast
import dataclasses
import os
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.models import prognostics as JP
from pyspeedy_tpu.parallel import ensemble as JE
from pyspeedy_tpu.params import T30L8 as J_T30L8
from pyspeedy_tpu.testing import synthetic_host_bc as j_synthetic_host_bc
from pyspeedy_tpu.utils.calendar import ModelCalendar as JCalendar
from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models import prognostics as TP
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8
from pyspeedy_tpu_torch.testing import make_demo_model, synthetic_host_bc

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
_cache = {}


def jax_model():
    """(consts, state, calendar) of the JAX package's dynamics-only model,
    initialized as tests/test_model_configs.py does it (its make_demo_model
    runs the bootstrap steps with physics on, so it is not the counterpart).
    Built once: the initialization compiles two bootstrap steps."""
    if "jax" not in _cache:
        consts, geom_np = JM.build_consts(J_T30L8, physics_on=False)
        host_bc = j_synthetic_host_bc(J_T30L8, geom_np)
        host_bc["_geom_np"] = geom_np
        state = JM.allocate_state(J_T30L8, n_months=1)
        cal = JCalendar.from_datetime(datetime(1982, 1, 1),
                                      nsteps=J_T30L8.nsteps)
        state = JM.initialize(consts, state, host_bc, cal)
        _cache["jax"] = (consts, state, cal)
    return _cache["jax"]


def torch_model():
    if "torch" not in _cache:
        _cache["torch"] = make_demo_model(T_T30L8, device="cpu",
                                          physics_on=False)
    return _cache["torch"]


def carried_over():
    """The JAX initial state as the port's dict of tensors."""
    _, jstate, _ = jax_model()
    return interop.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                    device="cpu", dtype=torch.float64)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


def worst_prognostic_err(tstate, jstate):
    worst = 0.0
    for name in PROGNOSTICS:
        for lev in range(2):
            worst = max(worst, rel_err(tstate[name][lev].numpy(),
                                       jstate[name][lev]))
    return worst


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


def test_initialization_matches_jax():
    """(i) build_consts + initialize from the synthetic boundary conditions,
    both bootstrap steps included: every state field, limit 1e-10."""
    _, jstate, _ = jax_model()
    _, tstate, _ = torch_model()
    jnp_state = jax.tree.map(np.asarray, jstate)
    tnp_state = interop.state_to_numpy(tstate)
    # Everything the JAX state holds must be there (phisg, which serves the
    # grid-space geopotential of the physics path, included).
    assert set(jnp_state) == set(tnp_state)
    checked = 0
    for name, want in jnp_state.items():
        if name not in tnp_state:
            continue
        got = tnp_state[name]
        if isinstance(want, tuple):
            assert isinstance(got, tuple) and len(got) == len(want), name
            pairs = list(zip(got, want))
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            assert g.shape == w.shape, (name, g.shape, w.shape)
            if w.dtype.kind == "f":
                assert rel_err(g, w) <= 1e-10, (name, rel_err(g, w))
            else:
                assert np.array_equal(g, w), name
            checked += 1
    assert checked > 100
    # The synthetic boundary conditions themselves are the same arrays.
    jb = j_synthetic_host_bc(J_T30L8, TM.build_geometry(T_T30L8))
    tb = synthetic_host_bc(T_T30L8, TM.build_geometry(T_T30L8))
    assert all(np.array_equal(jb[k], tb[k]) for k in jb)


def test_six_batched_steps_match_jax():
    """(ii) From the JAX state carried over by interop: 6 steps of the
    batched runner, B=3, members 1-2 perturbed in t, against the JAX batched
    runner with its Pallas grid-dynamics kernel on (interpret mode under
    vmap, as off the TPU). Limit 1e-9."""
    nmem, n_steps = 3, 6
    jconsts, jstate, jcal = jax_model()
    tconsts, _, _ = torch_model()
    noise = perturbation(nmem)

    jconsts_k = dataclasses.replace(jconsts, physics_on=False,
                                    pallas_physics=True)
    jb = JE.broadcast_state(jstate, nmem)
    jb["t"] = (jb["t"][0] + noise, jb["t"][1] + noise)
    ctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), 2, n_steps)
    jout = JE.make_run_steps_batched(jconsts_k)(jb, ctx)
    jout = jax.tree.map(np.asarray, jout)

    tb = TE.broadcast_state(carried_over(), nmem)
    tnoise = torch.from_numpy(noise)
    tb["t"] = (tb["t"][0] + tnoise, tb["t"][1] + tnoise)
    tctx, _ = TM.build_step_ctx(
        dataclasses.replace(torch_model()[2]), 2, n_steps)
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(tb, tctx)

    assert not bool(tout["error_flag"].any())
    assert tout["error_flag"].shape == (nmem,)
    err = worst_prognostic_err(tout, jout)
    assert err <= 1e-9, err
    # Members really differ, and the physics-off ephemerals stayed
    # single-member, as in the JAX runner.
    t0 = tout["t"][0]
    assert float((t0[1] - t0[0]).abs().max()) > 1e-4
    assert tout["hfluxn"].shape == tuple(jout["hfluxn"].shape)
    for name in ("phi", "land_temp", "sst_am", "tcorh", "qcorh",
                 "alb_surface"):
        assert rel_err(tout[name].numpy(), jout[name]) <= 1e-9, name


def test_run_across_daily_forcing_matches_jax():
    """(iii) 42 steps at B=1 from step 2, so the daily forcing fires at step
    36, against the JAX single-member integrator. Limit 1e-8."""
    n_steps = 42
    jconsts, jstate, jcal = jax_model()
    tconsts, _, tcal = torch_model()
    ctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), 2, n_steps)
    assert bool(np.asarray(ctx["do_forcing"])[34])
    jout = jax.tree.map(np.asarray, JM.make_run_steps(jconsts)(jstate, ctx))

    tctx, tcal_after = TM.build_step_ctx(dataclasses.replace(tcal), 2,
                                         n_steps)
    assert tctx["do_forcing"].sum() == 1 and tctx["do_forcing"][34]
    assert tcal_after.day == 2
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(
        TE.broadcast_state(carried_over(), 1), tctx)
    assert not bool(tout["error_flag"].any())
    for name in PROGNOSTICS:
        for lev in range(2):
            err = rel_err(tout[name][lev][0].numpy(), jout[name][lev])
            assert err <= 1e-8, (name, lev, err)
    # What the forcing rewrote at step 36.
    for name in ("qcorh", "tcorh", "flux_solar_in", "alb_surface", "snowc",
                 "stratospheric_correction"):
        assert rel_err(tout[name][0].numpy(), jout[name]) <= 1e-8, name


def test_dynamics_only_240_step_fixture():
    """(iv) The port alone, 240 steps from its own initialization, against
    the pinned trajectory tests/fixtures/dynamics_only_240.npz, read as
    tests/test_model_configs.py reads it. Limit 1e-6 (the JAX test's 1e-8
    leaves room for one compiler's reassociation only); reached: 2e-14 (div)
    on this PyTorch build."""
    tconsts, tstate, tcal = torch_model()
    ctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, 240)
    out = TE.make_run_steps_batched(tconsts, device="cpu")(
        TE.broadcast_state(tstate, 1), ctx)
    assert not bool(out["error_flag"].any())
    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                               "dynamics_only_240.npz"))
    got = {"vor": out["vor"][0], "div": out["div"][0], "t": out["t"][0],
           "ps": out["ps"][0], "q": out["tr"][0][:, :, 0]}
    for name, arr in got.items():
        a = arr[0].numpy()
        a = a[0] + 1j * a[1]  # real pair -> the fixture's complex layout
        b = fix[name]
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-6, name


def test_single_member_equals_member_zero_of_ensemble():
    """(v) A B=1 run equals member 0 of an unperturbed B=3 run (limit 1e-14;
    a matrix product may block its rows differently at another batch size),
    and all unperturbed members are identical."""
    tconsts, tstate, tcal = torch_model()
    run = TE.make_run_steps_batched(tconsts, device="cpu")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, 5)
    one = run(TE.broadcast_state(tstate, 1), ctx)
    three = run(TE.broadcast_state(tstate, 3), ctx)
    for name in PROGNOSTICS:
        for lev in range(2):
            a, b = one[name][lev], three[name][lev]
            assert b.shape == (3,) + a.shape[1:]
            assert rel_err(b[:1].numpy(), a.numpy()) <= 1e-14, name
            assert rel_err(b[1:].numpy(),
                           b[:1].expand_as(b[1:]).numpy()) <= 1e-14, name


def test_batched_layout_and_untouched_fields():
    """The runner keeps the layout broadcast_state produces: carried fields
    member-batched, everything else shared and bitwise unchanged."""
    tconsts, tstate, tcal = torch_model()
    nmem = 2
    start = TE.broadcast_state(tstate, nmem)
    ctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, 2)
    out = TE.make_run_steps_batched(tconsts, device="cpu")(start, ctx)
    assert set(out) == set(start)
    for name, val in out.items():
        levels = val if isinstance(val, tuple) else (val,)
        ref = start[name] if isinstance(val, tuple) else (start[name],)
        for a, r in zip(levels, ref):
            assert a.shape == r.shape, name
            if name in TM.CARRY_FIELDS:
                assert a.shape[0] == nmem, name
            else:
                assert torch.equal(a, r), name
    assert TM.CARRY_FIELDS == TM.DYNAMIC_FIELDS - TM.EPHEMERAL_FIELDS
    assert TM.DYNAMIC_FIELDS == JM.DYNAMIC_FIELDS
    assert TM.EPHEMERAL_FIELDS == JM.EPHEMERAL_FIELDS
    assert TE.pick_member_chunk(1024, 128) == 128
    assert TE.pick_member_chunk(100, 128) == 100
    assert TE.pick_member_chunk(200, 128) == 200


def test_interop_round_trip():
    _, jstate, _ = jax_model()
    jnp_state = jax.tree.map(np.asarray, JE.broadcast_state(jstate, 2))
    t = interop.state_from_numpy(jnp_state, device="cpu",
                                 dtype=torch.float64)
    back = interop.state_to_numpy(t)
    for name, want in jnp_state.items():
        got = back[name]
        if isinstance(want, tuple):
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), name
        else:
            assert np.array_equal(got, want), name
            assert got.dtype == want.dtype, name
    t32 = interop.state_from_numpy(jnp_state, device="cpu",
                                   dtype=torch.float32)
    assert t32["vor"][0].dtype == torch.float32
    assert t32["error_flag"].dtype == torch.bool


@pytest.mark.parametrize("route", ["fft", "matmul"])
def test_grid_mirrors_of_a_carried_over_state_match_jax(route):
    """A JAX state converted by interop and pushed through the port's
    prognostics.spectral2grid gives the JAX grid mirrors; grid2spectral and
    grid_filter_prognostics follow. Limit 1e-12: the same transforms on both
    sides, sums in another order. "matmul" is the dense route, whose CPU
    side is the plain version of the fused transform kernels."""
    jp = dataclasses.replace(J_T30L8, fft_mode=route)
    tp = dataclasses.replace(T_T30L8, fft_mode=route)
    jconsts, _ = JM.build_consts(jp, physics_on=False)
    tconsts, _ = TM.build_consts(tp, device="cpu", physics_on=False)
    assert tconsts.sp.use_dense_legendre == (route == "matmul")
    _, jstate, _ = jax_model()
    tstate = carried_over()

    jg = JP.spectral2grid(jconsts, jstate)
    tg = TP.spectral2grid(tconsts, tstate)
    for name in TP.GRID_MIRRORS:
        assert rel_err(tg[name].numpy(), jg[name]) <= 1e-12, name

    js = JP.grid2spectral(jconsts, jg)
    ts = TP.grid2spectral(tconsts, tg)
    for name in ("vor", "div", "t", "ps", "tr"):
        assert rel_err(ts[name][0].numpy(), js[name][0]) <= 1e-12, name
        assert torch.equal(ts[name][1], tstate[name][1]), name
    assert rel_err(ts["phi"].numpy(), js["phi"]) <= 1e-12
    assert torch.equal(tstate["tr"][0], carried_over()["tr"][0])  # not aliased

    jf = JP.grid_filter_prognostics(jconsts, jg)
    tf = TP.grid_filter_prognostics(tconsts, tg)
    for name in TP.GRID_MIRRORS:
        assert rel_err(tf[name].numpy(), jf[name]) <= 1e-12, name


@pytest.mark.parametrize("route", ["fft", "matmul"])
def test_grid_mirrors_batched_equal_the_members_one_by_one(route):
    """pdim=1 on a member-batched state with B=3 perturbed members."""
    tp = dataclasses.replace(T_T30L8, fft_mode=route)
    tconsts, _ = TM.build_consts(tp, device="cpu", physics_on=False)
    nmem = 3
    state = TE.broadcast_state(carried_over(), nmem)
    noise = torch.from_numpy(perturbation(nmem))
    state["t"] = (state["t"][0] + noise, state["t"][1])
    state["phi"] = state["phi"] + 9.81 * noise
    both = TP.grid_filter_prognostics(
        tconsts, TP.spectral2grid(tconsts, state, pdim=1), pdim=1)
    back = TP.grid2spectral(tconsts, both, pdim=1)
    assert both["t_grid"].shape == (nmem, 8, 48, 96)
    assert both["ps_grid"].shape == (nmem, 48, 96)
    assert back["tr"][0].shape == state["tr"][0].shape
    for m in range(nmem):
        one = {k: (tuple(a[m] for a in v) if isinstance(v, tuple) else v[m])
               if k in TM.CARRY_FIELDS else v for k, v in state.items()}
        g1 = TP.grid_filter_prognostics(tconsts,
                                        TP.spectral2grid(tconsts, one))
        s1 = TP.grid2spectral(tconsts, g1)
        for name in TP.GRID_MIRRORS:
            assert rel_err(both[name][m].numpy(), g1[name].numpy()) <= 1e-14, \
                name
        for name in ("vor", "div", "t", "ps", "tr"):
            assert rel_err(back[name][0][m].numpy(),
                           s1[name][0].numpy()) <= 1e-13, name


@pytest.mark.parametrize("what", ["bf16_tendencies", "sppt_on", "alph",
                                  "sppt_on_with_physics"])
def test_unported_paths_raise(what):
    """What is not ported yet, or does not exist (bfloat16 tendencies in
    float64), is refused by name, never silently ignored."""
    if what == "bf16_tendencies":
        assert T_T30L8.precision == "f64"
        with pytest.raises(ValueError, match="bf16_tendencies.*precision"):
            TM.build_consts(T_T30L8, device="cpu", bf16_tendencies=True)
    elif what == "sppt_on_with_physics":
        with pytest.raises(NotImplementedError, match="sppt"):
            TM.build_consts(dataclasses.replace(T_T30L8, sppt_on=True),
                            device="cpu")
    elif what == "sppt_on":
        with pytest.raises(NotImplementedError, match="sppt"):
            TM.build_consts(dataclasses.replace(T_T30L8, sppt_on=True),
                            device="cpu", physics_on=False)
    else:
        params = dataclasses.replace(T_T30L8, alph=0.0)
        consts, _ = TM.build_consts(params, device="cpu", physics_on=False)
        state = TE.broadcast_state(torch_model()[1], 1)
        with pytest.raises(NotImplementedError, match="alph"):
            TM.step(consts, state, 2, 2, 2.0 * params.delt)


@pytest.mark.parametrize("entry", ["build_consts", "allocate_state",
                                   "make_demo_model",
                                   "make_run_steps_batched"])
def test_entry_points_default_to_the_card_and_refuse_without_one(entry):
    """Every entry point that builds tables or state defaults to "cuda" and
    raises where there is none: no silent fall back to the CPU."""
    import inspect
    fn = {"build_consts": TM.build_consts,
          "allocate_state": TM.allocate_state,
          "make_demo_model": make_demo_model,
          "make_run_steps_batched": TE.make_run_steps_batched}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    args = {"build_consts": (T_T30L8,), "allocate_state": (T_T30L8,),
            "make_demo_model": (T_T30L8,),
            "make_run_steps_batched": (torch_model()[0],)}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        fn(*args)


def test_auto_transform_path_follows_the_device():
    consts, _, _ = torch_model()
    assert not consts.sp.use_matmul_fft          # "auto" on the CPU: fft
    mm, _ = TM.build_consts(dataclasses.replace(T_T30L8, fft_mode="matmul"),
                            device="cpu", physics_on=False)
    assert mm.sp.use_matmul_fft and mm.sp.use_dense_legendre
    with pytest.raises(ValueError, match="fft_mode"):
        TM.build_consts(dataclasses.replace(T_T30L8, fft_mode="dct"),
                        device="cpu", physics_on=False)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "pyspeedy_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 25
    assert REPO / "pyspeedy_tpu_torch/ops/transform_kernels.py" in files
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "pyspeedy_tpu"), (path, mod)
