"""SPPT (stochastic physics) of ``pyspeedy_tpu_torch`` against the JAX
package, in float64 on the CPU: the tables, the noise stream bit for bit,
the stationary draw, the pattern generator, the grouping of a run call's
draws, the initialization and a few full-physics SPPT steps of the batched
runner. The pattern's statistics, which the JAX package does not test, and
the card's checks are in tests/test_torch_sppt_pattern.py, which imports no
JAX and so also runs on the card's machine.

Tolerances are relative to each field's largest absolute value. The noise
words are equal (the same threefry2x32 arithmetic); the normals differ by
the rounding of erfinv (PyTorch's against XLA's), about 1e-14; what follows
differs further only by the order of sums in the transforms and the physics.
The JAX side compiles slowly with the physics on, so its integrator is built
once per file.
"""

import dataclasses
import math
from datetime import datetime

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.parallel import ensemble as JE
from pyspeedy_tpu.params import T30L8 as J_T30L8
from pyspeedy_tpu.physics import driver as JD
from pyspeedy_tpu.physics import sppt as JSP
from pyspeedy_tpu.testing import make_demo_model as j_make_demo_model
from pyspeedy_tpu.utils.calendar import ModelCalendar as JCalendar
from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8
from pyspeedy_tpu_torch.physics import sppt as TSP
from pyspeedy_tpu_torch.testing import make_demo_model

torch.set_num_threads(1)

J_SPPT = dataclasses.replace(J_T30L8, sppt_on=True)
T_SPPT = dataclasses.replace(T_T30L8, sppt_on=True)
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
_cache = {}


def jax_consts():
    if "jconsts" not in _cache:
        _cache["jconsts"] = JM.build_consts(J_SPPT)[0]
    return _cache["jconsts"]


def torch_consts():
    if "tconsts" not in _cache:
        _cache["tconsts"] = TM.build_consts(T_SPPT, device="cpu")[0]
    return _cache["tconsts"]


def jax_model():
    """The JAX package's full-physics SPPT demo model: the stationary draw
    from jax.random.key(0), then both bootstrap steps with their patterns."""
    if "jax" not in _cache:
        _cache["jax"] = j_make_demo_model(J_SPPT)
    return _cache["jax"]


def jkey(seed_fold=3):
    """A JAX key (raw uint32 data) and the same words as the port holds."""
    k = jax.random.key_data(jax.random.fold_in(jax.random.key(0), seed_fold))
    return k, torch.from_numpy(np.asarray(k).astype(np.int64))


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


def test_tables_match_jax():
    j, t = jax_consts().sppt, torch_consts().sppt
    assert rel_err(t.sigma.numpy(), j.sigma) <= 1e-14
    assert t.sigma.dtype == torch.float64 and t.sigma.shape == (1, 1, 31, 32)
    assert abs(t.phi - j.phi) <= 1e-14 * j.phi
    assert abs(t.stat - j.stat) <= 1e-14 * j.stat


@pytest.mark.parametrize("what", ["key", "fold_in", "split", "bits32",
                                  "bits64"])
def test_noise_words_equal_jax(what):
    """threefry2x32 words: keys folded with step numbers and member ids,
    split keys, and the bits behind jax.random.normal in float32 (x0 ^ x1)
    and float64 (x0:x1), all bit for bit."""
    base, tbase = jkey(11)
    if what == "key":
        assert np.array_equal(TSP.key_data(0).numpy(),
                              np.asarray(jax.random.key_data(
                                  jax.random.key(0))))
        return
    if what == "fold_in":
        for data in (0, 1, 2, 35, 0x5bb7, 2**31 + 5):
            want = jax.random.key_data(jax.random.fold_in(
                jax.random.wrap_key_data(base), data))
            got = TSP.fold_in(tbase, data)
            assert np.array_equal(got.numpy(), np.asarray(want)), data
        many = TSP.fold_in(tbase[None], torch.arange(4)[:, None])
        assert many.shape == (4, 1, 2)
        return
    if what == "split":
        want = jax.random.key_data(jax.random.split(
            jax.random.wrap_key_data(base), 7))
        assert np.array_equal(TSP.split_keys(tbase, 7).numpy(),
                              np.asarray(want))
        return
    x0, x1 = TSP.threefry2x32(tbase[0], tbase[1], 0, torch.arange(5000))
    key = jax.random.wrap_key_data(base)
    if what == "bits32":
        want = np.asarray(jax.random.bits(key, (5000,), dtype=jnp.uint32))
        assert np.array_equal((x0 ^ x1).numpy(), want)
    else:
        want = np.asarray(jax.random.bits(key, (5000,), dtype=jnp.uint64))
        got = (x0.numpy().astype(np.uint64) << np.uint64(32)) \
            | x1.numpy().astype(np.uint64)
        assert np.array_equal(got, want)


def test_normals_match_jax():
    """jax.random.normal (float64) of a group of three steps, from the same
    words: within 1e-12 (erfinv's own rounding, PyTorch against XLA)."""
    base, tbase = jkey(5)
    shape = (3, 2, 8, 31, 32)
    want = np.asarray(jax.random.normal(jax.random.wrap_key_data(base), shape,
                                        dtype=jnp.float64))
    got = TSP.draw_noise(tbase, shape, torch.float64)
    assert got.shape == shape
    assert np.abs(got.numpy() - want).max() <= 1e-12
    # An offset moves along the same stream: step 2 of the group alone.
    per = math.prod(shape[1:])
    second = TSP.draw_noise(tbase, shape[1:], torch.float64, 2 * per)
    assert torch.equal(second, got[2])


def test_stationary_draw_matches_jax():
    base, tbase = jkey(7)
    want = np.asarray(JSP.stationary_draw(jax_consts(), base))
    got = TSP.stationary_draw(torch_consts(), tbase)
    assert rel_err(got.numpy(), want) <= 1e-12
    both = TSP.stationary_draw(torch_consts(), torch.stack([tbase, tbase]))
    assert torch.equal(both[1], got)


@pytest.mark.parametrize("n", [1, 3])
def test_gen_sppt_n_matches_jax(n):
    """n AR(1) steps from a stationary spectrum, the noise of the group that
    starts at step 12: the clipped grid patterns and the new spectrum."""
    base, tbase = jkey(9)
    jconsts, tconsts = jax_consts(), torch_consts()
    jstate = {"sppt_spec": JSP.stationary_draw(jconsts, base),
              "sppt_key": base}
    tstate = {"sppt_spec": TSP.stationary_draw(tconsts, tbase),
              "sppt_key": tbase}
    jpat, jout = JSP.gen_sppt_n(jconsts, jstate, n, 12)
    tpat, tout = TSP.gen_sppt_n(tconsts, tstate, n, 12)
    assert tpat.shape == (n, 8, 48, 96)
    assert rel_err(tpat.numpy(), jpat) <= 1e-12
    assert rel_err(tout["sppt_spec"].numpy(), jout["sppt_spec"]) <= 1e-12
    assert float(tpat.abs().max()) <= 1.0
    if n == 1:
        one, _ = TSP.gen_sppt(tconsts, tstate, 12)
        assert torch.equal(one, tpat[0])


@pytest.mark.parametrize("first_step", [1, 2, 3])
def test_grouping_of_a_seven_step_run_equals_jax(first_step, monkeypatch):
    """The JAX batched runner's draws over 7 steps from each phase of the
    shortwave cadence, recorded with a stub step (its shortwave-aligned
    prefix, scan and tail run unchanged, eagerly): a step that gets no
    pattern from a group draws its own, one-step group."""
    calls = []

    def stub_step(consts, static_sw=None):
        def fn(st, c):
            calls.append(("step", int(c["stepno"]), "sppt_pattern" in c))
            st = dict(st)
            for name in JD.CACHE_FIELDS:
                st.setdefault(name, jnp.zeros(()))
            return st
        return fn

    def record(consts, st, n, stepno):
        calls.append(("group", int(stepno), n))
        return jnp.zeros((n, 1)), st

    monkeypatch.setattr(JM, "make_single_step", stub_step)
    monkeypatch.setattr(JSP, "gen_sppt_n", record)
    state = {"vor": (jnp.zeros((2, 1)), jnp.zeros((2, 1))),
             "sppt_key": jnp.zeros((2, 2), jnp.uint32)}
    cal = JCalendar.from_datetime(datetime(1982, 1, 1))
    ctx, _ = JM.build_step_ctx(cal, first_step, 7)
    with jax.disable_jit():
        JE.make_run_steps_batched(jax_consts(), phase=first_step % 3)(
            state, ctx)
    groups, left = [], 0
    for kind, stepno, arg in calls:
        if kind == "group":
            groups.append((stepno, arg))
            left = arg
        elif arg:
            left -= 1
        else:
            groups.append((stepno, 1))
    assert left == 0
    assert sum(n for _, n in groups) == 7
    assert TSP.sppt_groups(first_step, 7) == groups
    assert [s for kind, s, _ in calls if kind == "step"] == list(
        range(first_step, first_step + 7))


def test_run_noise_follows_the_groups():
    """draw_run_noise: step i of the run gets the slice of its group's draw,
    also when the draw is split into passes."""
    tconsts = torch_consts()
    keys = TSP.split_keys(TSP.key_data(0), 3)
    whole = list(TSP.draw_run_noise(tconsts, keys, 2, 7))
    per = 2 * 8 * 31 * 32
    at = 0
    for s, n in TSP.sppt_groups(2, 7):
        eta = TSP.draw_noise(TSP.fold_in(keys, s), (n, 2, 8, 31, 32),
                             torch.float64)
        for j in range(n):
            assert torch.equal(whole[at], tconsts.sppt.sigma * eta[:, j])
            at += 1
    old = TSP.MAX_DRAW_ELEMENTS
    try:
        TSP.MAX_DRAW_ELEMENTS = 3 * per * 2
        split = list(TSP.draw_run_noise(tconsts, keys, 2, 7))
    finally:
        TSP.MAX_DRAW_ELEMENTS = old
    assert all(torch.equal(a, b) for a, b in zip(whole, split))


def test_initialization_with_sppt_matches_jax():
    """allocate_state + initialize with SPPT: the key jax.random.key(0), the
    stationary spectrum and both bootstrap steps with their one-step
    patterns (stepno 0 and 1). Every state field within 1e-10."""
    _, jstate, _ = jax_model()
    _, tstate, _ = make_demo_model(T_SPPT, device="cpu")
    jnp_state = jax.tree.map(np.asarray, jstate)
    assert set(jnp_state) == set(tstate)
    assert tstate["sppt_key"].dtype == torch.int64
    assert np.array_equal(tstate["sppt_key"].numpy(), jnp_state["sppt_key"])
    tnp = interop.state_to_numpy(tstate)
    for name, want in jnp_state.items():
        got = tnp[name]
        for g, w in (zip(got, want) if isinstance(want, tuple)
                     else [(got, want)]):
            if w.dtype.kind == "f":
                assert rel_err(g, w) <= 1e-10, name
            else:
                assert np.array_equal(g, w), name
    assert float(tstate["sppt_spec"].abs().max()) > 0


def test_batched_sppt_steps_match_jax():
    """4 steps of the batched runner from step 2 (a one-step group and the
    tail triple), B=2 with member keys split from the
    state's, against the JAX batched runner: prognostics, the SPPT spectrum
    and the physics' diagnostics within 1e-10; the members differ."""
    jconsts, jstate, jcal = jax_model()
    tconsts = torch_consts()
    ctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), 2, 4)
    jout = JE.make_run_steps_batched(jconsts, phase=2)(
        JE.broadcast_state(jstate, 2), ctx)
    jout = jax.tree.map(np.asarray, jout)
    tin = TE.broadcast_state(
        interop.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                 device="cpu"), 2)
    assert np.array_equal(tin["sppt_key"].numpy(),
                          np.asarray(jax.random.key_data(jax.random.split(
                              jax.random.wrap_key_data(jstate["sppt_key"]),
                              2))))
    tout = TE.make_run_steps_batched(tconsts, device="cpu")(tin, ctx)
    for name in PROGNOSTICS:
        for lev in range(2):
            assert rel_err(tout[name][lev].numpy(),
                           jout[name][lev]) <= 1e-10, name
    assert rel_err(tout["sppt_spec"].numpy(), jout["sppt_spec"]) <= 1e-10
    for name in ("precnv", "precls", "hfluxn", "olr", "tsr"):
        assert rel_err(tout[name].numpy(), jout[name]) <= 1e-10, name
    t = tout["t"][0]
    assert float((t[0] - t[1]).abs().max()) > 1e-6
