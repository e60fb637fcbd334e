"""The batched runner's graph step writing its outputs into its buffers
(parallel/ensemble.py::StepGraphs, _BufferPlan), and the dispatchers'
destination path.

On the CPU (float64, T30, a few steps): the buffer plan run eagerly
(StepGraphs on CPU consts: step_body where a graph would be replayed, the
function the graphs record) copies none of the fields that the spectral
update (kernel table row 6), the physics (row 2), the geopotential, SPPT
and the slab models write: only coupling/coupler.py::STEP_COPIES, on both
shortwave kinds; its steps are bitwise the eager loop's over an odd and an
even number of steps in two run calls (physics, SPPT, the explicit
branch); a field set with Speedy.__setitem__ between two calls reaches the
next; the two dispatchers with a destination (the state's own tensors
among them) give the no-destination path's bits; the copy-in skips what
the buffers hold and copies a field modified in place; pick_member_chunk
picks by grid size as the JAX package's does. Marked gpu (skipped here): the
same on the card, the kernels storing into the destination in place.
"""

import dataclasses
from datetime import datetime

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import Speedy
from pyspeedy_tpu_torch import params as TP
from pyspeedy_tpu_torch.callbacks import BaseCallback
from pyspeedy_tpu_torch.coupling import coupler as CP
from pyspeedy_tpu_torch.coupling.forcing import FORCING_FIELDS
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models import spectral_glue as SG
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import glue_kernels as GK
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.physics import driver as PD
from pyspeedy_tpu_torch.testing import make_demo_model

torch.set_num_threads(1)

CONFIGS = {"physics": {}, "sppt": {"sppt_on": True},
           "explicit": {"alph": 0.0, "nsteps": 144}}
NMEM = 2
# Two run calls, an odd and an even number of steps, from step 33: the
# daily forcing at step 36 (T30), both shortwave kinds in each.
CALLS = ((33, 5), (38, 4))
# Fields the step writes through its kernels, the geopotential and the
# coupler's slab models: never copied by a graph step.
IN_PLACE = (set(SG.PAIR_FIELDS) | set(PD.DIAG_FIELDS) | set(PD.CACHE_FIELDS)
            | {"phi", "sppt_spec", "error_flag", "compute_shortwave",
               "stl_lm", "land_temp", "sstan_ob", "sst_om", "tice_om",
               "sstan_am", "sst_am", "ssti_om"})
_cache = {}


def model(cfg, device="cpu"):
    """(consts, single-member state, calendar) of configuration `cfg`."""
    key = (cfg, device)
    if key not in _cache:
        _cache[key] = make_demo_model(
            dataclasses.replace(TP.T30L8, **CONFIGS[cfg]), device=device)
    return _cache[key]


def members(cfg, device="cpu", nmem=NMEM):
    """nmem members; the last one's temperature is nudged (seeded noise)."""
    consts, state1, _ = model(cfg, device)
    state = TE.broadcast_state(state1, nmem)
    t0, t1 = state["t"]
    rng = np.random.default_rng(3)
    x = torch.zeros(t0.shape, dtype=t0.dtype)
    x[-1, :, :, 1:6, 1:6] = torch.from_numpy(
        rng.normal(0.0, 0.01, (2, t0.shape[2], 5, 5)))
    x = x.to(t0.device)
    state["t"] = (t0 + x, t1 + x)
    return consts, state


def ctx_of(cfg, first, n, device="cpu"):
    _, _, cal = model(cfg, device)
    return TM.build_step_ctx(dataclasses.replace(cal), first, n)[0]


def levels(v):
    return v if isinstance(v, tuple) else (v,)


def assert_bitwise(got, want):
    assert set(got) == set(want)
    for name in want:
        for a, b in zip(levels(got[name]), levels(want[name])):
            b = b.expand_as(a) if a.shape != b.shape else b
            assert torch.equal(a, b), name


@pytest.mark.parametrize("cfg", ("physics", "sppt"))
@pytest.mark.parametrize("n_steps", (3, 4))
def test_the_graph_step_copies_only_the_coupler_planes(cfg, n_steps):
    """Every graph key of a run of n_steps (shortwave or not, both parities
    of the pair's buffers): the plan's write copies exactly STEP_COPIES,
    none of the kernels' outputs, the shared planes into planes; with the
    daily forcing in the call its fields are counted beside them."""
    consts, state = members(cfg)
    graphs = TE.StepGraphs(consts)
    graphs.run(state, ctx_of(cfg, 35, n_steps))
    (plan,) = graphs.plans.values()
    assert {sw for sw, _ in plan.copies} == {True, False}
    assert {p for _, p in plan.copies} == {0, 1}
    for key, names in plan.copies.items():
        assert set(names) == CP.STEP_COPIES, key
        assert not set(names) & IN_PLACE, key
    for name in CP.SHARED_PLANES:
        assert plan.state[name].stride(0) == 0, name
    forcing = graphs.stats["copied"]["forcing"]
    assert set(forcing) == FORCING_FIELDS and not set(forcing) & IN_PLACE
    n_forcing = sum(len(levels(state[f])) for f in forcing)
    assert graphs.stats["copies_per_step"] == pytest.approx(
        len(CP.STEP_COPIES) + n_forcing / n_steps)


@pytest.mark.parametrize("cfg", tuple(CONFIGS))
def test_the_plan_is_bitwise_the_eager_loop_over_two_calls(cfg):
    """Two run calls (5 steps, then 4; the daily forcing in the first)
    through one buffer plan equal the eager loop's bit for bit, every
    field, after each call."""
    consts, state = members(cfg)
    graphs = TE.StepGraphs(consts)
    eager = TE.make_run_steps_batched(consts, device="cpu")
    got = want = state
    for first, n in CALLS:
        ctx = ctx_of(cfg, first, n)
        got, want = graphs.run(got, ctx), eager(want, ctx)
        assert_bitwise(got, want)
    assert len(graphs.plans) == 1
    assert not bool(got["error_flag"].any())


def test_one_member_copies_only_the_step_copies_and_is_bitwise():
    """One member (its member axis dense, not an expanded plane): the
    coupler still writes its planes into the buffers, so a graph step copies
    STEP_COPIES alone; two calls bitwise the eager loop's."""
    consts, state = members("physics", nmem=1)
    graphs = TE.StepGraphs(consts)
    eager = TE.make_run_steps_batched(consts, device="cpu")
    got = want = state
    for first, n in CALLS:
        ctx = ctx_of("physics", first, n)
        got, want = graphs.run(got, ctx), eager(want, ctx)
        assert_bitwise(got, want)
    (plan,) = graphs.plans.values()
    assert plan.aliased == CP.ALIASES
    for names in plan.copies.values():
        assert set(names) == CP.STEP_COPIES


def test_the_copy_in_skips_what_the_buffers_hold():
    """The plan's copy-in (stats["copies"]["in"]): every level but the
    aliases' at the first call; nothing when a call is given the state the
    last returned after an even number of steps; the leapfrog pairs alone
    after an odd number; a field modified in place or set anew again."""
    consts, state = members("physics")
    graphs = TE.StepGraphs(consts)
    state = graphs.run(state, ctx_of("physics", 33, 4))
    (plan,) = graphs.plans.values()
    assert plan.aliased == CP.ALIASES
    assert graphs.stats["copies"]["in"] == sum(
        len(levels(v)) for k, v in state.items() if k not in CP.ALIASES)
    state = graphs.run(state, ctx_of("physics", 37, 3))
    assert graphs.stats["copies"]["in"] == 0
    state = graphs.run(state, ctx_of("physics", 40, 2))
    assert graphs.stats["copies"]["in"] == sum(
        len(state[k]) for k in SG.PAIR_FIELDS)
    state["stl_lm"] = state["stl_lm"] + 0.0
    state["vor"][1].mul_(1.0)
    graphs.run(state, ctx_of("physics", 42, 2))
    assert graphs.stats["copies"]["in"] == 2
    assert graphs.stats["copies"]["out"] == sum(
        len(levels(state[k])) for k in TM.DYNAMIC_FIELDS & state.keys()
        if k not in CP.ALIASES)


@pytest.mark.parametrize("device", (
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)))
def test_a_field_modified_in_place_between_calls_reaches_the_next(device):
    """A boundary field and a returned leapfrog level modified in place
    between two calls (the same tensors as the last call's): the next call
    copies them in, and its day is bitwise the eager loop's."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    consts, state = members("physics", device)
    run = TE.make_run_steps_batched(consts, device=device)
    graphs = run.graphs or TE.StepGraphs(consts)
    rhcapl = state["rhcapl"].clone()
    got = want = {**state, "rhcapl": rhcapl}
    for i, (first, n) in enumerate(CALLS):
        ctx = ctx_of("physics", first, n, device)
        got, want = graphs.run(got, ctx), run(want, ctx, eager=True)
        assert_bitwise(got, want)
        if i == 0:
            rhcapl.mul_(1.5)
            for st in (got, want):
                st["vor"][1].mul_(1.0 + 1e-3)
    # After the first call's 5 steps: the pairs, and rhcapl.
    assert graphs.stats["copies"]["in"] == 1 + sum(
        len(got[k]) for k in SG.PAIR_FIELDS)


class _SetFields(BaseCallback):
    """At its interval: the spectral temperature scaled by 1 + 1e-4, a
    warmer slab land (stl_lm, which the coupler rewrites in place) and
    wetter soil (soil_avail_water, which a step copies), through
    Speedy.__setitem__."""

    def __call__(self, model_instance):
        if self.skip_flag(model_instance):
            return
        m = model_instance
        m["t"] = m["t"] * (1.0 + 1e-4)
        m["stl_lm"] = m["stl_lm"] + 0.5
        m["soil_avail_water"] = m["soil_avail_water"] * 1.1


def _speedy(with_plan: bool, callbacks):
    model_ = Speedy(start_date=datetime(1982, 1, 1),
                    end_date=datetime(1982, 1, 1, 4), device="cpu")
    model_.set_bc()
    if with_plan:
        graphs = TE.StepGraphs(model_._consts)
        model_._run = lambda state, ctx, eager=False: graphs.run(state, ctx)
    model_.run(callbacks=callbacks)
    return model_


def test_a_field_set_between_calls_reaches_the_next_call():
    """Speedy, 6 steps in two run calls of 3 through the buffer plan, the
    fields set between them: the same bits as the eager loop given the same
    sets, and not those of the run without them."""
    got = _speedy(True, [_SetFields(interval=3)])
    want = _speedy(False, [_SetFields(interval=3)])
    plain = _speedy(True, [])
    for name in ("t", "vor", "stl_lm", "land_temp", "soil_avail_water",
                 "sst_am", "precnv"):
        assert np.array_equal(got[name], want[name]), name
    assert not np.array_equal(got["t"], plain["t"])
    assert not np.array_equal(got["stl_lm"], plain["stl_lm"])


def _update_args(consts, state):
    """Seeded flux spectra and the spectral update's state arguments."""
    rng = np.random.default_rng(5)
    p = consts.params
    dev = state["vor"][0].device
    pair = (state["vor"][0].shape[0], 2, p.kx, consts.sp.mx, consts.sp.nx)
    specs = [torch.from_numpy(rng.normal(0.0, 1e-6, pair)).to(
        device=dev, dtype=state["vor"][0].dtype)
        for _ in range(6 + 3 * p.ntr)]
    psdt = torch.from_numpy(rng.normal(0.0, 1e-6, pair[:2] + pair[3:])).to(
        device=dev, dtype=state["vor"][0].dtype)
    return specs, SG.update_inputs(state, psdt)


def _dense(state):
    return {k: (tuple(a.contiguous().clone() for a in v)
                if isinstance(v, tuple) else v.contiguous().clone())
            for k, v in state.items()}


def _spectral_update_paths(device):
    consts, state = members("physics", device)
    state = _dense(state)
    specs, args = _update_args(consts, state)
    p = consts.params
    run = lambda out=None: SG.spectral_update(consts, 2, 2 * p.delt, p.rob,
                                              specs, *args, out=out)
    want = run()
    fresh = tuple(torch.empty_like(x) for x in want)
    assert all(a is b for a, b in zip(run(fresh), fresh))
    for a, b in zip(fresh, want):
        assert torch.equal(a, b)
    # In place: the state pairs are their own destination.
    own = [state[name][lev].flatten(2, 3) if name == "tr"
           else state[name][lev] for name in SG.PAIR_FIELDS
           for lev in range(2)]
    for a, b in zip(run(own), want):
        assert torch.equal(a, b)


def _physics_paths(device, sw):
    consts, state = members("physics", device)
    state = _dense(state)
    args, kwargs = PD.physics_grid_inputs(consts, state, sw)
    run = lambda **kw: ck.grid_physics(PD.grid_physics, consts, sw, *args,
                                       **kwargs, **kw)
    want = run()
    out = (tuple(torch.empty_like(x) for x in want[4]),
           tuple(torch.empty_like(x) for x in want[5]))
    got = run(out=out)
    assert all(a is b for a, b in zip((*got[4], *got[5]), (*out[0], *out[1])))
    for a, b in zip((*got[:4], *got[4], *got[5]),
                    (*want[:4], *want[4], *want[5])):
        assert torch.equal(a, b)
    # The state's own cache as the destination: on a step without
    # shortwave the kernel's input itself.
    own = (tuple(torch.empty_like(x) for x in want[4]),
           tuple(state[n] for n in PD.CACHE_FIELDS))
    got = run(out=own)
    for a, b in zip((*got[4], *got[5]), (*want[4], *want[5])):
        assert torch.equal(a, b)


def test_the_spectral_update_destination_is_bitwise():
    _spectral_update_paths("cpu")


@pytest.mark.parametrize("sw", (True, False))
def test_the_physics_destination_is_bitwise(sw):
    _physics_paths("cpu", sw)


def test_the_dispatchers_refuse_a_wrong_destination():
    consts, state = members("physics")
    state = _dense(state)
    specs, args = _update_args(consts, state)
    p = consts.params
    with pytest.raises(ValueError):
        GK.spectral_update_cuda(consts, 2, 2 * p.delt, p.rob, specs, *args,
                                out=(args[1],))
    with pytest.raises(ValueError):
        ck.copy_into((args[1],), (args[1], args[2]))


@pytest.mark.parametrize("n", (1, 7, 8, 64, 100, 128, 256, 1000, 1024))
@pytest.mark.parametrize("preset", ("T30L8", "T47L8", "T63L8", "T30L5"))
def test_pick_member_chunk_chooses_by_grid_size_as_jax_does(n, preset,
                                                           monkeypatch):
    """The port's pick_member_chunk against the JAX package's, their
    widths set alike: the same width for every ensemble size and
    resolution."""
    from pyspeedy_tpu import params as JP
    from pyspeedy_tpu.parallel import ensemble as JE

    monkeypatch.setattr(JE, "MEMBER_CHUNK", TE.MEMBER_CHUNK)
    monkeypatch.setattr(JE, "MEMBER_CHUNK_HIRES", TE.MEMBER_CHUNK_HIRES)
    want = JE.pick_member_chunk(n, getattr(JP, preset))
    assert TE.pick_member_chunk(n, getattr(TP, preset)) == want
    assert TE.pick_member_chunk(n) == JE.pick_member_chunk(n)
    # And with the widths apart, the resolution picks which one.
    monkeypatch.setattr(TE, "MEMBER_CHUNK_HIRES", 8)
    monkeypatch.setattr(JE, "MEMBER_CHUNK_HIRES", 8)
    assert (TE.pick_member_chunk(n, getattr(TP, preset))
            == JE.pick_member_chunk(n, getattr(JP, preset)))
    monkeypatch.setattr(TE, "MEMBER_CHUNK", 8)
    monkeypatch.setattr(JE, "MEMBER_CHUNK", 8)
    assert TE.pick_member_chunk(n) == JE.pick_member_chunk(n)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_the_kernels_store_into_their_destination_on_the_card():
    """The spectral-update and physics kernels with a destination, fresh
    and the state's own (in place), bitwise their launches without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _spectral_update_paths("cuda")
    for sw in (True, False):
        _physics_paths("cuda", sw)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", tuple(CONFIGS))
def test_the_graphs_copy_only_the_coupler_planes_on_the_card(cfg):
    """The CUDA graphs over two calls: bitwise the eager loop, and the
    step graphs copy STEP_COPIES (the explicit branch its pairs besides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    consts, state = members(cfg, "cuda")
    run = TE.make_run_steps_batched(consts, device="cuda")
    got = want = state
    for first, n in CALLS:
        ctx = ctx_of(cfg, first, n, "cuda")
        got, want = run(got, ctx), run(want, ctx, eager=True)
        assert_bitwise(got, want)
    (plan,) = run.graphs.plans.values()
    assert len(plan.graphs) == 4
    for names in plan.copies.values():
        if cfg != "explicit":
            assert set(names) == CP.STEP_COPIES
        assert CP.STEP_COPIES <= set(names)
