"""The batched runner's CUDA-graph mode of ``pyspeedy_tpu_torch``
(parallel/ensemble.py::StepGraphs) and what it rests on.

On the CPU: the device-table forms of the coupler's interpolations are
bitwise the scalar formulas; the runner's buffer plan, run eagerly
(StepGraphs on CPU consts: step_body where a graph would be replayed, the
function the graphs record), is bitwise the eager loop over a T30 day with
the physics, with SPPT and on the explicit branch (the same day against the
JAX package's batched runner is tests/test_torch_graphs_jax.py, a file of
its own so that the test processes share the two files' time); a returned
state is not overwritten by the next call, a field written between calls
reaches it, and a sweep over member widths keeps the last few layouts'
buffers only.
On the card (marked gpu, skipped here): the graphs' day bitwise the eager
day, a member alone bitwise that member in a batch, a width sweep
dropping old graphs, a failed capture raising.

Tolerances against JAX are relative to each field's largest absolute value,
as in tests/test_torch_step.py: 1e-8 over a run of more than a day's steps
(the order of sums differs, and the leapfrog carries the difference along).
JAX is imported inside the tests that compare with it, so that
`python -m pytest tests/test_torch_graphs.py -m gpu` runs on the card's
machine; its integrators are built once per file.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.coupling import interpolation as TI
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8

torch.set_num_threads(1)

PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
CONFIGS = {"physics": {}, "sppt": {"sppt_on": True},
           "explicit": {"alph": 0.0, "nsteps": 144}}
N_STEPS = 36
NMEM = 2
_cache = {}


def jx():
    """The JAX package's modules, imported at first use."""
    if "jx" not in _cache:
        import jax
        from pyspeedy_tpu.models import model as JM
        from pyspeedy_tpu.parallel import ensemble as JE
        from pyspeedy_tpu.params import T30L8
        from pyspeedy_tpu.testing import make_demo_model
        _cache["jx"] = types.SimpleNamespace(
            jax=jax, JM=JM, JE=JE, T30L8=T30L8,
            make_demo_model=make_demo_model)
    return _cache["jx"]


def models(cfg):
    """(JAX consts, state, calendar; the port's consts; the JAX state
    carried over to the port) of configuration `cfg`, built once."""
    key = ("models", cfg)
    if key not in _cache:
        J = jx()
        jconsts, jstate, jcal = J.make_demo_model(
            dataclasses.replace(J.T30L8, **CONFIGS[cfg]))
        tconsts, _ = TM.build_consts(
            dataclasses.replace(T_T30L8, **CONFIGS[cfg]), device="cpu")
        tstate = interop.state_from_numpy(
            J.jax.tree.map(np.asarray, jstate), device="cpu",
            dtype=torch.float64)
        _cache[key] = (jconsts, jstate, jcal, tconsts, tstate)
    return _cache[key]


def noise(p, seed=7):
    """Seeded temperature noise of 0.01 K for member 1 (member 0 none),
    inside the truncation triangle, real at m = 0."""
    rng = np.random.default_rng(seed)
    tri = (np.arange(p.mx)[:, None] + np.arange(p.nx)[None, :] <= p.trunc)
    x = 1e-2 * rng.standard_normal((NMEM, 2, p.kx, p.mx, p.nx)) * tri
    x[0] = 0.0
    x[:, 1, :, 0, :] = 0.0
    return x


def perturbed(state, broadcast, x, to):
    st = broadcast(state, NMEM)
    st["t"] = (st["t"][0] + to(x), st["t"][1] + to(x))
    return st


def torch_inputs(cfg):
    _, _, jcal, tconsts, tstate = models(cfg)
    tb = perturbed(tstate, TE.broadcast_state, noise(tconsts.params),
                   torch.from_numpy)
    ctx, _ = TM.build_step_ctx(dataclasses.replace(jcal), 2, N_STEPS)
    return tconsts, tb, ctx


def eager_day(cfg):
    key = ("eager", cfg)
    if key not in _cache:
        tconsts, tb, ctx = torch_inputs(cfg)
        _cache[key] = TE.make_run_steps_batched(tconsts, device="cpu")(
            tb, ctx)
    return _cache[key]


def plan_day(cfg):
    key = ("plan", cfg)
    if key not in _cache:
        tconsts, tb, ctx = torch_inputs(cfg)
        _cache[key] = TE.StepGraphs(tconsts).run(tb, ctx)
    return _cache[key]


def levels(v):
    return v if isinstance(v, tuple) else (v,)


def assert_bitwise(got, want):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for name in want:
        for g, w in zip(levels(got[name]), levels(want[name]), strict=True):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert torch.equal(g, w), name


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


# ---------------------------------------------------------------------------
# The interpolations' table forms
# ---------------------------------------------------------------------------

TMONTHS = (0.0, 0.2, 0.5, 0.5 + 1e-9, 0.75, 29.0 / 30.0)


@pytest.mark.parametrize("imon", (1, 6, 12))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64),
                         ids=("f32", "f64"))
def test_table_forms_are_bitwise_the_scalar_forms(dtype, imon):
    """forint_t (with monthly_weights' rows and weight, monthly_interp's
    table form) and forin5_t with the host's rows and the weights rounded to
    the field's dtype give the scalar formulas' bits, on
    both sides of tmonth = 0.5; so does CouplerTables from coupler_rows.
    The SST anomaly record is read at its first and last slab."""
    rng = np.random.default_rng(imon)
    for12 = torch.from_numpy(280.0 + 10.0 * rng.standard_normal(
        (12, 6, 8))).to(dtype)
    n_rec = 5
    anom = torch.from_numpy(rng.standard_normal((n_rec, 6, 8))).to(dtype)
    w_t = lambda w: torch.tensor(w, dtype=torch.float64).to(dtype)
    for tm in TMONTHS:
        i0, i2, w = TI.forint_weights(imon, tm)
        assert torch.equal(
            TI.forint_t(for12, torch.tensor([i0, i2]), w_t(w)),
            TI.forint(for12, imon, tm)), tm
        rows, ws = TI.forin5_weights(imon, tm)
        assert torch.equal(
            TI.forin5_t(for12, torch.tensor(rows), w_t(ws)),
            TI.forin5(for12, imon, tm)), tm
        for month_idx in (0, n_rec - 1):
            j0, j2, wj = TI.monthly_weights(month_idx, tm)
            if not 0 <= j2 < n_rec:
                continue
            assert torch.equal(
                TI.forint_t(anom, torch.tensor([j0, j2]), w_t(wj)),
                TI.monthly_interp(anom, month_idx, tm)), (month_idx, tm)
        month_idx = 0 if tm > 0.5 else n_rec - 1
        tab = TI.CouplerTables.from_host(
            *TI.coupler_rows(imon, tm, month_idx), n_rec, dtype, "cpu")
        assert torch.equal(tab.forin5(for12), TI.forin5(for12, imon, tm))
        assert torch.equal(tab.forint(for12), TI.forint(for12, imon, tm))
        assert torch.equal(tab.sst_anom(anom),
                           TI.monthly_interp(anom, month_idx, tm))


def test_sst_anomaly_rows_past_the_record_raise():
    """A date past the SST anomaly record raises IndexError when the tables
    are made, as the scalar form raises it when it indexes."""
    rows, w = TI.coupler_rows(2, 0.75, 3)
    with pytest.raises(IndexError):
        TI.CouplerTables.from_host(rows, w, 4, torch.float64, "cpu")
    with pytest.raises(IndexError):
        TI.monthly_interp(torch.zeros(4, 2, 2), 3, 0.75)
    TI.CouplerTables.from_host(rows, w, 5, torch.float64, "cpu")


def test_coupler_tables_follow_the_step_dates():
    """coupler_tables holds coupler_rows at each step's advanced date
    (imont1, tmonth, month_idx of the ctx), the weights rounded to the
    model dtype, and the JAX package's ctx gives the same tables (the
    runner takes either)."""
    J = jx()
    _, _, jcal, tconsts, tstate = models("physics")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(jcal), 2, 40)
    jctx, _ = J.JM.build_step_ctx(dataclasses.replace(jcal), 2, 40)
    tab = TM.coupler_tables(tconsts, tstate, ctx)
    assert tab.rows.shape == (40, TI.N_COUPLER_ROWS)
    assert tab.w.shape == (40, TI.N_COUPLER_WEIGHTS)
    assert tab.w.dtype == tconsts.params.dtype
    for i in range(40):
        rows, w = TI.coupler_rows(int(ctx["imont1"][i]),
                                  float(ctx["tmonth"][i]),
                                  int(ctx["month_idx"][i]))
        assert np.array_equal(tab.rows[i].numpy(), rows)
        assert np.array_equal(tab.w[i].numpy(), w)
    jtab = TM.coupler_tables(tconsts, tstate, jctx)
    assert torch.equal(jtab.rows, tab.rows) and torch.equal(jtab.w, tab.w)


# ---------------------------------------------------------------------------
# The buffer plan, eagerly, on the CPU
# ---------------------------------------------------------------------------

def test_the_cpu_takes_the_eager_loop():
    """Graphs on a CUDA device without a mesh only: the CPU runner has
    none, and a mesh keeps the loop on the card too."""
    tconsts = models("physics")[3]
    assert TE.make_run_steps_batched(tconsts, device="cpu").graphs is None
    assert TE.takes_graphs("cuda") and not TE.takes_graphs("cpu")
    assert not TE.takes_graphs("cuda", mesh=object())


@pytest.mark.parametrize("cfg", tuple(CONFIGS))
def test_buffer_plan_is_bitwise_the_eager_loop(cfg):
    """A T30 day (36 steps from step 2, the daily forcing at step 36) of
    two distinct members through the buffer plan equals the eager loop bit
    for bit, every field of the state, with the physics, with SPPT and on
    the explicit branch."""
    got, want = plan_day(cfg), eager_day(cfg)
    assert_bitwise(got, want)
    assert not bool(got["error_flag"].any())
    t = got["t"][0]
    assert float((t[1] - t[0]).abs().max()) > 1e-4


def test_a_returned_state_outlives_the_next_call():
    """The runner's buffers are written by every call: the state one call
    returns is its own (cloned out), so the next call, from it, leaves it
    as it was; and the plan is reused across calls of one layout."""
    tconsts, tb, ctx = torch_inputs("physics")
    graphs = TE.StepGraphs(tconsts)
    first, rest = ({k: v[:3] for k, v in ctx.items()},
                   {k: v[3:6] for k, v in ctx.items()})
    out1 = graphs.run(tb, first)
    kept = {k: tuple(a.clone() for a in levels(v)) for k, v in out1.items()}
    out2 = graphs.run(out1, rest)
    for name, v in out1.items():
        for a, b in zip(levels(v), kept[name]):
            assert torch.equal(a, b), name
    assert len(graphs.plans) == 1
    assert not torch.equal(out2["t"][0], out1["t"][0])
    # Two calls equal one call of both windows, bit for bit.
    whole = TE.StepGraphs(tconsts).run(
        tb, {k: v[:6] for k, v in ctx.items()})
    assert_bitwise(out2, whole)


def test_a_field_written_between_calls_reaches_the_next():
    """A field the caller writes between two calls (as Speedy.__setitem__
    does) is read by the second: the buffer plan gives what the eager loop
    gives from the same written state, and not what it gives without the
    write; a shared field (the land-sea mask of the SST) as well."""
    tconsts, tb, ctx = torch_inputs("physics")
    first, rest = ({k: v[:3] for k, v in ctx.items()},
                   {k: v[3:6] for k, v in ctx.items()})
    graphs = TE.StepGraphs(tconsts)
    eager = TE.make_run_steps_batched(tconsts, device="cpu")
    out1 = graphs.run(tb, first)
    untouched = graphs.run(out1, rest)
    written = dict(out1)
    x = torch.from_numpy(noise(tconsts.params, seed=11))
    written["t"] = tuple(a + x for a in out1["t"])
    written["sst12"] = out1["sst12"] + 1.0
    got = graphs.run(written, rest)
    assert_bitwise(got, eager(written, rest))
    assert not torch.equal(got["t"][0], untouched["t"][0])
    assert not torch.equal(got["sst_om"], untouched["sst_om"])


def test_a_narrower_call_gets_its_own_buffers():
    """Two member widths through one runner: a layout each, the same bits
    as the eager loop at either width."""
    tconsts, tb, ctx = torch_inputs("physics")
    window = {k: v[:4] for k, v in ctx.items()}
    graphs = TE.StepGraphs(tconsts)
    eager = TE.make_run_steps_batched(tconsts, device="cpu")
    one = TE.broadcast_state(models("physics")[4], 1)
    assert_bitwise(graphs.run(tb, window), eager(tb, window))
    assert_bitwise(graphs.run(one, window), eager(one, window))
    assert len(graphs.plans) == 2


def test_a_width_sweep_keeps_the_last_plans_only():
    """A sweep over member widths through one runner keeps the buffer plans
    of its last StepGraphs.MAX_PLANS layouts, the least recently used
    dropped first; a width called again after its plan was dropped gets a
    new plan, with the eager loop's bits."""
    tconsts, _, ctx = torch_inputs("physics")
    window = {k: v[:1] for k, v in ctx.items()}
    graphs = TE.StepGraphs(tconsts)
    eager = TE.make_run_steps_batched(tconsts, device="cpu")
    state1 = models("physics")[4]
    bound = TE.StepGraphs.MAX_PLANS
    widths = list(range(1, bound + 3))
    for w in widths:
        graphs.run(TE.broadcast_state(state1, w), window)
        assert len(graphs.plans) == min(w, bound)
    width_of = lambda: [layout[0] for layout in graphs.plans]
    assert width_of() == widths[-bound:]
    graphs.run(TE.broadcast_state(state1, widths[-bound]), window)
    assert width_of() == widths[-bound + 1:] + [widths[-bound]]
    one = TE.broadcast_state(state1, 1)
    assert_bitwise(graphs.run(one, window), eager(one, window))
    assert width_of() == widths[-bound + 2:] + [widths[-bound], 1]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def card_model(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from pyspeedy_tpu_torch.testing import make_demo_model
    return make_demo_model(T_T30L8, device="cuda", precision="f32", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", tuple(CONFIGS))
def test_graph_day_is_bitwise_the_eager_day(cfg):
    """Needs an NVIDIA GPU and nvcc: a day of 4 distinct members, T30 f32,
    through the graphs and through the eager loop of the same runner,
    every field bitwise; a second call replays without capturing (four
    graphs: the shortwave kinds by the two parities of the pair's
    buffers)."""
    consts, state1, cal = card_model(**CONFIGS[cfg])
    run = TE.make_run_steps_batched(consts, device="cuda")
    st = TE.broadcast_state(state1, 4)
    x = torch.from_numpy(noise(consts.params, seed=3)).to("cuda",
                                                          torch.float32)
    st["t"] = tuple(a + torch.cat([x, x]) for a in st["t"])
    n = consts.params.nsteps
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, n)
    assert_bitwise(run(st, ctx), run(st, ctx, eager=True))
    captures = run.graphs.stats["captures"]
    assert captures == 4
    assert_bitwise(run(st, ctx), run(st, ctx, eager=True))
    assert run.graphs.stats["captures"] == captures


@pytest.mark.gpu
def test_a_member_alone_is_bitwise_that_member_in_a_batch():
    """Needs an NVIDIA GPU and nvcc: under the graphs, member 1 of a batch
    of 4 distinct members and the same member run alone, a day, bitwise."""
    consts, state1, cal = card_model()
    run = TE.make_run_steps_batched(consts, device="cuda")
    st = TE.broadcast_state(state1, 4)
    x = torch.from_numpy(noise(consts.params, seed=5)).to("cuda",
                                                          torch.float32)
    st["t"] = tuple(a + torch.cat([x, x]) for a in st["t"])
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 36)
    many = run(st, ctx)
    alone = run({k: (tuple(a[1:2] for a in v) if isinstance(v, tuple)
                     else v[1:2]) if k in TM.CARRY_FIELDS else v
                 for k, v in st.items()}, ctx)
    for name in PROGNOSTICS + ("phi", "precnv", "hfluxn", "sst_om"):
        for a, b in zip(levels(many[name]), levels(alone[name])):
            assert torch.equal(a[1:2], b), name


@pytest.mark.gpu
def test_a_width_sweep_on_the_card_drops_old_graphs():
    """Needs an NVIDIA GPU and nvcc: a sweep over more member widths than
    StepGraphs.MAX_PLANS through one runner keeps the last plans only (their
    graphs with them); a width whose plan was dropped is captured again and
    gives the eager loop's bits."""
    consts, state1, cal = card_model()
    run = TE.make_run_steps_batched(consts, device="cuda")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 2)
    bound = TE.StepGraphs.MAX_PLANS
    for w in range(1, bound + 2):
        run(TE.broadcast_state(state1, w), ctx)
        assert len(run.graphs.plans) == min(w, bound)
    captures = run.graphs.stats["captures"]
    one = TE.broadcast_state(state1, 1)
    assert_bitwise(run(one, ctx), run(one, ctx, eager=True))
    # steps 2 and 3: (no shortwave, parity 0), (shortwave, parity 1)
    assert run.graphs.stats["captures"] == captures + 2
    assert len(run.graphs.plans) == bound


@pytest.mark.gpu
def test_a_failed_capture_raises(monkeypatch):
    """Needs an NVIDIA GPU and nvcc: a step that reads a device value back
    cannot be captured; the runner raises and does not fall back to the
    eager loop."""
    consts, state1, cal = card_model()
    run = TE.make_run_steps_batched(consts, device="cuda")
    real = TM.check_diagnostics

    def syncing(consts, state, time_lev):
        bad = real(consts, state, time_lev)
        if bool(bad.any()):     # a host sync: illegal while capturing
            raise AssertionError("unexpected blow-up")
        return bad

    monkeypatch.setattr(TM, "check_diagnostics", syncing)
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 3)
    with pytest.raises(RuntimeError):
        run(TE.broadcast_state(state1, 2), ctx)
    torch.cuda.synchronize()
