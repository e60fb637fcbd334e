"""The port's spans and counters (``pyspeedy_tpu_torch/utils/profiling.py``:
``span``, the span store; ``parallel/ensemble.py``: the runner's spans,
StepGraphs' traced twins and ``stats``) and the benchmark's readers of the
store (``speedy_bench/metrics/``).

On the CPU (float64, T30, two members): a profiled run call, through the
eager loop and through the buffer plan run eagerly, holds every span of
the runner and of the step, nested as SPANS lists them, ``step`` once a
step; without a profiler ``span`` is one shared null context and a run call
leaves the store empty; a span's self time plus its children's is its
total; the copy counters are the bytes of the levels the copy-in and the
clones move, over two calls, the second skipping what the buffers hold;
``trace`` writes the store as spans.json; each reader reads a filled store
and returns None from an empty one (and SPPT's draw without SPPT). Marked
gpu (skipped here): a captured step's span table against its replay's
time, and the same device records in a profiled window of a graph and of
its twin.
"""

import dataclasses
import importlib
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyspeedy_tpu_torch import params as TP
from pyspeedy_tpu_torch.coupling import coupler as CP
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models import spectral_glue as SG
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.testing import make_demo_model
from pyspeedy_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

NMEM = 2
# The parent each span has (the step's under the buffer plan, whose steps
# run where a graph is replayed, and under the eager loop); transforms run
# in the daily forcing too.
PARENTS = {
    "runner.inputs": {"runner.run"}, "runner.copy_in": {"runner.run"},
    "runner.forcing": {"runner.run"}, "runner.step_inputs": {"runner.run"},
    "runner.replay": {"runner.run"}, "runner.capture": {"runner.run"},
    "runner.clone_out": {"runner.run"}, "sppt.draw": {"runner.step_inputs"},
    "step": {"runner.replay", "runner.run"},
    "transforms": {"step", "runner.forcing"}, "grid_dynamics": {"step"},
    "physics": {"step"}, "spectral_update": {"step"}, "coupler": {"step"},
    "step.copies": {"step"}}
# Every span but the card's capture, by mode.
EXPECTED = {
    "graphs": set(P.SPANS) - {"runner.capture"},
    "eager": set(P.SPANS) - {"runner.capture", "runner.copy_in",
                             "runner.replay", "runner.clone_out",
                             "step.copies"}}
READERS = ("coupler_ms_per_step", "step_glue_ms_per_step",
           "runner_copy_ms_per_step", "sppt_draw_ms_per_step",
           "copy_bytes_per_member_step", "capture_s")
_cache = {}


def model(sppt=True):
    if sppt not in _cache:
        _cache[sppt] = make_demo_model(
            dataclasses.replace(TP.T30L8, sppt_on=sppt), device="cpu")
    return _cache[sppt]


def ctx_of(first, n, sppt=True):
    return TM.build_step_ctx(dataclasses.replace(model(sppt)[2]), first,
                             n)[0]


def runner(mode, sppt=True):
    """A run function of `mode`: the buffer plan run eagerly (StepGraphs on
    CPU consts) or the eager loop."""
    consts = model(sppt)[0]
    if mode == "graphs":
        return TE.StepGraphs(consts).run
    return TE.make_run_steps_batched(consts, device="cpu")


def levels(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.fixture(autouse=True)
def empty_store():
    P.reset_spans()
    yield
    P.reset_spans()


def profiled(fn):
    """(fn's result, the host ranges of the spans: [(name, start, end)])."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in P.SPANS]
    return out, ranges


def parent_of(rng, ranges):
    """The name of the innermost span range that holds `rng`."""
    name, t0, t1 = rng
    best = None
    for other in ranges:
        if other is rng:
            continue
        _, s0, s1 = other
        if s0 <= t0 and t1 <= s1 and (best is None or s0 >= best[1]):
            best = other
    return best[0] if best else None


@pytest.mark.parametrize("mode", ("graphs", "eager"))
def test_a_profiled_run_call_holds_every_span_nested(mode):
    """Steps 33-36 (step 36 starts a day: the daily forcing) of two SPPT
    members: every span of the mode, each inside its parent, `step` once a
    step in the trace and in the store, three transform groups a step, one
    run call."""
    run = runner(mode)
    state = TE.broadcast_state(model()[1], NMEM)
    _, ranges = profiled(lambda: run(state, ctx_of(33, 4)))
    names = [r[0] for r in ranges]
    assert set(names) == EXPECTED[mode]
    assert names.count("step") == 4 and names.count("runner.run") == 1
    for rng in ranges:
        if rng[0] != "runner.run":
            assert parent_of(rng, ranges) in PARENTS[rng[0]], rng[0]
    # Every transform of a step passes through the span: three groups.
    assert sum(1 for r in ranges if r[0] == "transforms"
               and parent_of(r, ranges) == "step") == 3 * 4
    tot = P.span_totals()
    assert set(tot["spans"]) == EXPECTED[mode]
    assert tot["spans"]["step"]["count"] == 4
    assert tot["steps"] == 4 and tot["member_steps"] == 4 * NMEM
    assert tot["members"] == NMEM


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = P.span("step"), P.span("coupler", call=1)
    assert a is b
    with a:
        pass


@pytest.mark.parametrize("mode", ("graphs", "eager"))
def test_a_run_call_without_a_profiler_leaves_the_store_empty(mode):
    run = runner(mode)
    run(TE.broadcast_state(model()[1], NMEM), ctx_of(33, 2))
    assert P._pending == P._tables == P._stack == []
    tot = P.span_totals()
    assert tot["spans"] == {}
    assert tot["steps"] == tot["member_steps"] == tot["bytes_in"] == 0


def test_self_plus_children_is_the_total_of_nested_spans():
    """Host-clock spans (the CPU): an outer span around two inner ones and a
    wait of its own; its self time is the wait."""
    def block():
        with P.span("step"):
            with P.span("coupler"):
                time.sleep(0.01)
            with P.span("physics"):
                time.sleep(0.02)
            time.sleep(0.03)
    profiled(block)
    s = P.span_totals()["spans"]
    kids = s["coupler"]["ms"] + s["physics"]["ms"]
    assert s["step"]["self_ms"] + kids == pytest.approx(s["step"]["ms"])
    assert s["coupler"]["self_ms"] == s["coupler"]["ms"] >= 10.0
    assert 30.0 <= s["step"]["self_ms"] < s["step"]["ms"] - 30.0


def test_self_plus_children_is_the_total_in_a_run_call():
    """A profiled call with no daily forcing (steps 37-39): the step's,
    the draw's and the run call's self time plus their children's."""
    run = runner("graphs")
    state = TE.broadcast_state(model()[1], NMEM)
    profiled(lambda: run(state, ctx_of(37, 3)))
    s = P.span_totals()["spans"]
    for parent in ("step", "runner.step_inputs", "runner.run",
                   "runner.replay"):
        kids = sum(v["ms"] for k, v in s.items()
                   if parent in PARENTS.get(k, ()) and
                   (k, parent) != ("step", "runner.run"))
        assert s[parent]["self_ms"] + kids == pytest.approx(
            s[parent]["ms"], rel=1e-9), parent
        assert s[parent]["self_ms"] >= 0.0


def copy_bytes(plan, names, parity=0):
    """Bytes of the levels of `names` in the plan's buffers of set
    `parity` (one plane for a field held as one)."""
    return sum(TE._base(buf).nbytes for name in names
               for buf in levels(plan.states[parity][name]))


def test_the_copy_counters_are_the_bytes_of_the_levels_copied():
    """Two calls of 5 and 4 steps, the second given what the first
    returned: the copy-in moves every level but the aliases' first, then
    the leapfrog pairs alone (held in set 1 after an odd number of steps);
    the clones move every field the steps write, each call; each step copies
    its coupler rows and weights and the SPPT noise. Under a profiler the
    store counts the same bytes."""
    graphs = TE.StepGraphs(model()[0])
    state = TE.broadcast_state(model()[1], NMEM)
    state = graphs.run(state, ctx_of(33, 5))
    (plan,) = graphs.plans.values()
    every = [k for k in plan.states[0] if k not in CP.ALIASES]
    written = sorted((TM.DYNAMIC_FIELDS | plan.written)
                     & plan.states[0].keys() - CP.ALIASES.keys())
    per_step = (plan.coupler.rows.nbytes + plan.coupler.w.nbytes
                + plan.sppt_se.nbytes)
    st = graphs.stats
    assert st["bytes_in"] == copy_bytes(plan, every)
    first_out = copy_bytes(plan, written, 1)
    assert st["bytes_out"] == first_out
    assert st["bytes_inputs"] == 5 * per_step
    before = dict(st)
    profiled(lambda: graphs.run(state, ctx_of(38, 4)))
    pairs = copy_bytes(plan, SG.PAIR_FIELDS)
    assert st["bytes_in"] - before["bytes_in"] == pairs
    assert st["bytes_out"] - before["bytes_out"] == copy_bytes(plan, written)
    assert st["bytes_inputs"] - before["bytes_inputs"] == 4 * per_step
    assert st["steps"] == 9 and st["member_steps"] == 9 * NMEM
    tot = P.span_totals()
    assert (tot["bytes_in"], tot["bytes_out"], tot["bytes_inputs"]) == (
        pairs, copy_bytes(plan, written), 4 * per_step)
    assert tot["member_steps"] == 4 * NMEM


def test_trace_writes_the_span_table(tmp_path):
    run = runner("eager")
    state = TE.broadcast_state(model()[1], NMEM)
    with P.trace(str(tmp_path)) as log_dir:
        run(state, ctx_of(37, 2))
    with open(os.path.join(log_dir, P.SPANS_FILE)) as f:
        table = json.load(f)
    assert table["steps"] == 2
    assert table["spans"]["step"]["count"] == 2
    assert set(table["spans"]) == EXPECTED["eager"] - {"runner.forcing"}


def reader(name):
    return importlib.import_module(f"speedy_bench.metrics.{name}").read


def want(name, t):
    """What reader `name` reads from the store `t`."""
    s, n = t["spans"], t["steps"]
    return {
        "coupler_ms_per_step": s["coupler"]["ms"] / n,
        "step_glue_ms_per_step": s["step"]["self_ms"] / n,
        "runner_copy_ms_per_step": (s["runner.copy_in"]["ms"]
                                    + s["runner.clone_out"]["ms"]) / n,
        "sppt_draw_ms_per_step": s["sppt.draw"]["ms"] / n,
        "copy_bytes_per_member_step": (t["bytes_in"] + t["bytes_out"]
                                       + t["bytes_inputs"])
        / t["member_steps"],
        "capture_s": t["capture_s"]}[name]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_a_filled_store(name):
    """A profiled SPPT call of the buffer plan, and one capture of 0.25 s
    counted as the card's runner counts it."""
    run = runner("graphs")
    profiled(lambda: run(TE.broadcast_state(model()[1], NMEM),
                         ctx_of(37, 3)))
    P.record_capture(0.25)
    t = P.span_totals()
    got = reader(name)(None)
    assert got == pytest.approx(want(name, t)) and got > 0.0
    if name == "capture_s":
        assert got == 0.25


@pytest.mark.parametrize("name", READERS)
def test_a_reader_of_an_empty_store_reads_nothing(name):
    P.record_capture(0.25)
    assert reader(name)(None) is None


def test_the_draw_reader_reads_nothing_without_sppt():
    run = runner("graphs", sppt=False)
    profiled(lambda: run(TE.broadcast_state(model(False)[1], NMEM),
                         ctx_of(37, 2, sppt=False)))
    assert P.span_totals()["steps"] == 2
    assert reader("sppt_draw_ms_per_step")(None) is None
    assert reader("coupler_ms_per_step")(None) > 0.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def card_runner(nmem):
    """(the card's batched runner, a state of nmem members, its calendar)
    after two run calls of 6 steps (every graph key captured)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    consts, state1, cal = make_demo_model(TP.T30L8, device="cuda",
                                          precision="f32")
    run = TE.make_run_steps_batched(consts, device="cuda")
    state = TE.broadcast_state(state1, nmem)
    ctx = TM.build_step_ctx(dataclasses.replace(cal), 37, 6)[0]
    state = run(state, ctx)
    state = run(state, ctx)
    torch.cuda.synchronize()
    return run, state, cal


def timed_ms(fn, reps=1):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


@pytest.mark.gpu
def test_a_twin_span_table_sums_to_its_replay():
    """Needs an NVIDIA GPU: at 1,024 members, each key's twin replayed
    alone: its top span (`step`) within 2 % of the replay's time from
    events around it, and the step's children within the step."""
    run, _, _ = card_runner(1024)
    (plan,) = run.graphs.plans.values()
    assert set(plan.twins) == set(plan.graphs) and len(plan.graphs) == 4
    for key, (twin, table) in plan.twins.items():
        twin.replay()
        outer = timed_ms(twin.replay)
        top = [r for r in table if r[1] is None]
        assert [r[0] for r in top] == ["step"]
        inner = sum(P._elapsed_ms(s, e) for _, _, s, e in top)
        assert inner == pytest.approx(outer, rel=0.02), key
        kids = sum(P._elapsed_ms(s, e) for n, par, s, e in table
                   if par == "step")
        assert 0.0 < kids < inner
        names = [r[0] for r in table]
        assert names.count("transforms") == 3
        assert {"grid_dynamics", "physics", "spectral_update", "coupler",
                "step.copies"} <= set(names)


@pytest.mark.gpu
def test_a_twin_adds_no_device_record():
    """Needs an NVIDIA GPU: a profiled window of 3 replays of a key's graph
    and of its twin hold the same device records by name."""
    from torch.autograd import DeviceType

    run, _, _ = card_runner(64)
    (plan,) = run.graphs.plans.values()
    counts = []
    for graph in (plan.graphs[(True, 0)], plan.twins[(True, 0)][0]):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                graph.replay()
            torch.cuda.synchronize()
        by = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and \
                    not e.is_user_annotation():
                by[e.name()] = by.get(e.name(), 0) + 1
        counts.append(by)
    assert counts[0] == counts[1] and sum(counts[0].values()) > 3 * 6


@pytest.mark.gpu
def test_a_profiled_call_on_the_card_counts_its_twins():
    """Needs an NVIDIA GPU: a profiled call of 4 steps on the graphs holds
    every span but the capture, `step` once a step (each key's twin counted
    for its replays), each span's self time at least 0."""
    run, state, cal = card_runner(64)
    ctx = TM.build_step_ctx(dataclasses.replace(cal), 41, 4)[0]
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(state, ctx)
        torch.cuda.synchronize()
    tot = P.span_totals()
    assert set(tot["spans"]) == EXPECTED["graphs"] - {"sppt.draw",
                                                      "runner.forcing"}
    assert tot["spans"]["step"]["count"] == 4 and tot["steps"] == 4
    assert all(v["self_ms"] >= -1e-3 for v in tot["spans"].values())
