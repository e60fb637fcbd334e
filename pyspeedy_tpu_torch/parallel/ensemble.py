"""Batched ensemble execution: the counterpart of the reference's OpenMP
`parallel_step` loop over ensemble members.

Members form a leading batch axis on every carried state tensor; one step
advances all members at once (the transforms become bigger matrix products,
the grid-dynamics and physics kernels one launch each over all columns of all
members). The JAX package's shortwave-aligned scan (prefix, scan of
shortwave-first step triples, tail) exists to keep the radiation cache out of
a scan carry and the per-step diagnostics out of a jitted signature; here the
runner steps through any number of steps from any phase of the shortwave
cadence, in one of two modes with the same bits:

- on a CUDA device without a mesh it replays CUDA graphs of the step
  (StepGraphs): the counterpart of the JAX runner's single dispatch, one
  graph launch a step instead of every kernel and elementwise pass of the
  step enqueued from the host;
- on the CPU, with a mesh, or when the caller asks for it (eager=True) it is
  an eager Python loop over the steps.

On an ("ensemble", "space") mesh (parallel/mesh.py) each rank runs the same
loop on its piece of the state (shard_ensemble, or
parallel/distributed.py::make_global_ensemble): its ensemble row's members
and, when "space" has several ranks, its latitude band, with the band's
Consts (models/model.py::shard_consts), whose direct transforms sum over the
bands with one all_reduce a group (parallel/shard_transforms.py).
"""

from __future__ import annotations

import time
import weakref

import torch
import torch.distributed as dist

from .. import resolve_device
from ..coupling.coupler import ALIASES, SHARED_PLANES
from ..coupling.interpolation import (N_COUPLER_ROWS, N_COUPLER_WEIGHTS,
                                      CouplerTables)
from ..models import model as M
from ..models import spectral_glue as SG
from ..physics import sppt as SP
from .mesh import local_shard

__all__ = ["broadcast_state", "make_run_steps_batched", "pick_member_chunk",
           "shard_ensemble", "takes_graphs", "StepGraphs", "MEMBER_CHUNK",
           "MEMBER_CHUNK_HIRES"]

# Member chunk widths, by grid size: the widths at which the batched
# runner's graphs advance a large ensemble fastest on the card
# (`python -m pyspeedy_tpu_torch.bench --sweep`, float32, NVIDIA H100 80GB
# HBM3 at 700 W). Shared by SpeedyEns, the bench and the large-ensemble
# example. T30, 1,024 members: 85.6k member-steps/s in chunks of 1,024,
# against 82.3k (512), 78.9k (256), 68.6k (128) and 54.7k (64); the card is
# busy 96-98 % from 512 on, and the wider chunk makes fewer host calls.
MEMBER_CHUNK = 1024
# Grids larger than T30's, 512 members, rows 3-4 on their T47/T63 kernels:
# T47 31.6k member-steps/s in chunks of 256 against 31.1k (512), 29.6k
# (128), 26.2k (64); T63 17.3k at 512 against 17.0k (256), 16.1k (128),
# 15.4k (64). One width serves both: 256, within 1.4 % of either grid's
# fastest (512 is 1.8 % under T47's) and with less memory a member.
MEMBER_CHUNK_HIRES = 256
_T30_GRID_POINTS = 96 * 48


def pick_member_chunk(n_members: int, params=None) -> int:
    """Chunk width for an n-member ensemble run in member chunks: the
    width for the resolution of `params` (MEMBER_CHUNK at T30's grid or a
    smaller one, MEMBER_CHUNK_HIRES above it; MEMBER_CHUNK without params)
    when it divides the ensemble evenly; else the whole ensemble."""
    target = MEMBER_CHUNK
    if params is not None and params.ix * params.il > _T30_GRID_POINTS:
        target = MEMBER_CHUNK_HIRES
    if n_members > target and n_members % target == 0:
        return target
    return n_members


def broadcast_state(state: dict, n_members: int) -> dict:
    """Member-batch a single-member state: only the carried fields
    (DYNAMIC_FIELDS - EPHEMERAL_FIELDS) get a leading member axis;
    loop-invariant fields (climatologies, masks, orography...) stay shared
    across members, and so do the per-step physics diagnostics
    (EPHEMERAL_FIELDS): with the physics off nothing writes them, with the
    physics on every step rewrites them member-batched before anything reads
    them. The member axis is an expanded view, so unperturbed members cost
    no memory until the first step. With SPPT each member gets its own noise
    key, jax.random.split of the state's key (member i's key is the key
    folded with i), so members diverge through the stochastic physics
    alone, as in the JAX package."""
    out = M.add_member_axis(state, n_members)
    if "sppt_key" in state:
        out["sppt_key"] = SP.split_keys(state["sppt_key"], n_members)
    return out


def takes_graphs(device, mesh=None) -> bool:
    """Whether make_run_steps_batched on `device` (and `mesh`) replays CUDA
    graphs: on a CUDA device without a mesh. The CPU and a mesh take the
    eager loop (the band route's all_reduce over gloo cannot be captured)."""
    return torch.device(device).type == "cuda" and mesh is None


def make_run_steps_batched(consts, device="cuda", mesh=None,
                           shard_space: bool = True):
    """n-step integrator over a member-batched state (leading member axis on
    the carried fields only): run(state, ctx, eager=False) -> state, with
    ctx from models.model.build_step_ctx. Nothing in it reads a device value
    back, so the host runs ahead of the card. state["error_flag"]
    accumulates per member on the device; read it once after the run.

    With the physics on, each step runs in this order: the daily forcing
    when the step starts a day, the step itself with the shortwave variant
    of the physics on steps with stepno % 3 == 0, the coupler at the date
    the step reaches (its month rows and weights moved to the device once
    per run call: models.model.coupler_tables). The 7 radiation cache
    fields live member-batched in the state between steps; the per-step
    diagnostics (EPHEMERAL_FIELDS) come back member-batched and current,
    whether they came in shared (from broadcast_state) or batched (from an
    earlier run).

    On a CUDA device without a mesh (takes_graphs) a run call replays CUDA
    graphs of the step (StepGraphs: captured at the first step of each
    shortwave kind and parity of the leapfrog pair's buffers and state
    layout, kept by this runner for its later calls in its last
    StepGraphs.MAX_PLANS layouts); run(..., eager=True) takes the eager
    loop instead, with the
    same kernels in the same order and so the same bits. A failed capture
    or replay raises: there is no quiet return to the eager loop. The CPU
    and a mesh always take the eager loop. `run.graphs` is the runner's
    StepGraphs, or None where it takes the eager loop.

    The runner keeps the consts' flags: with consts.bf16_tendencies every
    step here runs the bfloat16 instantiations of the kernels (the
    initialization, which made the state, did not).

    With params.sppt_on (and the physics on) the noise is drawn grouped as
    the JAX package's batched runner groups it (physics/sppt.py::sppt_groups),
    so the same member keys give the JAX package's patterns, in chunks of
    many steps (physics/sppt.py::draw_run_noise: one vectorised pass each, a
    whole run call at the model's sizes), the next chunk when the last is
    used up, so the noise held stays bounded however long the run; each
    step takes its slice (sppt_se), through a static buffer on the graphs.

    `device` must be the one the consts were built on.

    With a `mesh`, run takes and returns this rank's piece of the state
    (shard_ensemble's layout, the same `shard_space`): the members of its
    ensemble row and, with shard_space and more than one rank on "space",
    its latitude band, stepped with the band's Consts. The bands' SPPT
    noise is each member's own and the same on every band. error_flag is
    per band: it is ORed over "space" once, at the end of the run. Without
    a mesh, or with one rank on "space", the step is the unsharded one."""
    device = resolve_device(device)
    if device.type != consts.device.type:
        raise ValueError(
            f"consts were built on {consts.device}, runner asked for {device}")
    if mesh is not None and shard_space:
        consts = M.shard_consts(consts, mesh)
    space_group = consts.sp.band.group if consts.sp.band else None
    graphs = StepGraphs(consts) if takes_graphs(device, mesh) else None
    single_step = M.make_single_step(consts)

    def run(state, ctx, eager: bool = False):
        if graphs is not None and not eager:
            return graphs.run(state, ctx)
        state, tables, noise = _run_inputs(consts, state, ctx)
        for i in range(len(ctx["stepno"])):
            # ctx_i is rebound before the next draw, so a used chunk of
            # noise is freed before the next one is made.
            ctx_i = {k: v[i] for k, v in ctx.items()}
            ctx_i["coupler"] = CouplerTables(tables.rows[i], tables.w[i])
            if noise is not None:
                ctx_i["sppt_se"] = next(noise)
            state = single_step(state, ctx_i)
        if space_group is not None:
            state = {**state, "error_flag": _any_over(state["error_flag"],
                                                      space_group)}
        return state

    run.graphs = graphs
    return run


def _run_inputs(consts, state, ctx):
    """(state with every carried field member-batched, the run call's
    coupler tables on the device, the SPPT noise iterator or None) of a
    run call, in either mode."""
    n_steps = len(ctx["stepno"])
    state = M.ensure_member_axis(state, state["vor"][0].shape[0])
    tables = M.coupler_tables(consts, state, ctx)
    noise = None
    if consts.params.sppt_on and consts.physics_on and n_steps:
        noise = SP.draw_run_noise(consts, state["sppt_key"],
                                  int(ctx["stepno"][0]), n_steps)
    return state, tables, noise


def _levels(val):
    return val if isinstance(val, tuple) else (val,)


class StepGraphs:
    """A run call of the batched runner as CUDA graphs of the step: the
    port's counterpart of the JAX runner's single dispatch
    (pyspeedy_tpu/models/model.py::make_run_steps and the batched runner's
    aligned scan).

    The buffer plan. Every tensor of the incoming state gets a static
    buffer, carried and shared fields alike, dense and in the layout the
    step gives it (the carried fields member-batched; with the physics on
    the per-step diagnostics too; the coupler's shared climatology planes
    one plane each; the leapfrog pairs two sets), and the step's coupler
    tables and SPPT noise get one each. A run call copies the state into the buffers, then
    for each step: the daily forcing eagerly on the buffers when the step
    starts a day (models.model.daily_forcing: numpy on the host, then
    copy_ into the buffers), the step's coupler rows, weights and noise
    copied into their buffers, and the graph of the step's shortwave kind
    and parity replayed. The graph records models.model.step_body on the
    buffers with the buffers as its destination (out=): the kernels and
    the last elementwise pass of each field store straight into them, the
    spectral update into the other set of the pair's buffers, the physics
    and the coupler over their fields (see _BufferPlan); what the step
    still returns as a new tensor is copied into its buffer in the graph
    (coupling/coupler.py::STEP_COPIES). At the end the fields the steps
    write (DYNAMIC_FIELDS) are cloned out once and the others returned as
    the caller gave them. So a returned state never lives in the graphs'
    memory, and a field written between two calls (Speedy.__setitem__, a
    callback, a checkpoint) reaches the next one: the copy-in skips only a
    field that is the very tensor the last call loaded or returned,
    unmodified since (_BufferPlan.load).

    Capture. A graph is captured at the first step of its kind (shortwave
    or not, and the parity of the leapfrog pair's buffers, see _BufferPlan)
    and state layout (shapes and dtypes: the member width among them): that
    step runs once eagerly on a side stream, as
    torch.cuda.graph asks of a warm-up (the kernels are built, the consts'
    lazy tables made, every launcher's attributes and occupancy queried
    once), and advances the buffers; the capture then records the same
    calls without running them. Every graph of the runner allocates from
    one memory pool. Kernel arguments are taken by value at capture: the
    step length, the shortwave flag and the consts' host tables, all fixed
    for a graph's key. Nothing is caught: a failed capture or replay
    raises.

    The runner keeps the plans of the last MAX_PLANS layouts it was called
    with; a call with another layout drops the least recently used plan,
    its buffers and its graphs (a sweep over member widths holds at most
    MAX_PLANS plans' memory).

    On CPU consts the same buffer plan runs with step_body called eagerly
    where a graph would be replayed: the function the graphs record.
    `stats` counts captures, their seconds, the memory the pool took while
    capturing and the bytes of the static buffers made, and holds the
    copies of the last run call: copies_per_step (the copies into buffers
    that the replayed graphs hold, and the daily forcing's, over the
    call's steps), `copied`, the fields copied by the step graphs ("step")
    and by the daily forcing ("forcing"), and `copies`, every copy the
    call made by kind: "in" (the copy-in), "step", "forcing", "inputs"
    (the coupler tables and SPPT noise of each step) and "out" (the
    clones out), with "steps", the call's steps."""

    MAX_PLANS = 3

    def __init__(self, consts):
        self.consts = consts
        self.capture = consts.device.type == "cuda"
        self.pool = None
        self.plans = {}      # layout -> _BufferPlan, least recently used first
        self.stats = {"captures": 0, "capture_s": 0.0, "pool_bytes": 0,
                      "buffer_bytes": 0, "copies_per_step": 0.0,
                      "copied": {}, "copies": {}}

    def run(self, state, ctx) -> dict:
        """A run call: the steps of ctx (models.model.build_step_ctx) from
        the member-batched `state`, as the batched runner takes them."""
        consts = self.consts
        state, tables, noise = _run_inputs(consts, state, ctx)
        nmem = state["vor"][0].shape[0]
        plan = self._plan(state, nmem, noise is not None)
        n_steps = len(ctx["stepno"])
        count = {"steps": n_steps, "in": plan.load(state), "step": 0,
                 "forcing": 0, "inputs": 0}
        copied = {"step": set(), "forcing": set()}
        for i in range(n_steps):
            if ctx["do_forcing"][i]:
                names = plan.write(M.daily_forcing(consts, plan.state, {
                    k: ctx[k][i] for k in ("do_forcing", "year_frac",
                                           "tyear")}))
                copied["forcing"].update(names)
                count["forcing"] += len(names)
            plan.coupler.rows.copy_(tables.rows[i])
            plan.coupler.w.copy_(tables.w[i])
            if noise is not None:
                plan.sppt_se.copy_(next(noise))
            count["inputs"] += 2 + (noise is not None)
            key = (bool(ctx["compute_shortwave"][i]), plan.parity)
            self.replay(plan, key, lambda key=key: plan.step(*key))
            plan.parity = 1 - key[1]
            copied["step"].update(plan.copies[key])
            count["step"] += len(plan.copies[key])
        out, count["out"] = plan.unload(state)
        self.stats["copies_per_step"] = ((count["step"] + count["forcing"])
                                         / max(n_steps, 1))
        self.stats["copied"] = {k: sorted(v) for k, v in copied.items()}
        self.stats["copies"] = count
        return out

    def replay(self, plan, key, body):
        """Replay plan's graph `key`; without one, run `body` once eagerly
        as the warm-up and capture it. On CPU consts, run `body`."""
        if not self.capture:
            body()
            return
        graph = plan.graphs.get(key)
        if graph is None:
            plan.graphs[key] = self._capture(body)
        else:
            graph.replay()

    def _plan(self, state, nmem: int, with_noise: bool):
        batched = (M.DYNAMIC_FIELDS if self.consts.physics_on
                   else M.CARRY_FIELDS)
        shapes = {}
        for name, val in sorted(state.items()):
            if not isinstance(val, (torch.Tensor, tuple)):
                raise TypeError(f"state field {name!r} is a "
                                f"{type(val).__name__}, not a tensor")
            levels = []
            for a in _levels(val):
                single = (name in batched
                          and a.dim() == M.single_member_ndim(name))
                if name in SHARED_PLANES and (single or a.stride(0) == 0):
                    # One plane for all members.
                    levels.append((tuple(a.shape[1 - single:]), a.dtype,
                                   True))
                elif single:
                    levels.append(((nmem,) + tuple(a.shape), a.dtype, False))
                else:
                    levels.append((tuple(a.shape), a.dtype, False))
            shapes[name] = tuple(levels)
        # A field that the state gives as its ALIASES source's tensor shares
        # that field's buffers.
        aliases = tuple(sorted(
            (name, src) for name, src in ALIASES.items()
            if isinstance(state.get(name), torch.Tensor)
            and isinstance(state.get(src), torch.Tensor)
            and _same_tensor(state[name], state[src])))
        layout = (nmem, with_noise, tuple(
            (name, isinstance(state[name], tuple), lv)
            for name, lv in shapes.items()), aliases)
        plan = self.plans.pop(layout, None)
        if plan is None:
            while len(self.plans) >= self.MAX_PLANS:
                del self.plans[next(iter(self.plans))]
            plan = _BufferPlan(self.consts, layout)
            self.stats["buffer_bytes"] += plan.nbytes
        self.plans[layout] = plan
        return plan

    def _capture(self, body):
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            reserved = torch.cuda.memory_reserved()
            body()
        self.stats["pool_bytes"] += torch.cuda.memory_reserved() - reserved
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return graph


class _BufferPlan:
    """The static buffers of one state layout, and the graphs recorded on
    them by (shortwave kind, parity) (see StepGraphs).

    Two sets of the leapfrog pair buffers (ps, vor, div, t, tr, both time
    levels), one set of everything else. The spectral update (kernel table
    row 6, csrc/spectral_update.cu) reads the pair it rewrites. Its kernel
    would allow the rewrite in place: every point (member, pair part, m, n,
    level) of ps, vor, div, t and the tracers is read and stored by one
    thread, the reads first, and no thread reads another point of those
    fields (finish: ps0 loaded with the member's divergence, ps1 read in the
    leapfrog call before the stores of out[0] / out[1], each level's div1,
    t0, t1 read before its stores; streamed: each level's vor0 / vor1 and
    tracer pair read before its stores; the neighbours in n and the other
    pair part come only from the staged flux spectra, which are not state).
    But in place the kernel ran slower on the card at T47 and T63 (NVIDIA
    H100 80GB HBM3, 700 W, `python3 -m pyspeedy_tpu_torch.step_time`, B=128:
    0.454 -> 0.568 ms at T47, 0.870 -> 1.04 ms at T63; T30 alike), so a
    step of parity p reads set p and the kernel stores into set 1 - p: the
    pair ping-pongs, and the graphs are keyed on (shortwave, p), four a
    layout. `load` writes the caller's state into set 0 and restarts the
    parity there; `unload` reads the set the last step wrote.

    Everything else the step writes in place: the physics (row 2,
    csrc/grid_physics.cu) stores the diagnostics, and on shortwave steps
    the radiation cache, into their buffers; its shortwave variant reads
    none of the old cache (the cache loads sit under `if (!SW)` and in the
    `else` of `if (SW)`). The geopotential, SPPT's spectrum, the error
    flag, the slab models' fields and the coupler's climatology planes take
    their buffers as `out=`.

    A field of SHARED_PLANES that the state gives as one plane for all
    members (an expanded view, as broadcast_state and the eager step give
    it) is held as one plane, and given to the step as that plane expanded
    over the members; `unload` hands it back so. A field that the state
    gives as its ALIASES source's tensor (the coupler hands it on so) shares
    the source's buffers; `unload` hands it back as the source's tensor.
    Which fields are planes and aliases, and which one a step still copies
    (STEP_COPIES), is the coupler's to say (coupling/coupler.py).

    `write` copies into its buffer each field that a step or the daily
    forcing returns as a tensor of its own (a step: STEP_COPIES); `copies`
    holds, by graph key, the fields the recorded graph copies."""

    def __init__(self, consts, layout):
        self.consts = consts
        nmem, with_noise, fields, aliases = layout
        device, dtype = consts.device, consts.params.dtype
        empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
        self.aliased = dict(aliases)
        sets = ({}, {})
        for name, is_tuple, levels in fields:
            if name in self.aliased:
                continue
            pair = is_tuple and name in SG.PAIR_FIELDS
            for st in sets if pair else sets[:1]:
                vals = []
                for shape, dt, shared in levels:
                    buf = empty(shape, dt)
                    vals.append(buf.expand(nmem, *shape) if shared else buf)
                st[name] = tuple(vals) if is_tuple else vals[0]
        for name, src in self.aliased.items():
            sets[0][name] = sets[0][src]
        for name, val in sets[0].items():
            sets[1].setdefault(name, val)
        self.states = sets
        self.parity = 0
        self.coupler = CouplerTables(
            empty((N_COUPLER_ROWS,), torch.int64),
            empty((N_COUPLER_WEIGHTS,), dtype))
        self.sppt_se = (empty((nmem,) + SP._pair_shape(consts.params), dtype)
                        if with_noise else None)
        every = {id(b): _base(b) for st in sets for v in st.values()
                 for b in _levels(v)}
        self.nbytes = sum(b.numel() * b.element_size()
                          for b in every.values())
        self.written = set()
        # (field, level) -> (a weak reference to the tensor whose values the
        # buffer of set 0 holds, that tensor's version counter then): what
        # the copy-in copied there, or what unload cloned from there.
        self.held = {}
        self.running = False     # between a load and its unload
        self.graphs = {}     # (shortwave, parity) -> torch.cuda.CUDAGraph
        self.copies = {}     # (shortwave, parity) -> fields its graph copies

    @property
    def state(self) -> dict:
        """The buffers that hold the state now: the pair set of the parity."""
        return self.states[self.parity]

    def load(self, state) -> int:
        """Copy the caller's state into set 0 and restart the parity there;
        returns the number of copies. Not copied: a field that shares its
        source's buffers, and a level whose buffer holds its values already
        (`held`): the same tensor that the last call loaded there or handed
        back from there, not modified since (its version counter). So a
        caller that gives each call the state the last one returned copies
        nothing in but the pairs after an odd number of steps; a field set
        or modified between two calls is copied."""
        if self.running:
            self.held.clear()           # the last call did not finish
        self.parity = 0
        n = 0
        for name, bufs in self.state.items():
            if name in self.aliased:
                continue
            for i, (buf, src) in enumerate(zip(_levels(bufs),
                                               _levels(state[name]))):
                ref, version = self.held.get((name, i), (None, None))
                if ref is not None and ref() is src and src._version == version:
                    continue
                base = _base(buf)
                base.copy_(src[0] if base is not buf and src.dim() > base.dim()
                           else src)
                self.held[(name, i)] = (weakref.ref(src), src._version)
                n += 1
        self.running = True
        return n

    def step(self, shortwave: bool, parity: int):
        """The step of graph key (shortwave, parity): the pair read from set
        `parity`, the new pair stored into the other set."""
        src, dst = self.states[parity], self.states[1 - parity]
        out = M.step_body(self.consts, src, shortwave, self.coupler,
                          self.sppt_se, out=dst)
        self.parity = 1 - parity
        self.copies[(shortwave, parity)] = self.write(out)

    def write(self, out: dict) -> list:
        """Copy every field of `out` that is not its buffer (in the set of
        the present parity) into it; returns the names of the fields copied
        (a name once per level copied). A field that is its buffer (the same
        memory, shape and strides) is not copied; a field held as one plane
        takes the plane of a value that is the same for every member (an
        expanded view; anything else raises); a tensor whose memory is a
        buffer that this write overwrites is cloned before any copy."""
        pending = []
        for name, val in out.items():
            bufs = self.state.get(name)
            if bufs is None:
                raise RuntimeError(f"the step wrote {name!r}, a field the "
                                   f"state did not hold")
            for buf, new in zip(_levels(bufs), _levels(val)):
                if _same_tensor(new, buf):
                    continue
                base = _base(buf)
                if base is not buf and new.dim() > base.dim():
                    if new.shape[0] > 1 and new.stride(0) != 0:
                        raise RuntimeError(
                            f"the step wrote {name!r} member by member; the "
                            f"plan holds it as one plane")
                    new = new[0]
                pending.append((name, base, new))
                self.written.add(name)
        overwritten = {base.untyped_storage().data_ptr()
                       for _, base, _ in pending}
        pending = [(name, base, new.clone() if new.untyped_storage().data_ptr()
                    in overwritten else new) for name, base, new in pending]
        for _, base, new in pending:
            base.copy_(new)
        return [name for name, _, _ in pending]

    def unload(self, state) -> tuple:
        """(the state after the call, the number of clones made): a clone of
        every field that the steps and the daily forcing write (an alias
        the clone of its source), the others as the caller gave them. A
        clone from set 0 is `held` for the next call's copy-in."""
        out = dict(state)
        written = (M.DYNAMIC_FIELDS | self.written) & self.state.keys()
        written |= ({a for a, src in self.aliased.items() if src in written}
                    | {self.aliased[a] for a in written & self.aliased.keys()})
        n = 0
        for name in sorted(written - self.aliased.keys()):
            clones = []
            for i, buf in enumerate(_levels(self.state[name])):
                base = _base(buf)
                clone = (base.clone() if base is buf
                         else base.clone().expand(buf.shape))
                clones.append(clone)
                if buf is _levels(self.states[0][name])[i]:
                    self.held[(name, i)] = (weakref.ref(clone),
                                            clone._version)
                else:
                    self.held.pop((name, i), None)
            n += len(clones)
            out[name] = (tuple(clones) if isinstance(state[name], tuple)
                         else clones[0])
        for name in written & self.aliased.keys():
            out[name] = out[self.aliased[name]]
        self.running = False
        return out, n


def _base(buf: torch.Tensor) -> torch.Tensor:
    """The memory a buffer writes to: a plane held for all members is given
    to the step expanded over them (stride 0 on the member axis)."""
    return buf[0] if buf.dim() and buf.stride(0) == 0 else buf


def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a and b are the same elements of the same memory."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def _any_over(flag: torch.Tensor, group) -> torch.Tensor:
    """OR of a bool tensor over the ranks of `group` (one all_reduce)."""
    x = flag.to(torch.uint8)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x.bool()


def shard_ensemble(mesh, state: dict, shard_space: bool = True) -> dict:
    """This rank's piece of a member-batched state that every rank holds
    whole (parallel/mesh.py::local_shard): the members of its ensemble row
    and, with shard_space, its latitude band of every grid field."""
    return local_shard(mesh, state, shard_space)
