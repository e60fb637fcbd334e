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

import torch
import torch.distributed as dist

from .. import resolve_device
from ..coupling.interpolation import (N_COUPLER_ROWS, N_COUPLER_WEIGHTS,
                                      CouplerTables)
from ..models import model as M
from ..physics import sppt as SP
from .mesh import local_shard

__all__ = ["broadcast_state", "make_run_steps_batched", "pick_member_chunk",
           "shard_ensemble", "takes_graphs", "StepGraphs"]


def pick_member_chunk(n_members: int, chunk: int) -> int:
    """Chunk width for an n-member ensemble run in member chunks: `chunk`
    when it divides the ensemble evenly, else the whole ensemble. The width
    is the caller's: no value has been measured on a GPU yet."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if n_members > chunk and n_members % chunk == 0:
        return chunk
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
    shortwave kind and state layout, kept by this runner for its later
    calls in its last StepGraphs.MAX_PLANS layouts); run(..., eager=True) takes the eager loop instead, with the
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
    the per-step diagnostics too), and the step's coupler tables and SPPT
    noise get one each. A run call copies the state into the buffers, then
    for each step: the daily forcing eagerly on the buffers when the step
    starts a day (models.model.daily_forcing: numpy on the host, then
    copy_ into the buffers), the step's coupler rows, weights and noise
    copied into their buffers, and the graph of the step's shortwave kind
    replayed. The graph records models.model.step_body on the buffers and
    then copies each field the step wrote into its buffer (the step's
    outputs are new tensors; one that shares memory with another buffer is
    cloned before any is written). At the end the fields the steps write
    (DYNAMIC_FIELDS) are cloned out once and the others returned as the
    caller gave them. So a returned state never lives in the graphs' memory,
    and a field written between two calls (Speedy.__setitem__, a callback,
    a checkpoint) reaches the next one.

    Capture. A graph is captured at the first step of its kind (shortwave
    or not) and state layout (shapes and dtypes: the member width among
    them): that step runs once eagerly on a side stream, as
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
    capturing and the bytes of the static buffers made."""

    MAX_PLANS = 3

    def __init__(self, consts):
        self.consts = consts
        self.capture = consts.device.type == "cuda"
        self.pool = None
        self.plans = {}      # layout -> _BufferPlan, least recently used first
        self.stats = {"captures": 0, "capture_s": 0.0, "pool_bytes": 0,
                      "buffer_bytes": 0}

    def run(self, state, ctx) -> dict:
        """A run call: the steps of ctx (models.model.build_step_ctx) from
        the member-batched `state`, as the batched runner takes them."""
        consts = self.consts
        state, tables, noise = _run_inputs(consts, state, ctx)
        nmem = state["vor"][0].shape[0]
        plan = self._plan(state, nmem, noise is not None)
        plan.load(state)
        for i in range(len(ctx["stepno"])):
            if ctx["do_forcing"][i]:
                plan.write(M.daily_forcing(consts, plan.state, {
                    k: ctx[k][i] for k in ("do_forcing", "year_frac",
                                           "tyear")}))
            plan.coupler.rows.copy_(tables.rows[i])
            plan.coupler.w.copy_(tables.w[i])
            if noise is not None:
                plan.sppt_se.copy_(next(noise))
            shortwave = bool(ctx["compute_shortwave"][i])
            self.replay(plan, shortwave,
                        lambda sw=shortwave: plan.step(sw))
        return plan.unload(state)

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
            shapes[name] = tuple(
                ((nmem,) + tuple(a.shape)
                 if name in batched and a.dim() == M.single_member_ndim(name)
                 else tuple(a.shape), a.dtype) for a in _levels(val))
        layout = (nmem, with_noise, tuple(
            (name, isinstance(state[name], tuple), lv)
            for name, lv in shapes.items()))
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
    them by shortwave kind (see StepGraphs)."""

    def __init__(self, consts, layout):
        self.consts = consts
        nmem, with_noise, fields = layout
        device, dtype = consts.device, consts.params.dtype
        empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
        self.state = {}
        for name, is_tuple, levels in fields:
            bufs = tuple(empty(shape, dt) for shape, dt in levels)
            self.state[name] = bufs if is_tuple else bufs[0]
        self.coupler = CouplerTables(
            empty((N_COUPLER_ROWS,), torch.int64),
            empty((N_COUPLER_WEIGHTS,), dtype))
        self.sppt_se = (empty((nmem,) + SP._pair_shape(consts.params), dtype)
                        if with_noise else None)
        every = [b for v in self.state.values() for b in _levels(v)]
        self.storages = {b.untyped_storage().data_ptr() for b in every}
        self.nbytes = sum(b.numel() * b.element_size() for b in every)
        self.written = set()
        self.graphs = {}     # shortwave kind -> torch.cuda.CUDAGraph

    def load(self, state):
        for name, bufs in self.state.items():
            for buf, src in zip(_levels(bufs), _levels(state[name])):
                buf.copy_(src)

    def step(self, shortwave: bool):
        self.write(M.step_body(self.consts, self.state, shortwave,
                               self.coupler, self.sppt_se))

    def write(self, out: dict):
        """Copy every field of `out` that is not its buffer into it."""
        pending = []
        for name, val in out.items():
            bufs = self.state.get(name)
            if bufs is None:
                raise RuntimeError(f"the step wrote {name!r}, a field the "
                                   f"state did not hold")
            for buf, new in zip(_levels(bufs), _levels(val)):
                if new is not buf:
                    pending.append((buf, new))
                    self.written.add(name)
        pending = [(buf, new.clone() if new.untyped_storage().data_ptr()
                    in self.storages else new) for buf, new in pending]
        for buf, new in pending:
            buf.copy_(new)

    def unload(self, state) -> dict:
        out = dict(state)
        for name in (M.DYNAMIC_FIELDS | self.written) & self.state.keys():
            clones = tuple(b.clone() for b in _levels(self.state[name]))
            out[name] = clones if isinstance(state[name], tuple) else clones[0]
        return out


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
