"""Batched ensemble execution: the counterpart of the reference's OpenMP
`parallel_step` loop over ensemble members.

Members form a leading batch axis on every carried state tensor; one step
advances all members at once (the transforms become bigger matrix products,
the grid-dynamics and physics kernels one launch each over all columns of all
members). The JAX package's shortwave-aligned scan (prefix, scan of
shortwave-first step triples, tail) exists to keep the radiation cache out of
a scan carry and the per-step diagnostics out of a jitted signature; an eager
Python loop has neither problem, so the runner here is that loop, for any
number of steps from any phase of the shortwave cadence.

On an ("ensemble", "space") mesh (parallel/mesh.py) each rank runs the same
loop on its piece of the state (shard_ensemble, or
parallel/distributed.py::make_global_ensemble): its ensemble row's members
and, when "space" has several ranks, its latitude band, with the band's
Consts (models/model.py::shard_consts), whose direct transforms sum over the
bands with one all_reduce a group (parallel/shard_transforms.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import resolve_device
from ..models import model as M
from ..physics import sppt as SP
from .mesh import local_shard

__all__ = ["broadcast_state", "make_run_steps_batched", "pick_member_chunk",
           "shard_ensemble"]


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


def make_run_steps_batched(consts, device="cuda", mesh=None,
                           shard_space: bool = True):
    """n-step integrator over a member-batched state (leading member axis on
    the carried fields only): run(state, ctx) -> state, with ctx from
    models.model.build_step_ctx. A Python loop over steps; nothing in it
    reads a device value back, so the host runs ahead of the card.
    state["error_flag"] accumulates per member on the device; read it once
    after the run.

    With the physics on, each step runs in this order: the daily forcing
    when the step starts a day, the step itself with the shortwave variant
    of the physics on steps with stepno % 3 == 0, the coupler. The 7
    radiation cache fields live member-batched in the state between steps;
    the per-step diagnostics (EPHEMERAL_FIELDS) come back member-batched and
    current, whether they came in shared (from broadcast_state) or batched
    (from an earlier run).

    The runner keeps the consts' flags: with consts.bf16_tendencies every
    step here runs the bfloat16 instantiations of the kernels (the
    initialization, which made the state, did not).

    With params.sppt_on (and the physics on) the noise is drawn grouped as
    the JAX package's batched runner groups it (physics/sppt.py::sppt_groups),
    so the same member keys give the JAX package's patterns, in chunks of
    many steps (physics/sppt.py::draw_run_noise: one vectorised pass each, a
    whole run call at the model's sizes), the next chunk when the last is
    used up, so the noise held stays bounded however long the run; each
    step takes its slice (ctx "sppt_se").

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
    single_step = M.make_single_step(consts)

    def run(state, ctx):
        n_steps = len(ctx["stepno"])
        nmem = state["vor"][0].shape[0]
        state = M.ensure_member_axis(state, nmem)
        noise = None
        if consts.params.sppt_on and consts.physics_on and n_steps:
            noise = SP.draw_run_noise(consts, state["sppt_key"],
                                      int(ctx["stepno"][0]), n_steps)
        for i in range(n_steps):
            # ctx_i is rebound before the next draw, so a used chunk of
            # noise is freed before the next one is made.
            ctx_i = {k: v[i] for k, v in ctx.items()}
            if noise is not None:
                ctx_i["sppt_se"] = next(noise)
            state = single_step(state, ctx_i)
        if space_group is not None:
            state = {**state, "error_flag": _any_over(state["error_flag"],
                                                      space_group)}
        return state

    return run


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
