"""Batched ensemble execution: the counterpart of the reference's OpenMP
`parallel_step` loop over ensemble members.

Members form a leading batch axis on every carried state tensor; one step
advances all members at once (the transforms become bigger matrix products,
the grid-dynamics and physics kernels one launch each over all columns of all
members). The JAX package's shortwave-aligned scan (prefix, scan of
shortwave-first step triples, tail) exists to keep the radiation cache out of
a scan carry and the per-step diagnostics out of a jitted signature; an eager
Python loop has neither problem, so the runner here is that loop, for any
number of steps from any phase of the shortwave cadence. Meshes and sharding
are not ported.
"""

from __future__ import annotations

from .. import resolve_device
from ..models import model as M

__all__ = ["broadcast_state", "make_run_steps_batched", "pick_member_chunk"]


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
    no memory until the first step."""
    return M.add_member_axis(state, n_members)


def make_run_steps_batched(consts, device="cuda"):
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

    `device` must be the one the consts were built on."""
    device = resolve_device(device)
    if device.type != consts.device.type:
        raise ValueError(
            f"consts were built on {consts.device}, runner asked for {device}")
    single_step = M.make_single_step(consts)

    def run(state, ctx):
        n_steps = len(ctx["stepno"])
        nmem = state["vor"][0].shape[0]
        state = M.ensure_member_axis(state, nmem)
        for i in range(n_steps):
            state = single_step(state, {k: v[i] for k, v in ctx.items()})
        return state

    return run
