"""What the benchmark asks of the reference: the model built and
initialized from the benchmark's inputs, and a run of steps over a
member-batched state in the eager loop (the port's batched runner without
its CUDA graphs: daily forcing, step body, coupler, SPPT noise drawn by run
call as the port's runner draws it)."""

from __future__ import annotations

import dataclasses
from datetime import datetime

import torch

from .coupling.interpolation import CouplerTables
from .models import model as M
from .params import ModelParams
from .physics import sppt as SP
from .utils.calendar import ModelCalendar

__all__ = ["Reference", "CARRY_FIELDS", "DYNAMIC_FIELDS"]

CARRY_FIELDS = M.CARRY_FIELDS
DYNAMIC_FIELDS = M.DYNAMIC_FIELDS


class Reference:
    """The model of `params` on `device` in `dtype` (torch.float64, or
    torch.float32 for the control), initialized from `host_bc` (numpy
    boundary fields in the internal (month, lat, lon) layouts, with
    "sst_anom") at `start`."""

    def __init__(self, params: ModelParams, host_bc: dict, start: datetime,
                 device, dtype=torch.float64):
        precision = "f64" if dtype == torch.float64 else "f32"
        self.params = dataclasses.replace(
            params, precision=precision,
            noise_precision=params.noise_precision or params.precision)
        self.start = start
        self.consts, geom_np = M.build_consts(self.params, device=device)
        bc = dict(host_bc, _geom_np=geom_np)
        n_months = bc["sst_anom"].shape[0] - 2
        state = M.allocate_state(self.params, n_months=n_months,
                                 device=device)
        self.state = M.initialize(self.consts, state, bc, self.calendar(0))

    def calendar(self, first_step: int) -> ModelCalendar:
        """The calendar at step `first_step` of a run from `start`."""
        cal = ModelCalendar.from_datetime(self.start,
                                          nsteps=self.params.nsteps)
        for _ in range(first_step):
            cal.advance()
        return cal

    def member_state(self, carried: dict) -> dict:
        """A member-batched state: `carried` (the fields that carry a member
        axis, as given) over this model's own shared fields."""
        state = dict(self.state)
        for name, val in carried.items():
            state[name] = val
        nmem = state["vor"][0].shape[0]
        return M.ensure_member_axis(state, nmem)

    def run(self, state: dict, first_step: int, n_steps: int) -> dict:
        """n_steps steps from step `first_step` of the member-batched
        `state`, one run call of the eager loop."""
        consts = self.consts
        ctx, _ = M.build_step_ctx(self.calendar(first_step), first_step,
                                  n_steps)
        nmem = state["vor"][0].shape[0]
        state = M.ensure_member_axis(state, nmem)
        tables = M.coupler_tables(consts, state, ctx)
        noise = None
        if consts.params.sppt_on and consts.physics_on and n_steps:
            noise = SP.draw_run_noise(consts, state["sppt_key"], first_step,
                                      n_steps)
        single_step = M.make_single_step(consts)
        for i in range(n_steps):
            ctx_i = {k: v[i] for k, v in ctx.items()}
            ctx_i["coupler"] = CouplerTables(tables.rows[i], tables.w[i])
            if noise is not None:
                ctx_i["sppt_se"] = next(noise)
            state = single_step(state, ctx_i)
        return state
