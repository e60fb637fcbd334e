"""The system under test: the ensemble of a cell on the PyTorch port
(``pyspeedy_tpu_torch``), built from the benchmark's inputs, and one
forecast segment of a member chunk as the port's batched runner
(``parallel/ensemble.py::make_run_steps_batched``, its CUDA graphs on the
card) advances it. Nothing else of the port is called here."""

from __future__ import annotations

import torch

from . import inputs

__all__ = ["Program", "take_members"]


def take_members(state: dict, names, idx: torch.Tensor) -> dict:
    """The fields `names` of a member-batched state at the members `idx`,
    as new tensors."""
    out = {}
    for name in sorted(names & state.keys()):
        val = state[name]
        pick = lambda a: a.index_select(0, idx.to(a.device)).clone()
        out[name] = tuple(map(pick, val)) if isinstance(val, tuple) else \
            pick(val)
    return out


class Program:
    """The cell's ensemble on `device`: the model initialized from
    `host_bc`, `n_chunks` chunks of `chunk` members, each member's
    temperature perturbed from `seed`, and with SPPT each member's noise
    key; the runner's calendar at the start."""

    def __init__(self, cell, seed: int, device, host_bc: dict):
        from pyspeedy_tpu_torch.models import model as M
        from pyspeedy_tpu_torch.parallel.ensemble import (
            broadcast_state, make_run_steps_batched)
        from pyspeedy_tpu_torch.params import ModelParams
        from pyspeedy_tpu_torch.utils.calendar import ModelCalendar

        self.M = M
        self.cell = cell
        self.params = params = cell.params(ModelParams)
        self.device = torch.device(device)
        self.consts, geom_np = M.build_consts(
            params, device=self.device,
            bf16_tendencies=cell.config["bf16_tendencies"])
        state = M.allocate_state(params, n_months=cell.traffic["months"],
                                 device=self.device)
        self.cal = ModelCalendar.from_datetime(cell.start,
                                               nsteps=params.nsteps)
        self.initial = M.initialize(self.consts, state,
                                    dict(host_bc, _geom_np=geom_np),
                                    self.cal)
        self.run = make_run_steps_batched(self.consts, device=self.device)
        # What a member carries from one step to the next: what a segment
        # reads of its state and writes anew.
        self.carried = M.CARRY_FIELDS
        self.first_step = 0
        self.spun, self.spinup_sample = self._spin_up(
            cell.config["spinup_days"])
        chunk = cell.traffic["chunk"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed % (1 << 63))
        spec = cell.traffic["perturbation"]
        self.chunks = []
        for c in range(cell.n_chunks):
            st = broadcast_state(self.spun, chunk)
            field = st[spec["field"]]
            shape = tuple(field[0].shape)
            dx = inputs.perturbation(spec, shape, gen).to(field[0].dtype)
            st[spec["field"]] = tuple(lv + dx for lv in field)
            if cell.sppt:
                st["sppt_key"] = inputs.sppt_keys(seed, c, chunk).to(
                    st["sppt_key"].device)
            self.chunks.append(st)
        self.n_steps = cell.segment_steps(params.nsteps)

    def _spin_up(self, days: int):
        """The initialized member run `days` days on the runner (B = 1): all
        but the last segment's steps in one run call, those in another,
        which is the first sample of the check. With SPPT the member has
        the benchmark's spin-up key. Returns (the single-member state after,
        the sample)."""
        from pyspeedy_tpu_torch.parallel.ensemble import broadcast_state

        M, nsteps = self.M, self.params.nsteps
        state = broadcast_state(self.initial, 1)
        if self.cell.sppt:
            state["sppt_key"] = inputs.spinup_sppt_key().to(self.device)
        last = self.cell.segment_steps(nsteps)
        for n in (days * nsteps - last, last):
            ctx, self.cal = M.build_step_ctx(self.cal, self.first_step, n)
            after = self.run(state, ctx)
            idx = torch.zeros(1, dtype=torch.int64)
            sample = {"first_step": self.first_step, "n_steps": n,
                      "members": [0],
                      "before": take_members(state, self.carried, idx),
                      "after": take_members(after, self.carried, idx)}
            self.first_step += n
            state = after
        if bool(state["error_flag"].any()):
            raise RuntimeError("the spin-up set the error flag")
        single = {k: (tuple(a[0] for a in v) if isinstance(v, tuple)
                      else v[0]) if k in M.DYNAMIC_FIELDS else v
                  for k, v in state.items()}
        return single, sample

    def cycle_ctx(self):
        """The step context of the next cycle (every chunk advances the
        same steps) and its first step; advances the calendar."""
        ctx, self.cal = self.M.build_step_ctx(self.cal, self.first_step,
                                              self.n_steps)
        first = self.first_step
        self.first_step += self.n_steps
        return ctx, first

    def segment(self, c: int, ctx) -> tuple:
        """Advance chunk `c` by one segment (one run call). Returns (the
        state before, the state after, whether a member set its error
        flag); the chunk holds the state after. Waits for the card."""
        before = self.chunks[c]
        after = self.run(before, ctx)
        bad = bool(after["error_flag"].any())
        self.chunks[c] = after
        return before, after, bad

    def initial_fields(self) -> dict:
        """The carried fields of the initialized single-member state (before
        the perturbation), on the host."""
        return {name: (tuple(a.cpu() for a in v) if isinstance(v, tuple)
                       else v.cpu())
                for name, v in sorted(self.initial.items())
                if name in self.carried}

    def free(self):
        """Drop the ensemble, the runner and its graphs."""
        self.chunks = self.run = self.consts = self.initial = None
        self.spun = self.spinup_sample = None
