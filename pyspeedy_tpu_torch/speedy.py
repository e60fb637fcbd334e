"""The Speedy model: public API.

The JAX package's ``Speedy`` / ``SpeedyEns`` (and through them the
reference's ``pyspeedy.speedy``) on this package: the same constructor
signatures plus a ``device`` argument (and ``bf16_tendencies``, off by
default), dict-style state access with registry
names and Fortran-order shapes, the set_bc contract, run(callbacks),
grid/spectral conversions, CF-metadata export, checkpoints in the JAX
package's format, and the error-code to exception mapping.

Internals: the state is a dict of tensors on the model's device in the
single-member layout. ``Speedy`` is the B = 1 case of the member-batched
runner (parallel/ensemble.py::make_run_steps_batched); ``SpeedyEns`` stacks
its members' carried fields and advances them together through the same
runner. Entry points default to device="cuda" and raise without a card;
device="cpu" runs the plain PyTorch path on the host. On the card a run
call replays the runner's CUDA graphs of the step (captured at the first
call of each member width, the last three widths' kept with the
configuration's runner); the
runner copies the state in and clones it out, so what callbacks,
checkpoints and __setitem__ read and write between run calls is the
model's own state.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import os
import re
from datetime import datetime, timedelta

import numpy as np
import torch

from . import (DEFAULT_OUTPUT_VARS, example_bc_file, example_sst_anomaly_file,
               resolve_device)
from .error_codes import E_DIAGNOSTICS_OUTSIDE_RANGE, ERROR_CODES
from .models import model as M
from .models import prognostics as prog
from .models.diagnostics import check_diagnostics
from .parallel.ensemble import make_run_steps_batched, pick_member_chunk
from .params import ModelParams, T30L8
from .physics import sppt as SP
from .registry import (MODEL_STATE_DEF, REGISTRY, from_api_array,
                       resolve_dims, to_api_array)
from .utils.calendar import ModelCalendar
from .utils.dataset import Dataset, Variable, merge, open_dataset

__all__ = ["Speedy", "SpeedyEns", "MODEL_STATE_DEF"]

# Checkpoint (.npz) format of the JAX package (speedy.py there): v3 stores
# spectral fields as real (2, ...) pairs, v4 adds the calendar's seconds.
_CHECKPOINT_VERSION = 4
_CHECKPOINT_LOADABLE = (3, 4)

# One Consts (tables on the device) per configuration and device, shared by
# every instance, built together with its numpy geometry and its runner.
_CONSTS_CACHE: dict = {}


def _consts_for(params: ModelParams, device: torch.device,
                bf16_tendencies: bool = False):
    """(consts, numpy geometry, batched runner) of a configuration on a
    device, built at first use; on the card the runner keeps the CUDA
    graphs of its last StepGraphs.MAX_PLANS state layouts for every
    instance of the configuration."""
    key = (params, str(device), bool(bf16_tendencies))
    if key not in _CONSTS_CACHE:
        consts, geom_np = M.build_consts(params, device=device,
                                         bf16_tendencies=bf16_tendencies)
        _CONSTS_CACHE[key] = (consts, geom_np,
                              make_run_steps_batched(consts, device=device))
    return _CONSTS_CACHE[key]


def _add_months(date: datetime, months: int) -> datetime:
    m = date.month - 1 + months
    return date.replace(year=date.year + m // 12, month=m % 12 + 1)


class Speedy:
    """Speedy model instance (reference: pyspeedy/speedy.py:40-483).

    bf16_tendencies=True steps with bfloat16 tendencies
    (models.model.Consts.bf16_tendencies; the JAX package turns it on by
    default for float32 on its TPU, the port leaves it off); the
    initialization runs at full precision either way."""

    def __init__(self, start_date=datetime(1982, 1, 1),
                 end_date=datetime(1982, 1, 2), member=None,
                 params: ModelParams = T30L8, device="cuda",
                 bf16_tendencies: bool = False):
        self.device = resolve_device(device)
        self.bf16_tendencies = bool(bf16_tendencies)
        self.member_id = member
        self.is_ensemble_member = member is not None
        self.params = params
        self._state = None
        self._consts = None
        self._run = None
        self._current_step = 0
        self._initialized_bc = False
        self._initialized_ssta = False
        self._sst_anom_data = None
        self.set_params(start_date=start_date, end_date=end_date)

    # -- control parameters ------------------------------------------------

    def set_params(self, start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2)):
        if start_date > end_date:
            raise ValueError("The start date should be lower than the en date.")
        self.start_date = start_date
        self.end_date = end_date
        self.current_date = start_date
        self._cal = ModelCalendar.from_datetime(start_date,
                                               nsteps=self.params.nsteps)
        self.n_months = ((end_date.year - start_date.year) * 12
                         + (end_date.month - start_date.month) + 1)

    def get_current_step(self):
        return self._current_step

    @property
    def _dt_step(self):
        # dt follows the configured steps/day (reference: fixed 2400 s, T30)
        return timedelta(seconds=3600 * 24 / self.params.nsteps)

    # -- state access ------------------------------------------------------

    def _spec_for(self, var_name):
        spec = REGISTRY.get(var_name)
        if spec is None:
            raise AttributeError(
                f"The state variable '{var_name}' does not exist.")
        return spec

    def __getitem__(self, var_name):
        if var_name == "current_step":
            return self._current_step
        spec = self._spec_for(var_name)
        # A writable host copy, like the reference's f2py getters.
        out = np.array(to_api_array(spec, self._state[var_name]))
        return np.ascontiguousarray(out) if out.ndim else out

    def get_shape(self, var_name):
        spec = self._spec_for(var_name)
        n_months = self._sst_anom_months() if spec.time_dim else None
        return resolve_dims(self.params, spec.dims, n_months=n_months)

    def _sst_anom_months(self):
        if self._state is not None and "sst_anom" in self._state:
            return self._state["sst_anom"].shape[0] - 2
        return self.n_months

    def _tensor_like(self, value, cur):
        return torch.as_tensor(np.asarray(value)).to(device=cur.device,
                                                     dtype=cur.dtype)

    def __setitem__(self, var_name, value):
        if var_name == "current_step":
            self._current_step = int(value)
            return
        spec = self._spec_for(var_name)
        cur = self._state[var_name]
        if spec.dims:
            value = np.asarray(getattr(value, "values", value))
            if self.get_shape(var_name) != value.shape:
                raise ValueError("Array shape missmatch")
            internal = from_api_array(spec, value)
            if isinstance(internal, tuple):
                self._state[var_name] = tuple(
                    self._tensor_like(a, c) for a, c in zip(internal, cur))
            else:
                self._state[var_name] = self._tensor_like(internal, cur)
        else:
            self._state[var_name] = self._tensor_like(value, cur)

    # -- initialization ----------------------------------------------------

    def set_bc(self, bc_file=None, sst_anomaly=None):
        """Set boundary conditions and initialize the model (reference
        contract: pyspeedy/speedy.py:217-301): the NetCDF fields orog, lsm,
        alb, vegl, vegh, stl, snowd, swl1-3, sst, icec, and the anomalies
        ssta. Without arguments the bundled files are read. Fields on
        another Gaussian grid than the model's (the bundled files are T30's,
        96 x 48) are filled and remapped onto it conservatively
        (coupling/remap.py::remap_bc); on the model's own grid they are
        taken as they are."""
        if self._initialized_bc:
            raise RuntimeError(
                "The model was already initialized. Create a new instance if "
                "you need different boundary conditions.")

        self._set_sst_anomalies(sst_anomaly=sst_anomaly)

        if bc_file is None:
            bc_file = example_bc_file()
        if not os.path.isfile(bc_file):
            raise RuntimeError(
                "The boundary conditions file does not exist.\n"
                f"File: {bc_file}")

        # Imported here: `python -m` runs the module as its writer.
        from .coupling import remap
        host_bc, _ = remap.read_bc(bc_file)
        host_bc["sst_anom"] = self._sst_anom_data
        if remap.off_grid(host_bc, self.params.il, self.params.ix):
            host_bc = remap.remap_bc(host_bc, self.params.il, self.params.ix)

        consts, geom_np, self._run = _consts_for(self.params, self.device,
                                                 self.bf16_tendencies)
        host_bc["_geom_np"] = geom_np
        self._consts = consts
        state = M.allocate_state(
            self.params, n_months=self._sst_anom_data.shape[0] - 2,
            device=self.device)
        if self.params.sppt_on:
            # A distinct, reproducible stochastic-physics stream per member:
            # the JAX package's fold_in(key(0), member).
            state["sppt_key"] = SP.fold_in(SP.key_data(0, self.device),
                                           self.member_id or 0)
        cal = ModelCalendar.from_datetime(self.start_date,
                                          nsteps=self.params.nsteps)
        self._state = M.initialize(consts, state, host_bc, cal)
        self._cal = cal
        self._current_step = 0
        self.spectral2grid()
        self._initialized_bc = True

    def _set_sst_anomalies(self, sst_anomaly=None):
        """Load SST anomalies covering [start-1 month, end+1 month]
        (reference: pyspeedy/speedy.py:303-373)."""
        if self._initialized_ssta:
            raise RuntimeError(
                "The SST anomaly was already initialized."
                " Create a new instance if you need different boundary "
                "conditions.")
        if sst_anomaly is None:
            sst_anomaly = example_sst_anomaly_file()

        if isinstance(sst_anomaly, str):
            if not os.path.isfile(sst_anomaly):
                raise RuntimeError(
                    "The SST anomaly file does not exist.\n"
                    f"File: {sst_anomaly}")
            ds = open_dataset(sst_anomaly)
        elif isinstance(sst_anomaly, Dataset):
            ds = sst_anomaly
        else:
            raise TypeError(
                f"Unsupported sst_anomaly input: {type(sst_anomaly)}")

        start_date = _add_months(
            self.start_date.replace(day=1, hour=0, minute=0, second=0,
                                    microsecond=0), -1)
        end_date = _add_months(
            self.end_date.replace(day=1, hour=0, minute=0, second=0,
                                  microsecond=0), 1) + timedelta(days=1)

        times = np.asarray(ds["time"].values)
        tvar = ds["time"]
        if not np.issubdtype(times.dtype, np.datetime64):
            units = tvar.attrs.get("units", "")
            times = _decode_cf_time(times, units)
        sel = (times >= np.datetime64(start_date)) \
            & (times <= np.datetime64(end_date))

        expected_months = ((end_date.year - start_date.year) * 12
                           + (end_date.month - start_date.month) + 1)
        missing_months = expected_months - int(sel.sum())
        if missing_months > 0:
            raise RuntimeError(
                f"{missing_months} months are missing in the SST anomalies "
                "file for the period: "
                + start_date.strftime("%Y/%m/%d") + " , "
                + end_date.strftime("%Y/%m/%d") + ".\n ")

        ssta = np.asarray(ds["ssta"].values, dtype=np.float64)
        tax = ds["ssta"].dims.index("time")
        ssta = np.take(ssta, np.nonzero(sel)[0], axis=tax)
        # to internal layout (time, lat, lon)
        dims = ds["ssta"].dims
        order = [dims.index("time"), dims.index("lat"), dims.index("lon")]
        self._sst_anom_data = np.transpose(ssta, order)
        self._initialized_ssta = True

    # -- stepping ----------------------------------------------------------

    def _advance(self, n_steps):
        """Advance n_steps through the batched runner at B = 1."""
        consts = self._consts
        ctx, self._cal = M.build_step_ctx(self._cal, self._current_step,
                                          n_steps)
        st = self._run(M.add_member_axis(self._state, 1), ctx)
        self._state = M._drop_member_axis(st, consts.physics_on)
        self._current_step += n_steps
        self.current_date += self._dt_step * n_steps

    def _raise_if_failed(self):
        if bool(self._state["error_flag"]):
            raise RuntimeError(ERROR_CODES[E_DIAGNOSTICS_OUTSIDE_RANGE])

    def run(self, callbacks=None):
        """Run from start_date to end_date, invoking callbacks after every
        chunk of steps: the gcd of the callbacks' intervals, or the whole
        run without any (reference: pyspeedy/speedy.py:375-405)."""
        if callbacks is None:
            callbacks = []
        if not self._initialized_bc:
            raise RuntimeError(
                "The SPEEDY model was not initialized. Call the `set_bc` "
                "method to initialize the model.")

        self.current_date = self.start_date
        total = round((self.end_date - self.current_date) / self._dt_step)
        chunk = 1
        if total > 0:
            intervals = [cb.interval for cb in callbacks
                         if getattr(cb, "interval", None)]
            chunk = math.gcd(*intervals) if intervals else total

        done = 0
        while done < total:
            n = min(chunk, total - done)
            self._advance(n)
            self._raise_if_failed()
            done += n
            for callback in callbacks:
                callback(self)

    # -- conversions and export -------------------------------------------

    def grid2spectral(self):
        self._state = prog.grid2spectral(self._consts, self._state)

    def spectral2grid(self):
        self._state = prog.spectral2grid(self._consts, self._state)

    def apply_grid_filter(self):
        """Spectrally truncate the grid-space prognostic mirrors (reference
        driver: apply_grid_filter, speedy_driver.f90)."""
        self._state = prog.grid_filter_prognostics(self._consts, self._state)

    # -- checkpoint / restore ---------------------------------------------

    def save_checkpoint(self, path):
        """Save the full model state plus the stepping metadata, in the JAX
        package's .npz format (v4): the leapfrog levels stacked, the SPPT
        key as uint32 key data. The JAX package loads it, and this one loads
        the JAX package's."""
        def host(v):
            return v.detach().cpu().numpy()

        arrays = {k: (np.stack([host(a) for a in v])
                      if isinstance(v, tuple) else host(v))
                  for k, v in self._state.items()}
        if "sppt_key" in arrays:
            arrays["sppt_key"] = arrays["sppt_key"].astype(np.uint32)
        meta = dict(
            format_version=_CHECKPOINT_VERSION,
            current_step=self._current_step,
            cal=(self._cal.year, self._cal.month, self._cal.day,
                 self._cal.hour, self._cal.minute, self._cal.month_idx,
                 self._cal.second),
            current_date=self.current_date.isoformat(),
        )
        np.savez_compressed(path, __meta__=np.asarray([repr(meta)]), **arrays)

    def load_checkpoint(self, path):
        """Restore a state saved by save_checkpoint, of this package or of
        the JAX package (formats v3 and v4). The model must already be
        initialized (set_bc) with the same configuration."""
        with np.load(path, allow_pickle=False) as data:
            meta = ast.literal_eval(str(data["__meta__"][0]))
            version = meta.get("format_version", 1)
            if version not in _CHECKPOINT_LOADABLE:
                raise RuntimeError(
                    f"Checkpoint format version {version} is not supported "
                    f"(current: {_CHECKPOINT_VERSION}, loadable: "
                    f"{_CHECKPOINT_LOADABLE}). Versions 1-2 stored spectral "
                    "fields in older layouts; regenerate the checkpoint "
                    "with this version.")
            for k in self._state:
                if k not in data.files:
                    continue
                cur = self._state[k]
                saved = data[k]
                if saved.dtype.kind == "u":
                    saved = saved.astype(np.int64)
                if isinstance(cur, tuple):
                    self._state[k] = tuple(
                        self._tensor_like(saved[i], cur[i])
                        for i in range(len(cur)))
                else:
                    self._state[k] = self._tensor_like(saved, cur)
        self._current_step = int(meta["current_step"])
        y, m, d, h, mi, midx, *rest = meta["cal"]
        self._cal = ModelCalendar(y, m, d, h, mi, month_idx=midx,
                                  nsteps=self.params.nsteps,
                                  second=rest[0] if rest else 0)
        self.current_date = datetime.fromisoformat(meta["current_date"])

    def check(self):
        """Diagnostics range check (reference: pyspeedy/speedy.py:479-483)."""
        bad = check_diagnostics(self._consts,
                                M.add_member_axis(self._state, 1), 0)
        if bool(bad.any()):
            raise RuntimeError(ERROR_CODES[E_DIAGNOSTICS_OUTSIDE_RANGE])

    def to_dataframe(self, variables=None):
        """Export the current state as a CF-metadata Dataset
        (reference: pyspeedy/speedy.py:415-477)."""
        if variables is None:
            variables = DEFAULT_OUTPUT_VARS

        self.spectral2grid()
        data_vars = {}
        for var in variables:
            spec = REGISTRY[var]
            dims = list(spec.nc_dims) + ["time"]
            var_data = self[var][..., None].astype("float32")
            if self.is_ensemble_member:
                dims = dims + ["ens"]
                var_data = var_data[..., None]
            attrs = {"units": spec.units, "long_name": spec.long_name,
                     "standard_name": spec.std_name}
            data_vars[spec.alt_name] = Variable(dims, var_data, attrs)

        coords = {
            "lon": Variable(("lon",), self["lon"],
                            {"units": "degrees_east", "long_name": "longitude",
                             "standard_name": "lon", "axis": "X"}),
            "lat": Variable(("lat",), self["lat"],
                            {"units": "degrees_north",
                             "long_name": "latitude",
                             "standard_name": "lat", "axis": "Y"}),
            "lev": Variable(("lev",), self["lev"],
                            {"long_name": "Vertical sigma coordinate",
                             "standard_name": "lev"}),
            "time": Variable(("time",),
                             np.array([np.datetime64(self.current_date)]),
                             {"axis": "T", "standard_name": "time"}),
        }
        if self.is_ensemble_member:
            coords["ens"] = Variable(("ens",),
                                     np.array([self.member_id], dtype="int32"))

        ds = Dataset(data_vars=data_vars, coords=coords)
        sorted_dims = (("time", "ens", "lev", "lat", "lon")
                       if self.is_ensemble_member
                       else ("time", "lev", "lat", "lon"))
        ds = ds.reindex(lev=ds.coords["lev"].data[::-1]).transpose(*sorted_dims)
        return ds


def _decode_cf_time(values, units):
    """Decode 'X since YYYY-mm-dd...' numeric time to datetime64."""
    m = re.match(r"(\w+) since (\d{4}-\d{2}-\d{2})[ T]?(\d{2}:\d{2}:\d{2})?",
                 units)
    if not m:
        raise ValueError(f"Cannot parse time units: {units!r}")
    unit, date, time = m.groups()
    ref = np.datetime64(f"{date}T{time or '00:00:00'}")
    scale = {"days": "D", "hours": "h", "minutes": "m",
             "seconds": "s"}[unit]
    return ref + values.astype(f"timedelta64[{scale}]").astype(
        "timedelta64[s]")


class SpeedyEns:
    """Ensemble of Speedy instances (reference: pyspeedy/speedy.py:486-597).

    run() advances all members together through the member-batched runner
    (see parallel/ensemble.py); this class keeps the reference's per-member
    object API on top of it."""

    def __init__(self, num_of_members, start_date=datetime(1982, 1, 1),
                 end_date=datetime(1982, 1, 2), params: ModelParams = T30L8,
                 device="cuda", bf16_tendencies: bool = False):
        self.n_members = num_of_members
        self.members = [
            Speedy(start_date=start_date, end_date=end_date, member=m,
                   params=params, device=device,
                   bf16_tendencies=bf16_tendencies)
            for m in range(num_of_members)
        ]
        self.current_date = self.members[0].current_date

    def __iter__(self):
        return iter(self.members)

    def __len__(self):
        return self.n_members

    def set_params(self, start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2)):
        for member in self:
            member.set_params(start_date=start_date, end_date=end_date)
        self.current_date = start_date

    @property
    def _dt_step(self):
        return self.members[0]._dt_step

    def to_dataframe(self, variables=None):
        return merge([m.to_dataframe(variables=variables) for m in self],
                     join="outer", compat="no_conflicts")

    def get_current_step(self):
        return self.members[0].get_current_step()

    def run(self, callbacks=None, batched=None):
        """Step all members in lockstep (the reference uses OpenMP threads,
        speedy_driver.f90:58-79).

        batched=True (the default when all members share one configuration)
        stacks the members' carried fields and advances them as one
        member-batched run; batched=False steps the members one by one."""
        if callbacks is None:
            callbacks = []

        end_date = self.members[0].end_date
        total = round((end_date - self.current_date) / self._dt_step)
        intervals = [cb.interval for cb in callbacks
                     if getattr(cb, "interval", None)]
        chunk = math.gcd(*intervals) if intervals else max(total, 1)

        if batched is None:
            batched = all(m._consts is self.members[0]._consts
                          for m in self.members)

        done = 0
        while done < total:
            n = min(chunk, total - done)
            if batched:
                self._advance_batched(n)
            else:
                for member in self:
                    member._advance(n)
            errors = {m: E_DIAGNOSTICS_OUTSIDE_RANGE
                      for m, member in enumerate(self)
                      if bool(member._state["error_flag"])}
            done += n
            self.current_date += self._dt_step * n
            for member in self:
                member.current_date = self.current_date
            if errors:
                msg = "".join(f"Member{m}: {ERROR_CODES[c]}\n"
                              for m, c in errors.items())
                raise RuntimeError(msg)
            for callback in callbacks:
                callback(self)

    def _advance_batched(self, n_steps):
        """One member-batched run of n_steps per chunk of members: the
        members' carried fields stacked on a leading member axis, the
        loop-invariant fields shared (the lead member's)."""
        lead = self.members[0]
        consts = lead._consts
        run = lead._run
        n = len(self.members)
        chunk = pick_member_chunk(n, consts.params)
        ctx, cal = M.build_step_ctx(lead._cal, lead._current_step, n_steps)
        # With the physics off nothing writes the per-step diagnostics: they
        # stay single-member, shared by all members.
        batched = M.DYNAMIC_FIELDS if consts.physics_on else M.CARRY_FIELDS
        for c0 in range(0, n, chunk):
            sub = self.members[c0:c0 + chunk]
            state = dict(sub[0]._state)
            for name in M.CARRY_FIELDS:
                if name in state:
                    vals = [m._state[name] for m in sub]
                    state[name] = (tuple(torch.stack(lv) for lv in zip(*vals))
                                   if isinstance(vals[0], tuple)
                                   else torch.stack(vals))
            out = run(state, ctx)
            for m, member in enumerate(sub):
                st = dict(member._state)
                for name in batched:
                    if name in out:
                        st[name] = M._map_levels(lambda a: a[m], out[name])
                member._state = st
                member._current_step += n_steps
                member._cal = dataclasses.replace(cal)
