"""Callbacks invoked at the end of model time steps (reference:
pyspeedy/callbacks.py): BaseCallback, DiagnosticCheck, ModelCheckpoint,
XarrayExporter — same interval/spinup gating semantics. The same code as
the JAX package's callbacks.py, on this package's Speedy/SpeedyEns and its
own utils/dataset.py."""

from __future__ import annotations

import copy
import os

from .utils.dataset import merge

__all__ = ["BaseCallback", "DiagnosticCheck", "ModelCheckpoint",
           "XarrayExporter"]


class BaseCallback:
    """Base callback (reference: callbacks.py:31-77)."""

    def __init__(self, *args, **kwargs):
        self.verbose = kwargs.pop("verbose", False)
        self.interval = kwargs.pop("interval", 1)
        self.spinup_date = kwargs.pop("spinup_date", None)

    def skip_flag(self, model_instance):
        """True when this step should be skipped (spinup or off-interval)."""
        if self.spinup_date is not None:
            if model_instance.current_date < self.spinup_date:
                return True
        return model_instance.get_current_step() % self.interval != 0

    def print_msg(self, msg):
        if self.verbose:
            print(msg)

    def copy(self):
        return copy.deepcopy(self)

    def __call__(self, model_instance):
        pass


class DiagnosticCheck(BaseCallback):
    """Range-check the prognostic variables every `interval` steps
    (reference: callbacks.py:80-112)."""

    def __init__(self, interval=36):
        super().__init__(interval=interval)

    def __call__(self, model_instance):
        if self.skip_flag(model_instance):
            return
        members = (model_instance
                   if hasattr(model_instance, "members")
                   else [model_instance])
        for member in members:
            member.check()


class ModelCheckpoint(BaseCallback):
    """Accumulate selected grid variables as an in-memory time-series dataset
    (reference: callbacks.py:115-180)."""

    def __init__(self, interval=36, verbose=False, spinup_date=None,
                 variables=None, output_dir="./"):
        if variables is None:
            from . import DEFAULT_OUTPUT_VARS
            variables = DEFAULT_OUTPUT_VARS
        self.variables = variables
        self.output_dir = output_dir
        self.history_interval = interval
        super().__init__(verbose=verbose, interval=interval,
                         spinup_date=spinup_date)
        self.dataframe = None

    def __call__(self, model_instance):
        if self.skip_flag(model_instance):
            return
        model_df = model_instance.to_dataframe(variables=self.variables)
        if self.dataframe is None:
            self.dataframe = model_df
        else:
            self.dataframe = merge((self.dataframe, model_df),
                                   join="outer", compat="no_conflicts")


class XarrayExporter(BaseCallback):
    """Write one NetCDF per interval; ensemble members go to "member###"
    subdirectories (e.g. ``member002/1982-01-02_0000.nc``).

    The reference *documents* this per-member layout (callbacks.py:190-192)
    but its code writes a single merged file regardless; here the documented
    contract is implemented: a SpeedyEns instance writes one file per member
    under its subdirectory, a single Speedy writes one file in output_dir."""

    def __init__(self, interval=36, verbose=False, spinup_date=None,
                 variables=None, output_dir="./",
                 filename_fmt="%Y-%m-%d_%H%M.nc"):
        if variables is None:
            from . import DEFAULT_OUTPUT_VARS
            variables = DEFAULT_OUTPUT_VARS
        self.variables = variables
        self.output_dir = output_dir
        self.filename_fmt = filename_fmt
        self.history_interval = interval
        super().__init__(verbose=verbose, interval=interval,
                         spinup_date=spinup_date)

    def __call__(self, model_instance):
        if self.skip_flag(model_instance):
            return
        file_name = model_instance.current_date.strftime(self.filename_fmt)
        members = getattr(model_instance, "members", None)
        if members is not None:
            # Ensemble: one file per member under member### (the
            # reference's documented-but-unimplemented contract).
            for member in members:
                sub = os.path.join(self.output_dir,
                                   f"member{member.member_id:03d}")
                os.makedirs(sub, exist_ok=True)
                path = os.path.join(sub, file_name)
                self.print_msg(f"Saving member output at: {path}.")
                member.to_dataframe(variables=self.variables).to_netcdf(path)
            return
        model_df = model_instance.to_dataframe(variables=self.variables)
        os.makedirs(self.output_dir, exist_ok=True)
        output_file_path = os.path.join(self.output_dir, file_name)
        self.print_msg(f"Saving model output at: {output_file_path}.")
        model_df.to_netcdf(output_file_path)
