"""The work of each layer of a step, counted from the shapes: one module a
layer, each with ``count(params, members, sppt) -> (flops, bytes)`` for one
step of a chunk of `members` members (``params`` the configuration's
``reference.params.ModelParams``, float32 unless it says otherwise). Bytes
count each input element read once and each output element written once,
whatever the kernel reads again; operations are the least the layer's
arithmetic needs (the transforms' folded multiply-adds, two operations
each). A layer's roofline bound is the larger of flops over the peak rate
of the units its arithmetic runs on and bytes over the memory rate
(``peaks.json``): the float32 or float64 rate outside the tensor cores,
unless the layer's module names another by ``peak_key(params)``."""

import importlib

__all__ = ["count", "itemsize", "peak_key"]


def itemsize(params) -> int:
    return 8 if params.precision == "f64" else 4


def count(layer: str, params, members: int, sppt: bool) -> tuple:
    """(flops, bytes) of `layer` (a module of this package) for one step of
    `members` members."""
    mod = importlib.import_module(f"{__name__}.{layer}")
    return mod.count(params, members, sppt)


def peak_key(layer: str, params) -> str:
    """The key of ``peaks.json`` whose operation rate bounds `layer`."""
    own = getattr(importlib.import_module(f"{__name__}.{layer}"),
                  "peak_key", lambda params: None)
    return own(params) or ("float64_flops_per_s" if params.precision == "f64"
                           else "float32_flops_per_s")
