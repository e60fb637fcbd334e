"""State carried between this package and the JAX package, through numpy.

The caller converts a JAX-package state to numpy itself
(``jax.tree.map(np.asarray, state)``); nothing here imports JAX. Layouts are
identical on both sides: leapfrog levels as 2-tuples, spectral fields as real
pairs ``(2, ..., mx, nx)``, an optional leading member axis on the carried
fields."""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["state_from_numpy", "state_to_numpy"]


def _to_tensor(a, device, dtype):
    # np.array copies: the result is contiguous and writable (arrays that
    # come from JAX are read-only) and a 0-d array stays 0-d.
    a = np.array(a)
    if a.dtype.kind == "f":
        return torch.from_numpy(a).to(device, dtype)
    if a.dtype.kind in "bi":
        return torch.from_numpy(a).to(device)
    if a.dtype.kind == "u":
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return None


def state_from_numpy(state_np: dict, device="cuda",
                     dtype=torch.float64) -> dict:
    """numpy state dict -> dict of tensors on `device`. Floating arrays are
    cast to `dtype`; bool and signed integer arrays keep their type;
    unsigned ones (the raw uint32 key data of the stochastic physics,
    sppt_key) become int64 tensors holding the same words; entries of any
    other type are left out."""
    device = resolve_device(device)
    out = {}
    for name, val in state_np.items():
        if isinstance(val, (tuple, list)):
            levels = tuple(_to_tensor(a, device, dtype) for a in val)
            if all(x is not None for x in levels):
                out[name] = levels
        else:
            t = _to_tensor(val, device, dtype)
            if t is not None:
                out[name] = t
    return out


def state_to_numpy(state: dict) -> dict:
    """Dict of tensors (tuples for leapfrog levels) -> dict of numpy arrays.
    One device-to-host copy per tensor. The SPPT key words come back as the
    JAX package's raw uint32 key data."""
    conv = lambda t: t.detach().cpu().numpy()
    out = {name: (tuple(conv(a) for a in val)
                  if isinstance(val, (tuple, list)) else conv(val))
           for name, val in state.items()}
    if "sppt_key" in out:
        out["sppt_key"] = out["sppt_key"].astype(np.uint32)
    return out
