"""Helpers for level-stacked grid fields.

The column physics works on fields whose level axis is third from the end:
(..., kx, il, ix), with any leading axes (a member axis, or none). Per-level
constants come from the numpy geometry; they become (kx, 1, 1) tensors of the
field's dtype on the field's device where a whole stack is scaled at once, and
stay Python scalars inside level loops.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LEV", "lev", "stack", "col", "floats", "shift_up", "shift_down"]

LEV = -3


def lev(x: torch.Tensor, k: int) -> torch.Tensor:
    """Level k of a (..., kx, il, ix) stack: (..., il, ix)."""
    return x[..., k, :, :]


def stack(levels) -> torch.Tensor:
    return torch.stack(list(levels), dim=LEV)


def col(values, like: torch.Tensor) -> torch.Tensor:
    """Per-level constants as a (n, 1, 1) tensor matching `like`."""
    return torch.as_tensor(np.asarray(values, dtype=np.float64),
                           dtype=like.dtype, device=like.device
                           ).reshape(-1, 1, 1)


def floats(values) -> list:
    """A numpy table as Python floats (exactly the table's values): a numpy
    scalar on the left of a tensor would take the product to numpy."""
    return np.asarray(values, dtype=np.float64).tolist()


def shift_up(x: torch.Tensor, shift: int) -> torch.Tensor:
    """out[k] = x[k + shift], zeros flowing in at the bottom."""
    n = x.shape[LEV]
    return torch.cat([x.narrow(LEV, shift, n - shift),
                      torch.zeros_like(x.narrow(LEV, 0, shift))], dim=LEV)


def shift_down(x: torch.Tensor, shift: int) -> torch.Tensor:
    """out[k] = x[k - shift], zeros flowing in at the top."""
    n = x.shape[LEV]
    return torch.cat([torch.zeros_like(x.narrow(LEV, 0, shift)),
                      x.narrow(LEV, 0, n - shift)], dim=LEV)
