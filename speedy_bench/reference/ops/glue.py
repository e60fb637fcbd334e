"""The spectral update through its plain PyTorch version on any device (a
frozen copy of the port's dispatch, with the kernel taken out)."""

from __future__ import annotations

from .columns import copy_into

__all__ = ["spectral_update"]


def spectral_update(plain_fn, consts, j1: int, dt: float, eps: float, specs,
                    psdt, *state, out=None):
    """`plain_fn` (``models.spectral_glue.spectral_update_plain``); with
    `out` (ten tensors) the results are copied in and `out` comes back."""
    res = plain_fn(consts, j1, dt, eps, specs, psdt, *state)
    return res if out is None else copy_into(out, res)
