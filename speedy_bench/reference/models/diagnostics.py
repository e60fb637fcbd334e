"""Numerical-blowup diagnostics (reference: speedy.f90/diagnostics.f90).

Instead of aborting, the check returns one boolean per member; the step loop
ORs it into state["error_flag"] on the device and the caller reads the flag
once after the run (the reference maps the same condition to error code -2)."""

from __future__ import annotations

import math

import torch

from ..ops import spectral as S

__all__ = ["check_diagnostics"]


def check_diagnostics(consts, state, time_lev: int) -> torch.Tensor:
    """Per-level eddy KE of vor/div and global-mean T range check
    (diagnostics.f90:16-76) on the member-batched state. Returns a (B,) bool
    tensor, True where a member is out of range."""
    sp = consts.sp
    vor = state["vor"][time_lev]     # (B, 2, kx, mx, nx)
    div = state["div"][time_lev]
    t = state["t"][time_lev]

    def eddy_ke(x):
        # - sum over m>=1 (all n) of Re(lapinv(x) * conj(x)); on the real
        # pair that is lap_re*re + lap_im*im summed over the pair axis.
        prod = torch.sum(S.laplacian_inv(sp, x) * x, dim=1)   # (B, kx, mx, nx)
        return -torch.sum(prod[..., 1:, :], dim=(-2, -1))

    ke_vor = eddy_ke(vor)   # (B, kx)
    ke_div = eddy_ke(div)
    tmean = math.sqrt(0.5) * t[:, 0, :, 0, 0]

    bad = ((ke_vor > 500.0) | (ke_div > 500.0)
           | (tmean < 180.0) | (tmean > 320.0))
    return bad.any(dim=1)
