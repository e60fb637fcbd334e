"""Hydrostatic geopotential in spectral space (reference:
speedy.f90/geopotential.f90)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as pc
from ..ops.geometry import Geometry
from ..params import ModelParams

__all__ = ["GeopotTables", "build_geopot", "get_geopotential",
           "get_geopotential_grid", "hydrostatic_grid_levels",
           "hydrostatic_m0corr"]


class GeopotTables(NamedTuple):
    xgeop1: torch.Tensor  # (kx,)
    xgeop2: torch.Tensor  # (kx,) (entry 0 unused)
    corf: torch.Tensor    # (kx,) zonal-mean lapse-rate correction factors
    # Host copies of the two hydrostatic columns: the integration multiplies
    # whole planes by one scalar per level, and a Python float costs no
    # device read.
    xgeop1_host: tuple
    xgeop2_host: tuple


def build_geopot(params: ModelParams, geom: Geometry,
                 device="cuda") -> GeopotTables:
    """Hydrostatic constants (geopotential.f90:16-31) and the tropospheric
    zonal-mean correction factors (geopotential.f90:73-76)."""
    kx = params.kx
    hsg, fsg = geom.hsg, geom.fsg
    xgeop1 = np.zeros(kx)
    xgeop2 = np.zeros(kx)
    for k in range(kx):
        xgeop1[k] = pc.RGAS * np.log(hsg[k + 1] / fsg[k])
        if k != kx - 1:
            xgeop2[k + 1] = pc.RGAS * np.log(fsg[k + 1] / hsg[k + 1])

    corf = np.zeros(kx)
    for k in range(1, kx - 1):
        corf[k] = xgeop1[k] * 0.5 * np.log(hsg[k + 1] / fsg[k]) \
            / np.log(fsg[k + 1] / fsg[k - 1])

    dt = params.np_dtype
    a = lambda x: torch.from_numpy(np.asarray(x, dtype=dt)).to(device)
    host = lambda x: tuple(float(v) for v in np.asarray(x, dtype=dt))
    return GeopotTables(xgeop1=a(xgeop1), xgeop2=a(xgeop2), corf=a(corf),
                        xgeop1_host=host(xgeop1), xgeop2_host=host(xgeop2))


def get_geopotential(gp: GeopotTables, t: torch.Tensor,
                     phis: torch.Tensor, out=None) -> torch.Tensor:
    """Bottom-up hydrostatic integration in spectral space
    (geopotential.f90:49-77).

    t: (..., kx, mx, nx) spectral temperature; phis: (2, mx, nx), shared by
    all members, or anything that broadcasts against t[..., 0, :, :].
    Returns phi: (..., kx, mx, nx), written into `out` when given.
    """
    kx = t.shape[-3]
    x1, x2 = gp.xgeop1_host, gp.xgeop2_host
    levels = [None] * kx
    levels[kx - 1] = phis + x1[kx - 1] * t[..., kx - 1, :, :]
    for k in range(kx - 2, -1, -1):
        levels[k] = (levels[k + 1] + x2[k + 1] * t[..., k + 1, :, :]
                     + x1[k] * t[..., k, :, :])
    phi = torch.stack(levels, dim=-3, out=out)

    # Zonal-mean (m=0) lapse-rate correction in the free troposphere: corf is
    # zero at k=0 and k=kx-1, and only the m=0 row is touched (in place: phi
    # is a fresh tensor or `out`).
    dtk = t[..., 2:, 0, :] - t[..., :-2, 0, :]
    phi[..., 1:-1, 0, :] += gp.corf[1:-1, None] * dtk
    return phi


def hydrostatic_grid_levels(gp: GeopotTables, tg: torch.Tensor,
                            phisg: torch.Tensor) -> torch.Tensor:
    """The hydrostatic recursion of `get_geopotential` on grid fields, without
    the m=0 correction: tg (B, kx, il, ix), phisg (il, ix)."""
    kx = tg.shape[1]
    x1, x2 = gp.xgeop1_host, gp.xgeop2_host
    levels = [None] * kx
    levels[kx - 1] = phisg + x1[kx - 1] * tg[:, kx - 1]
    for k in range(kx - 2, -1, -1):
        levels[k] = levels[k + 1] + x2[k + 1] * tg[:, k + 1] + x1[k] * tg[:, k]
    return torch.stack(levels, dim=1)


def hydrostatic_m0corr(gp: GeopotTables, sp, t_spec: torch.Tensor):
    """The zonally-uniform m=0 lapse-rate correction of the hydrostatic
    geopotential on the grid (geopotential.f90:73-76), from the m=0 column of
    the spectral temperature (one (nx -> il) product; the m=0 inverse DFT is
    the identity on the real plane, fourier.f90:72-76): corr(k, j) = corf[k]
    * sum_n (t[k+1] - t[k-1])_re[m=0, n] * P(j, 0, n). t_spec:
    (B, 2, kx, mx, nx). Returns (B, kx, il, 1).

    The n-sum is a product and a reduction over the last axis, not a matrix
    product: a matrix library picks its algorithm, and with it the order of
    the sum, by the number of rows, so a member's correction would depend on
    how many members run beside it (on the card by 1e-7 in float32, enough
    for a column to take another branch of the physics). The reduction of a
    32-element row keeps its order whatever the batch."""
    t0 = t_spec[:, 0, :, 0, :]                        # (B, kx, nx) real m=0
    tpad = torch.nn.functional.pad(t0, (0, 0, 1, 1))
    dtk = tpad[:, 2:] - tpad[:, :-2]
    leg0 = sp.cpol_inv_full[:, 0, :]                  # (il, nx)
    corr = torch.sum((gp.corf[:, None] * dtk)[:, :, None, :] * leg0, dim=-1)
    return corr.unsqueeze(-1)


def get_geopotential_grid(gp: GeopotTables, sp, tg: torch.Tensor,
                          t_spec: torch.Tensor,
                          phisg: torch.Tensor) -> torch.Tensor:
    """Grid-space hydrostatic integration: phig == spec2grid(phi) without
    transforming the phi stack.

    The spectral recursion (geopotential.f90:49-77) is level-wise linear, so
    it commutes with the (linear) inverse transform: integrating the already
    transformed temperature tg against the same coefficients reproduces
    spec2grid(get_geopotential(...)) to rounding.

    tg: (B, kx, il, ix) grid temperature (= spec2grid of t_spec);
    t_spec: (B, 2, kx, mx, nx) the spectral pair tg came from;
    phisg: (il, ix) grid surface geopotential (spec2grid of state["phis"],
    loop-invariant, computed at initialization)."""
    return (hydrostatic_grid_levels(gp, tg, phisg)
            + hydrostatic_m0corr(gp, sp, t_spec))
