"""The column tables and the plain column functions of the step: the
grid-point dynamics and the column physics, always through their plain
PyTorch versions (a frozen copy of the port's plain path, with its kernel
dispatch taken out)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ColumnTables", "build_column_tables", "grid_dynamics",
           "grid_physics", "copy_into"]


class ColumnTables(NamedTuple):
    """What the grid-dynamics function needs besides its fields: per-level
    columns and per-latitude vectors on the device (for the plain version and
    as kernel inputs) and the per-level columns once more on the host, in the
    order the kernel's argument pack takes them."""

    dhs: torch.Tensor      # (kx, 1, 1) layer thickness
    dhsr: torch.Tensor     # (kx, 1, 1) 1/(2 dhs)
    fsgr: torch.Tensor     # (kx, 1, 1) akap/(2 fsg)
    tref: torch.Tensor     # (kx, 1, 1) reference temperature profile
    tref3: torch.Tensor    # (kx, 1, 1) fsgr * tref
    rcos: torch.Tensor     # (il, 1) 1/cos(lat)
    coriol: torch.Tensor   # (il, 1) Coriolis parameter
    levels_host: np.ndarray  # (5, kx) float64: dhs, dhsr, fsgr, tref, tref3

    @property
    def kx(self) -> int:
        return self.dhs.shape[0]


def build_column_tables(geom, tref, np_dtype, device) -> ColumnTables:
    """geom: numpy Geometry (f64); tref: (kx,) numpy f64 reference profile.
    Every table is rounded to the model dtype first, so the kernel's host
    copy and the device tensors hold the same values."""
    rows = [np.asarray(x, dtype=np_dtype) for x in
            (geom.dhs, geom.dhsr, geom.fsgr, tref, geom.fsgr * tref)]
    dev = lambda x, shape: torch.from_numpy(
        np.ascontiguousarray(x)).reshape(shape).to(device)
    kx = rows[0].shape[0]
    cols = [dev(x, (kx, 1, 1)) for x in rows]
    lat = [dev(np.asarray(x, dtype=np_dtype), (-1, 1))
           for x in (geom.cosgr, geom.coriol)]
    return ColumnTables(*cols, *lat,
                        levels_host=np.stack(rows).astype(np.float64))


def copy_into(out, results) -> tuple:
    """Copy each of `results` into its tensor of `out` (a tensor that is its
    own destination stays); returns `out` as a tuple. The CPU's destination
    path of the kernel wrappers."""
    out = tuple(out)
    if len(out) != len(results):
        raise ValueError(f"out: {len(out)} tensors for {len(results)} "
                         f"results")
    for dst, res in zip(out, results):
        if dst is not res:
            dst.copy_(res)
    return out


def grid_dynamics(plain_fn, tab: ColumnTables, vorg, divg, tg, trg_flat, ug,
                  vg, pxy, bf16_out: bool = False):
    """The plain PyTorch version `plain_fn`
    (``models.tendencies.grid_dynamics_core``) on any device."""
    return plain_fn(tab, vorg, divg, tg, trg_flat, ug, vg, pxy,
                    bf16_out=bf16_out)


def grid_physics(plain_fn, consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc,
                 cache, ablco2, phisg=None, m0corr=None, sppt_pattern=None,
                 out=None):
    """The plain PyTorch version `plain_fn` (``physics.driver.grid_physics``)
    on any device; with `out` ((diag, cache)) its results are copied in."""
    res = plain_fn(consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc,
                   cache, ablco2, phisg=phisg, m0corr=m0corr,
                   sppt_pattern=sppt_pattern)
    if out is None:
        return res
    return (*res[:4], copy_into(out[0], res[4]), copy_into(out[1], res[5]))
