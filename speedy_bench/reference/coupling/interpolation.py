"""Time interpolation of monthly climatologies (reference:
speedy.f90/interpolation.f90); fields are (12, il, ix) tensors (or (M, il,
ix) for SST anomalies).

Each interpolation comes in two forms. The scalar form takes a 1-based month
index and the month fraction as Python values, as the host calendar gives
them. The table form takes the month rows as an int64 tensor and the weights
as tensors of the field's dtype, on the field's device, so that nothing in
it depends on a host value: the form a CUDA graph of the step can record.
The host computes the rows and weights of both forms with the same float64
arithmetic (``*_weights``); a weight rounded to the field's dtype on its way
to the device multiplies as the Python scalar does (PyTorch rounds a Python
float to the tensor's dtype), so both forms give the same bits.
``coupler_rows`` packs the rows and weights of the coupler's three
interpolations at one date.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["forint", "forin5", "monthly_interp", "forint_weights",
           "forin5_weights", "monthly_weights", "forint_t", "forin5_t",
           "CouplerTables", "coupler_rows", "N_COUPLER_ROWS",
           "N_COUPLER_WEIGHTS"]


def forint_weights(imon: int, tmonth: float):
    """(row of the month, row of its neighbour, weight) of forint."""
    i0 = imon - 1
    if tmonth <= 0.5:
        return i0, (i0 + 11) % 12, 0.5 - tmonth
    return i0, (i0 + 1) % 12, tmonth - 0.5


def forin5_weights(imon: int, tmonth: float):
    """((rows of months -2..+2), (their five weights)) of forin5."""
    i0 = imon - 1
    rows = tuple((i0 + d) % 12 for d in (-2, -1, 0, 1, 2))

    c0 = 1.0 / 12.0
    t0 = c0 * tmonth
    t1 = c0 * (1.0 - tmonth)
    t2 = 0.25 * tmonth * (1.0 - tmonth)

    wm2 = -t1 + t2
    wm1 = -c0 + 8.0 * t1 - 6.0 * t2
    w0 = 7.0 * c0 + 10.0 * t2
    wp1 = -c0 + 8.0 * t0 - 6.0 * t2
    wp2 = -t0 + t2
    return rows, (wm2, wm1, w0, wp1, wp2)


def monthly_weights(month_idx: int, month_fraction: float):
    """(row of the month, row of its neighbour, weight) of monthly_interp."""
    if month_fraction <= 0.5:
        return month_idx, month_idx - 1, 0.5 - month_fraction
    return month_idx, month_idx + 1, month_fraction - 0.5


def forint(for12, imon: int, tmonth: float):
    """Piecewise-linear interpolation with month wrap-around
    (interpolation.f90:40-59)."""
    i0, i2, w = forint_weights(imon, tmonth)
    f1 = for12[i0]
    return f1 + w * (for12[i2] - f1)


def forin5(for12, imon: int, tmonth: float):
    """Mean-conserving 5-point interpolation (interpolation.f90:62-94)."""
    (im2, im1, i0, ip1, ip2), (wm2, wm1, w0, wp1, wp2) = forin5_weights(
        imon, tmonth)
    return (wm2 * for12[im2] + wm1 * for12[im1] + w0 * for12[i0]
            + wp1 * for12[ip1] + wp2 * for12[ip2])


def monthly_interp(field, month_idx: int, month_fraction: float):
    """Non-wrapping interpolation for the SST anomaly record, indexed by
    simulation month with one pad slab on each side
    (interpolation.f90:17-37)."""
    i0, i2, w = monthly_weights(month_idx, month_fraction)
    f1 = field[i0]
    return f1 + w * (field[i2] - f1)


def forint_t(for12, rows: torch.Tensor, w: torch.Tensor, out=None):
    """forint from its two rows (int64 (2,)) and its weight (0-d); with
    monthly_weights' rows and weight, monthly_interp (the same formula).
    The result is written into `out` when given."""
    f = for12.index_select(0, rows)
    return torch.add(f[0], w * (f[1] - f[0]), out=out)


def forin5_t(for12, rows: torch.Tensor, w: torch.Tensor, out=None):
    """forin5 from its five rows (int64 (5,)) and weights ((5,)), written
    into `out` when given."""
    f = for12.index_select(0, rows)
    return torch.add(w[0] * f[0] + w[1] * f[1] + w[2] * f[2] + w[3] * f[3],
                     w[4] * f[4], out=out)


def shared_plane(t):
    """The plane that `t` holds for all its members, t[0], where t expands
    one plane over its leading (member) axis (stride 0) or has one member;
    else None."""
    if t is None or not t.dim() or (t.stride(0) != 0 and t.shape[0] != 1):
        return None
    return t[0]


# Layout of coupler_rows: rows 0-4 and weights 0-4 are forin5's, rows 5-6
# and weight 5 forint's, rows 7-8 and weight 6 the SST anomaly record's.
N_COUPLER_ROWS = 9
N_COUPLER_WEIGHTS = 7
_SST_ROWS = slice(7, 9)


class CouplerTables(NamedTuple):
    """The coupler's month rows (int64, (..., N_COUPLER_ROWS)) and weights
    (the model dtype, (..., N_COUPLER_WEIGHTS)) on the model's device: one
    date, or a leading step axis for a run call."""

    rows: torch.Tensor
    w: torch.Tensor

    def forin5(self, for12, out=None):
        return forin5_t(for12, self.rows[0:5], self.w[0:5], out)

    def forint(self, for12, out=None):
        return forint_t(for12, self.rows[5:7], self.w[5], out)

    def sst_anom(self, field):
        return forint_t(field, self.rows[_SST_ROWS], self.w[6])

    @classmethod
    def from_host(cls, rows, w, n_records: int, dtype,
                  device) -> "CouplerTables":
        """The tables of coupler_rows' host arrays on `device`, the weights
        rounded to `dtype`. The SST anomaly record has n_records slabs: a
        row outside it raises IndexError here (the scalar form raises it
        past the end; the calendar's month_idx starts at 1, so no row is
        negative)."""
        rows = np.asarray(rows, dtype=np.int64)
        sst = rows[..., _SST_ROWS]
        if sst.size and (sst.min() < 0 or sst.max() >= n_records):
            raise IndexError(
                f"SST anomaly rows {sst.min()}..{sst.max()} outside a record "
                f"of {n_records} slabs")
        return cls(torch.from_numpy(rows).to(device),
                   torch.from_numpy(np.asarray(w, np.float64)).to(
                       device=device, dtype=dtype))


def coupler_rows(imont1: int, tmonth: float, month_idx: int):
    """(rows int64 (N_COUPLER_ROWS,), weights float64 (N_COUPLER_WEIGHTS,))
    of the coupler's three interpolations at one date, on the host."""
    rows5, w5 = forin5_weights(imont1, tmonth)
    i0, i2, w = forint_weights(imont1, tmonth)
    j0, j2, wj = monthly_weights(month_idx, tmonth)
    return (np.array(rows5 + (i0, i2, j0, j2), dtype=np.int64),
            np.array(w5 + (w, wj), dtype=np.float64))
