"""Boundary-condition initialization and sanitation (reference:
speedy.f90/boundaries.f90). All numpy, init-time only."""

from __future__ import annotations

import numpy as np

__all__ = ["check_surface_fields", "fill_missing_values"]


def check_surface_fields(fmask, fmin, fmax, fset, field):
    """Set undefined values (where fmask == 0) to fset; out-of-range values
    over the mask are counted but, as in the reference, left untouched
    (boundaries.f90:41-64). field: (..., il, ix) numpy, modified copy
    returned with the fault count."""
    field = np.array(field, copy=True)
    masked = fmask > 0.0
    bad = ((field < fmin) | (field > fmax)) & masked
    nfault = int(bad.sum())
    field[..., ~masked] = fset
    return field, nfault


def fill_missing_values(sf, fmis):
    """Replace missing values (< fmis) by neighbor/zonal-mean fill, sweeping
    each hemisphere from the equator outward with the zonal mean carried to
    all-missing rows (boundaries.f90:70-114). sf: (il, ix) numpy."""
    sf = np.array(sf, copy=True)
    il, ix = sf.shape
    fmean = 0.0
    rows = list(range(il // 2 - 1, -1, -1)) + list(range(il // 2, il))
    for j in rows:
        row = sf[j]
        miss = row < fmis
        nmis = int(miss.sum())
        work = np.where(miss, 0.0, row)
        if nmis < ix:
            fmean = work.sum() / (ix - nmis)
        work = np.where(miss, fmean, row)
        left = np.roll(work, 1)
        right = np.roll(work, -1)
        sf[j] = np.where(miss, 0.5 * (left + right), row)
    return sf
