"""Boundary fields given on another Gaussian grid, brought to the model's
(numpy, float64, on the host, at set-up only).

A boundary file holds each field on a Gaussian grid of its own: longitudes
from 0 eastward at an even spacing, latitudes south to north, as pySPEEDY's
file is laid out at T30 (96 x 48). ``remap_bc`` takes such fields in the
internal ``([month,] lat, lon)`` layouts and returns them on the model's
grid:

- Missing values. Every value >= MISSING (the bundled file marks land or
  sea points with 9.969e36) is missing. A field that holds one has them set
  below 0 and each of its months filled by SPEEDY's own neighbour and
  zonal-mean sweep (``boundaries.fill_missing_values(., 0.0)``), so that
  every source cell holds a value. Such fields (temperatures, depths,
  fractions) hold no valid value below 0; a field without a missing value
  (the orography, which goes below 0) is taken as it is. The SST anomalies
  are signed: theirs are set to 0, a zero anomaly, and not swept.
- The remap. First-order conservative: a target cell's value is the
  area-weighted mean of the source cells it overlaps. Longitude bounds lie
  midway between points; latitude bounds lie at the cumulative Gaussian
  weights in sin(lat), so a cell's area is its quadrature weight and the
  remap keeps every field's Gaussian-weighted global mean. The land-sea
  mask becomes the land fraction of each target cell; the model's masks
  (``check_surface_fields``, ``bmask_land``, ``bmask_sea``) then act on the
  remapped fields as on the model's own file, and the initialization
  truncates the orography spectrally.

As a script it writes a boundary file on a preset's grid: the same
variable names, the (lon, lat[, time]) layout and float32, NetCDF3:

    python -m pyspeedy_tpu_torch.coupling.remap --preset T63 <in.nc> <out.nc>
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..ops.geometry import build_geometry
from ..ops.spectral import gaussian_nodes_and_weights
from ..utils import profiling
from ..utils.dataset import Dataset, Variable, open_dataset
from .boundaries import fill_missing_values

__all__ = ["MISSING", "ANOMALY", "NC_NAMES", "lat_bounds", "lon_bounds",
           "remap_weights", "fill_field", "remap_field", "off_grid",
           "remap_bc", "read_bc", "write_bc", "main"]

# A value at or above this is missing.
MISSING = 1e30
# The key of the SST anomaly record among the host fields: signed, so its
# missing values become 0 and are not swept.
ANOMALY = "sst_anom"


def lat_bounds(nlat: int) -> np.ndarray:
    """The nlat + 1 cell bounds, in sin(lat) from -1 to 1, of a Gaussian
    grid of nlat latitudes south to north: the cumulative quadrature
    weights, each hemisphere summed from its pole and the equator at 0."""
    _, w = gaussian_nodes_and_weights(nlat // 2)     # pole to equator
    s = np.concatenate([[0.0], np.cumsum(w)])
    s /= s[-1]
    return np.concatenate([s - 1.0, (1.0 - s[::-1])[1:]])


def lon_bounds(nlon: int) -> np.ndarray:
    """The nlon + 1 cell bounds, in turns, of nlon longitudes at i / nlon:
    midway between points."""
    return (np.arange(nlon + 1) - 0.5) / nlon


def _overlap(target: np.ndarray, source: np.ndarray,
             period: float | None = None) -> np.ndarray:
    """(n_target, n_source) overlap lengths of two sets of intervals given
    by their bounds, the source shifted by -period, 0 and +period when
    periodic."""
    lo_t, hi_t = target[:-1, None], target[1:, None]
    out = 0.0
    for shift in ((-period, 0.0, period) if period else (0.0,)):
        lo_s, hi_s = source[None, :-1] + shift, source[None, 1:] + shift
        out = out + np.maximum(np.minimum(hi_t, hi_s)
                               - np.maximum(lo_t, lo_s), 0.0)
    return out


def remap_weights(src: tuple, dst: tuple) -> tuple:
    """(latitude weights (il_dst, il_src), longitude weights (ix_dst,
    ix_src)) of the conservative remap from the (nlat, nlon) grid `src` to
    `dst`: each row the overlaps over their sum, which is the target
    cell's width."""
    lat = _overlap(lat_bounds(dst[0]), lat_bounds(src[0]))
    lon = _overlap(lon_bounds(dst[1]), lon_bounds(src[1]), 1.0)
    return (lat / lat.sum(axis=1, keepdims=True),
            lon / lon.sum(axis=1, keepdims=True))


def fill_field(name: str, field: np.ndarray) -> tuple:
    """(the field with its missing values supplied, how many there were):
    see the module's docstring. `field` is ([month,] lat, lon)."""
    field = np.array(field, dtype=np.float64)
    missing = field >= MISSING
    n = int(missing.sum())
    if n == 0:
        return field, 0
    if name == ANOMALY:
        field[missing] = 0.0
        return field, n
    field[missing] = -1.0
    planes = field.reshape((-1,) + field.shape[-2:])
    filled = np.stack([fill_missing_values(p, 0.0) for p in planes])
    return filled.reshape(field.shape), n


def remap_field(field: np.ndarray, weights: tuple) -> np.ndarray:
    """A filled ([month,] lat, lon) field on the target grid of `weights`
    (remap_weights), latitudes first. The sums are einsum's own loops, in a
    fixed order, not a BLAS call."""
    wlat, wlon = weights
    planes = field.reshape((-1,) + field.shape[-2:])
    out = np.einsum("mtj,uj->mtu", np.einsum("ti,mij->mtj", wlat, planes),
                    wlon)
    return out.reshape(field.shape[:-2] + out.shape[-2:])


def off_grid(host_bc: dict, il: int, ix: int) -> list:
    """The names of the fields of `host_bc` (numpy arrays; other entries are
    skipped) that do not lie on the il x ix grid."""
    return sorted(k for k, v in host_bc.items()
                  if isinstance(v, np.ndarray) and v.shape[-2:] != (il, ix))


def remap_bc(host_bc: dict, il: int, ix: int) -> dict:
    """`host_bc` with every field that is not on the il x ix grid filled
    and remapped onto it (the span `bc.remap`; the store's set-up counters
    `remap_fields` and `remap_filled_points`). The other entries are
    passed as they are."""
    out = dict(host_bc)
    names = off_grid(host_bc, il, ix)
    filled = 0
    weights = {}
    with profiling.span("bc.remap"):
        for name in names:
            field, n = fill_field(name, host_bc[name])
            filled += n
            src = field.shape[-2:]
            if src not in weights:
                weights[src] = remap_weights(src, (il, ix))
            out[name] = remap_field(field, weights[src])
    profiling.record_remap(len(names), filled)
    return out


# The boundary file's variables, by the model's name of each field.
NC_NAMES = {"orog": "orog", "fmask_orig": "lsm", "alb0": "alb",
            "veg_high": "vegh", "veg_low": "vegl", "stl12": "stl",
            "snowd12": "snowd", "soil_wc_l1": "swl1", "soil_wc_l2": "swl2",
            "soil_wc_l3": "swl3", "sst12": "sst", "sea_ice_frac12": "icec"}


def read_bc(path: str) -> tuple:
    """({model name: float64 field in ([month,] lat, lon) order}, the
    Dataset) of a boundary file whose variables are (lon, lat[, time])."""
    ds = open_dataset(path)
    fields = {}
    for name, var in NC_NAMES.items():
        data = np.asarray(ds[var].values, dtype=np.float64)
        fields[name] = np.moveaxis(data, (0, 1), (-1, -2))
    return fields, ds


def write_bc(src: str, dst: str, params) -> None:
    """Write the boundary file `src` remapped to the grid of `params` as
    `dst`: its variable names and attributes, (lon, lat[, time]) float32,
    the model's own longitudes and latitudes, the source's times."""
    fields, ds = read_bc(src)
    fields = remap_bc(fields, params.il, params.ix)
    geom = build_geometry(params)
    drop = ("_FillValue",)
    attrs = lambda v: {k: a for k, a in v.attrs.items() if k not in drop}
    coords = {
        "lon": Variable(("lon",), 360.0 / params.ix * np.arange(params.ix),
                        attrs(ds["lon"])),
        "lat": Variable(("lat",), np.rad2deg(geom.radang), attrs(ds["lat"])),
        "time": Variable(("time",), ds["time"].values, attrs(ds["time"]))}
    data = {}
    for name, var in NC_NAMES.items():
        src_var = ds[var]
        values = np.moveaxis(fields[name], (-1, -2), (0, 1))
        data[var] = Variable(src_var.dims, values.astype(np.float32),
                             attrs(src_var))
    Dataset(data_vars=data, coords=coords).to_netcdf(dst)


def main(argv=None) -> int:
    from .. import params as P

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", required=True, choices=("T47", "T63"))
    ap.add_argument("src")
    ap.add_argument("dst")
    a = ap.parse_args(argv)
    params = {"T47": P.T47L8, "T63": P.T63L8}[a.preset]
    write_bc(a.src, a.dst, params)
    t = profiling.span_totals()
    print(f"{a.dst}: {t['remap_fields']} fields remapped to "
          f"{params.ix} x {params.il}, {t['remap_filled_points']} source "
          f"points filled")
    return 0


if __name__ == "__main__":
    sys.exit(main())
