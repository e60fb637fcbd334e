"""The inputs of a run, made by the benchmark and handed alike to the
program and to the reference: the boundary conditions, the SST anomaly
record, the members' perturbations and their SPPT keys."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["boundary_conditions", "perturbation", "sppt_keys",
           "spinup_sppt_key"]

HERE = Path(__file__).resolve().parent
# The fold-in word of the spin-up member's SPPT key: no chunk's index.
SPINUP = 2**32 - 1
# The NetCDF variable of each boundary field ((month,) lat, lon inside the
# model), as pySPEEDY's set_bc reads them.
NAMES = {"orog": "orog", "fmask_orig": "lsm", "alb0": "alb",
         "veg_high": "vegh", "veg_low": "vegl", "stl12": "stl",
         "snowd12": "snowd", "soil_wc_l1": "swl1", "soil_wc_l2": "swl2",
         "soil_wc_l3": "swl3", "sst12": "sst", "sea_ice_frac12": "icec"}


def _read(path: Path) -> dict:
    """{model name: float64 array in (month,) lat, lon order} of a NetCDF3
    file whose fields are (lon, lat[, month])."""
    from scipy.io import netcdf_file

    with netcdf_file(str(path), "r", mmap=False) as f:
        fields = {}
        for name, var in NAMES.items():
            data = np.asarray(f.variables[var].data, dtype=np.float64)
            fields[name] = np.moveaxis(data, (0, 1), (-1, -2)).copy()
    return fields


def boundary_conditions(config: dict, geom, months: int) -> dict:
    """The configuration's boundary fields for a grid of `geom` (the
    reference's numpy geometry), in the layouts the model's initialization
    takes, and an SST anomaly record of zeros covering `months` months with
    a pad month on each side."""
    bc = config["boundary"]
    fields = _read(HERE / bc["file"])
    il = len(geom.radang)
    ix = 2 * il
    if bc["kind"] != "file":
        raise ValueError(f"boundary kind {bc['kind']!r}")
    for k, v in fields.items():
        if v.shape[-2:] != (il, ix):
            raise ValueError(f"{k}: {v.shape} on a {il} x {ix} grid")
    fields["sst_anom"] = np.zeros((months + 2, il, ix))
    return fields


def perturbation(spec: dict, shape: tuple, generator) -> torch.Tensor:
    """A member's perturbation of the spectral field `spec["field"]`: for
    every (member, part, level, m, n) of `shape` ((B, 2, kx, mx, nx)) with
    m + n <= spec["max_wavenumber"], a normal value of standard deviation
    spec["std"] (the imaginary part of m = 0 is zero), drawn on the
    generator's device in one call."""
    B, _, kx, mx, nx = shape
    noise = torch.randn(shape, generator=generator,
                        device=generator.device, dtype=torch.float64)
    m = torch.arange(mx, device=noise.device)[:, None]
    n = torch.arange(nx, device=noise.device)[None, :]
    mask = ((m + n) <= spec["max_wavenumber"]).to(noise.dtype)
    noise = noise * mask * spec["std"]
    noise[:, 1, :, 0, :] = 0.0
    return noise


def sppt_keys(seed: int, chunk: int, members: int) -> torch.Tensor:
    """The SPPT noise keys of a chunk's members (members x 2 uint32 words in
    int64), the reference's threefry: the key of the seed folded with the
    chunk, then split over the members."""
    from .reference.physics import sppt as SP

    key = SP.fold_in(SP.key_data(seed % (1 << 32)), chunk)
    return SP.split_keys(key, members)


def spinup_sppt_key() -> torch.Tensor:
    """The SPPT key of the spin-up's one member (1 x 2), the same for every
    seed, as the spin-up is."""
    return sppt_keys(0, SPINUP, 1)
