"""Model geometry tables: sigma levels and latitude functions.

Behavioral contract from reference ``speedy.f90/geometry.f90:61-156``.  One
deliberate quirk is replicated exactly: the reference computes the Gaussian
latitude first guess with a default-real (single precision) pi literal
(geometry.f90:110), so ``sia_half`` carries float32 rounding even though the
model is float64.  The Legendre polynomials are evaluated at these approximate
nodes while the quadrature weights (ops/spectral.py) are Newton-converged —
both behaviors are reproduced for numerical parity.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import constants as pc
from ..params import ModelParams

__all__ = ["Geometry", "build_geometry"]


# Half-sigma level tables (geometry.f90:84-90).
_HSG_TABLES = {
    5: [0.000, 0.150, 0.350, 0.650, 0.900, 1.000],
    7: [0.020, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000],
    8: [0.000, 0.050, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000],
}


class Geometry(NamedTuple):
    """Precomputed geometry tables (all numpy float64; cast at use site)."""

    # Vertical
    hsg: np.ndarray      # (kx+1,) half sigma levels
    dhs: np.ndarray      # (kx,) layer thicknesses
    fsg: np.ndarray      # (kx,) full sigma levels
    dhsr: np.ndarray     # (kx,) 1/(2 dhs)
    fsgr: np.ndarray     # (kx,) akap/(2 fsg)
    sigl: np.ndarray     # (kx,) log(fsg)
    sigh: np.ndarray     # (kx+1,) half levels, sigh[0]=hsg[0]
    grdsig: np.ndarray   # (kx,) g/(dhs p0): flux -> du/dt conversion
    grdscp: np.ndarray   # (kx,) grdsig/cp: energy flux -> dT/dt
    wvi: np.ndarray      # (kx, 2) vertical interpolation weights
    # Horizontal (latitude index 0 = southernmost, matching the reference)
    radang: np.ndarray   # (il,) latitude [rad]
    coriol: np.ndarray   # (il,) Coriolis parameter
    sia: np.ndarray      # (il,) sin(lat)
    coa: np.ndarray      # (il,) cos(lat)
    sia_half: np.ndarray  # (iy,) |sin(lat)| per hemisphere (f32-rounded nodes)
    coa_half: np.ndarray  # (iy,) cos(lat) per hemisphere
    cosg: np.ndarray     # (il,) cos(lat)
    cosgr: np.ndarray    # (il,) 1/cos(lat)
    cosgr2: np.ndarray   # (il,) 1/cos^2(lat)


def build_geometry(params: ModelParams) -> Geometry:
    kx, iy, il = params.kx, params.iy, params.il

    if kx not in _HSG_TABLES:
        raise ValueError(f"No sigma-level table for kx={kx} (supported: 5, 7, 8)")
    hsg = np.asarray(_HSG_TABLES[kx], dtype=np.float64)

    dhs = hsg[1:] - hsg[:-1]
    fsg = 0.5 * (hsg[1:] + hsg[:-1])
    dhsr = 0.5 / dhs
    fsgr = pc.AKAP / (2.0 * fsg)

    if params.exact_nodes:
        from .spectral import gaussian_nodes_and_weights
        sia_half, _ = gaussian_nodes_and_weights(iy)
    else:
        # The reference's single-precision first-guess node formula
        # (geometry.f90:110: default-real pi literal -> whole expression f32).
        j = np.arange(1, iy + 1, dtype=np.float32)
        sia_half = np.cos(
            np.float32(3.141592654) * (j - np.float32(0.25))
            / (np.float32(il) + np.float32(0.5))
        ).astype(np.float64)
    coa_half = np.sqrt(1.0 - sia_half**2)

    sia = np.concatenate([-sia_half, sia_half[::-1]])
    coa = np.concatenate([coa_half, coa_half[::-1]])
    radang = np.concatenate([-np.arcsin(sia_half), np.arcsin(sia_half)[::-1]])

    cosg = coa.copy()
    cosgr = 1.0 / coa
    cosgr2 = 1.0 / coa**2

    coriol = 2.0 * pc.OMEGA * sia

    sigl = np.log(fsg)
    sigh = hsg.copy()  # sigh[k] = hsg[k] for k=0..kx (geometry.f90:134-138)
    grdsig = pc.GRAV / (dhs * pc.P0)
    grdscp = grdsig / pc.CP

    # Vertical interpolation weights (geometry.f90:147-153)
    wvi = np.zeros((kx, 2))
    for k in range(kx - 1):
        wvi[k, 0] = 1.0 / (sigl[k + 1] - sigl[k])
        wvi[k, 1] = (np.log(sigh[k + 1]) - sigl[k]) * wvi[k, 0]
    wvi[kx - 1, 0] = 0.0
    wvi[kx - 1, 1] = (np.log(0.99) - sigl[kx - 1]) * wvi[kx - 2, 0]

    return Geometry(
        hsg=hsg, dhs=dhs, fsg=fsg, dhsr=dhsr, fsgr=fsgr,
        sigl=sigl, sigh=sigh, grdsig=grdsig, grdscp=grdscp, wvi=wvi,
        radang=radang, coriol=coriol, sia=sia, coa=coa,
        sia_half=sia_half, coa_half=coa_half,
        cosg=cosg, cosgr=cosgr, cosgr2=cosgr2,
    )
