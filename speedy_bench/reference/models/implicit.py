"""Semi-implicit gravity-wave solver and horizontal-diffusion coefficient
tables.

Behavioral contract from ``speedy.f90/implicit.f90`` and
``horizontal_diffusion.f90``. The per-total-wavenumber kx-by-kx LU solves of
the reference (implicit.f90:194-207, matrix_inversion.f90) are precomputed
when the time step is set, with a batched ``np.linalg.inv``, and gathered
into a dense (mx, nx, kx, kx) operator so the per-step correction is one
batched contraction instead of 62 small solves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as pc
from ..ops.geometry import Geometry
from ..params import ModelParams

__all__ = ["HorDiffusion", "build_hordif", "ImplicitTables", "build_implicit",
           "implicit_terms"]


def _to_device(params: ModelParams, device):
    """numpy (f64) -> tensor in the model dtype on `device`."""
    return lambda x: torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, dtype=params.np_dtype))).to(device)


def _host_copy(params: ModelParams, *tables) -> np.ndarray:
    """numpy (f64) tables rounded to the model dtype and concatenated flat as
    float64: the values the device tables hold, for a kernel's argument
    struct."""
    return np.concatenate([np.asarray(t, dtype=params.np_dtype).astype(
        np.float64).ravel() for t in tables])


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


class HorDiffusion(NamedTuple):
    """Explicit damping coefficients + orographic correction profiles
    (horizontal_diffusion.f90:77-107). The implicit factors dmp1* depend on dt
    and live in ImplicitTables."""

    dmp: torch.Tensor    # (mx, nx) del^8 damping for T and vorticity
    dmpd: torch.Tensor   # (mx, nx) del^8 damping for divergence
    dmps: torch.Tensor   # (mx, nx) del^2 stratospheric damping
    tcorv: torch.Tensor  # (kx,) vertical orographic T-correction profile
    qcorv: torch.Tensor  # (kx,) vertical orographic q-correction profile
    # tcorv and qcorv once more on the host, float64 holding the model-dtype
    # values: the spectral-update kernel takes them in its argument struct.
    levels_host: np.ndarray  # (2*kx,)


def build_hordif(params: ModelParams, geom: Geometry,
                 device="cuda") -> HorDiffusion:
    mx, nx, kx, trunc = params.mx, params.nx, params.kx, params.trunc
    npowhd = 4

    hdiff = 1.0 / (params.thd * 3600.0)
    hdifd = 1.0 / (params.thdd * 3600.0)
    hdifs = 1.0 / (params.thds * 3600.0)
    rlap = 1.0 / float(trunc * (trunc + 1))

    m0 = np.arange(mx)[:, None]
    n0 = np.arange(nx)[None, :]
    twn = (m0 + n0).astype(np.float64)
    elap = twn * (twn + 1.0) * rlap
    elapn = elap**npowhd

    tcorv = np.zeros(kx)
    qcorv = np.zeros(kx)
    rgam = pc.RGAS * pc.GAMMA / (1000.0 * pc.GRAV)
    qexp = pc.HSCALE / pc.HSHUM
    tcorv[1:] = geom.fsg[1:] ** rgam
    qcorv[2:] = geom.fsg[2:] ** qexp

    a = _to_device(params, device)
    return HorDiffusion(dmp=a(hdiff * elapn), dmpd=a(hdifd * elapn),
                        dmps=a(hdifs * elap), tcorv=a(tcorv), qcorv=a(qcorv),
                        levels_host=_host_copy(params, tcorv, qcorv))


class ImplicitTables(NamedTuple):
    """dt-dependent tables for the implicit correction (implicit.f90:83-218).
    Rebuilt for each of the three dt values of the startup sequence."""

    dmp1: torch.Tensor   # (mx, nx) implicit del^8 factor, T/vor
    dmp1d: torch.Tensor  # (mx, nx) implicit del^8 factor, divergence
    dmp1s: torch.Tensor  # (mx, nx) implicit del^2 factor, stratosphere
    tref: torch.Tensor   # (kx,) reference temperature profile
    tref2: torch.Tensor  # (kx,) akap * tref
    tref3: torch.Tensor  # (kx,) fsgr * tref
    dhsx: torch.Tensor   # (kx,) xi * dhs
    xc: torch.Tensor     # (kx, kx) T-from-div coupling (already * xi)
    xd: torch.Tensor     # (kx, kx) hydrostatic P-from-T operator
    elz: torch.Tensor    # (mx, nx) l(l+1) * xi / a^2
    xj_mn: torch.Tensor  # (mx, nx, kx, kx) gathered inverse matrices; zero
                         # rows at l=0 so the correction vanishes there.
    # tref, tref2, dhsx, xd and xc (row by row) once more on the host,
    # float64 holding the model-dtype values: the spectral-update kernel
    # takes them in its argument struct.
    levels_host: np.ndarray  # (3*kx + 2*kx*kx,)


def _tref_profile(geom: Geometry) -> np.ndarray:
    rgam = pc.RGAS * pc.GAMMA / (1000.0 * pc.GRAV)
    return 288.0 * np.maximum(0.2, geom.fsg) ** rgam


def build_implicit(params: ModelParams, geom: Geometry, hd: HorDiffusion,
                   dt: float, device="cuda") -> ImplicitTables:
    kx, mx, nx = params.kx, params.mx, params.nx
    dhs, fsg, hsg = geom.dhs, geom.fsg, geom.hsg

    tref = _tref_profile(geom)
    tref2 = pc.AKAP * tref
    tref3 = geom.fsgr * tref

    # The damping tables are read back in the model dtype (f32-rounded on the
    # f32 path), as the JAX package does.
    dmp1 = 1.0 / (1.0 + _host64(hd.dmp) * dt)
    dmp1d = 1.0 / (1.0 + _host64(hd.dmpd) * dt)
    dmp1s = 1.0 / (1.0 + _host64(hd.dmps) * dt)

    xi = dt * params.alph
    xxi = xi / pc.REARTH**2
    dhsx = xi * dhs

    m0 = np.arange(mx)[:, None]
    n0 = np.arange(nx)[None, :]
    ell = (m0 + n0).astype(np.float64)
    elz = ell * (ell + 1.0) * xxi

    # Temperature-from-divergence vertical structure (implicit.f90:129-170)
    ya = -pc.AKAP * tref[:, None] * dhs[None, :]
    xa = np.zeros((kx, kx))
    for k in range(1, kx):
        xa[k, k - 1] = 0.5 * (pc.AKAP * tref[k] / fsg[k]
                              - (tref[k] - tref[k - 1]) / dhs[k])
    for k in range(kx - 1):
        xa[k, k] = 0.5 * (pc.AKAP * tref[k] / fsg[k]
                          - (tref[k + 1] - tref[k]) / dhs[k])

    dsum = np.cumsum(dhs)
    xb = np.zeros((kx, kx))
    for k in range(kx - 1):
        for k1 in range(kx):
            xb[k, k1] = dhs[k1] * dsum[k]
            if k1 <= k:
                xb[k, k1] -= dhs[k1]

    xc = ya + xa[:, : kx - 1] @ xb[: kx - 1, :]

    # Hydrostatic operator P(k) = xd(k,k') T(k') (implicit.f90:172-182)
    xd = np.zeros((kx, kx))
    for k in range(kx):
        for k1 in range(k + 1, kx):
            xd[k, k1] = pc.RGAS * np.log(hsg[k1 + 1] / hsg[k1])
        xd[k, k] = pc.RGAS * np.log(hsg[k + 1] / fsg[k])

    xe = xd @ xc

    # Per-total-wavenumber matrices and their inverses (implicit.f90:194-207).
    lmax = mx + nx + 1
    ll = np.arange(1, lmax + 1, dtype=np.float64)
    xxx = ll * (ll + 1.0) / pc.REARTH**2
    base = pc.RGAS * tref[:, None] * dhs[None, :] - xe  # (kx, kx)
    xf = np.eye(kx)[None] + (xi * xi * xxx)[:, None, None] * base[None]
    xj = np.linalg.inv(xf)  # (lmax, kx, kx)

    # Gather per-(m,n): l(m,n) = m0+n0; the correction is skipped at l=0
    # (implicit.f90:268-275) -> zero matrix there.
    lidx = (m0 + n0)  # value of l; table index l-1
    xj_mn = np.where((lidx > 0)[..., None, None],
                     xj[np.clip(lidx - 1, 0, lmax - 1)], 0.0)

    xc = xc * xi

    a = _to_device(params, device)
    return ImplicitTables(
        dmp1=a(dmp1), dmp1d=a(dmp1d), dmp1s=a(dmp1s),
        tref=a(tref), tref2=a(tref2), tref3=a(tref3), dhsx=a(dhsx),
        xc=a(xc), xd=a(xd), elz=a(elz), xj_mn=a(xj_mn),
        levels_host=_host_copy(params, tref, tref2, dhsx, xd, xc),
    )


def _apply_level_matrix(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Contract a level matrix with the level axis of (..., l, m, n). A is
    (k, l), or position-dependent (m, n, k, l). One einsum each: the JAX
    package unrolls the same sums into kx^2 multiply-adds, which in eager
    PyTorch would be as many launches; the results differ by rounding."""
    if A.dim() == 2:
        return torch.einsum("kl,...lmn->...kmn", A, y)
    return torch.einsum("mnkl,...lmn->...kmn", A, y)


def implicit_terms(im: ImplicitTables, divdt: torch.Tensor,
                   tdt: torch.Tensor, psdt: torch.Tensor):
    """Semi-implicit gravity-wave correction (implicit.f90:234-289).

    Tensors are (..., kx, mx, nx) for 3-D and (..., mx, nx) for psdt; the
    level axis is third-from-last so the kx-by-kx contractions batch over
    (m, n) and any leading member and pair axes. Returns corrected
    (divdt, tdt, psdt).
    """
    tref_c = im.tref[:, None, None]
    dhsx_c = im.dhsx[:, None, None]

    # ye = xd . tdt + R tref psdt
    ye = _apply_level_matrix(im.xd, tdt) \
        + pc.RGAS * tref_c * psdt[..., None, :, :]
    yf = divdt + im.elz * ye
    # divdt <- xj(l) . yf   (per-(m,n) kx x kx matvec)
    divdt = _apply_level_matrix(im.xj_mn, yf)
    psdt = psdt - torch.sum(dhsx_c * divdt, dim=-3)
    tdt = tdt + _apply_level_matrix(im.xc, divdt)
    return divdt, tdt, psdt
