"""Spectral transform engine: spherical-harmonic <-> grid transforms and
spectral-space operators on real-pair tensors, batched over arbitrary
leading axes.

Behavioral contract from the reference transform stack
(``speedy.f90/legendre.f90``, ``fourier.f90``, ``spectral.f90``):

* The per-(m,n) Fortran dot-product loops become contractions against a
  precomputed Legendre operator of shape (il, mx, nx), or one flat matrix
  product against its dense block-diagonal form.
* The FFTPACK real FFT along longitude becomes ``torch.fft.rfft/irfft`` (the
  coefficient convention matches FFTPACK's (cos, -sin) packing), with a
  DFT-by-matmul path that turns the whole transform into a chain of plain
  matrix products.
* All meridional couplings (gradient, vor/div <-> u,v) are n+-1 shifts with
  precomputed coefficient tables: pointwise work.

Conventions (mirroring the reference):
* grid fields: (..., il, ix), latitude index 0 = southernmost;
* spectral fields: real pairs with a size-2 axis (0: real part, 1: imaginary
  part) in front of the field axes, trailing (mx, nx); m = zonal wavenumber
  index, l = m + n = total wavenumber; only l <= trunc+1 entries participate.
  Every operator takes ``pdim``, the position of the pair axis: 0 for an
  unbatched field, 1 when a member axis leads.
* A constant field c has spec[0, 0] = sqrt(2) * c.

Three transform routes, chosen when the tables are built:

* the **kernel route** (``use_fused_kernels``: the DFT as a matrix product,
  i.e. ``fft_mode`` "matmul", or "auto" on a CUDA device, at a shape the
  hand-written fused kernels are built for: T30, T47, T63).
  ``grid2spec_p`` / ``spec2grid_p`` and their grouped forms
  ``grid2spec_many_p`` / ``spec2grid_many_p`` (one launch for a group of up
  to 16 fields) hand it to ``ops.transform_kernels``: a CUDA tensor launches
  the fused kernel (``csrc/fused_transform.cu`` at T30,
  ``csrc/fused_transform_hires.cu`` at T47 and T63) or the call raises; a
  CPU tensor takes the kernel's plain version. At T30 (the **dense route**,
  ``use_dense_legendre``) that is the chain of four ``torch.matmul``
  against the DFT matrices and the ``leg_*_dense`` tables; at T47 and T63,
  whose dense tables would be too large, the einsum chain below, so a CPU
  result there is the einsum route's. A CUDA tensor never reaches either
  chain through these functions.
* the **fft route** (``fft_mode="fft"``, and "auto" on the CPU):
  ``torch.fft`` and a Legendre einsum, on either device.
* the **einsum route** (matmul DFT at any other truncation): two einsums,
  on either device. The JAX package's size gate sends T47 and T63 there;
  another truncation that would pass that gate takes this route here, since
  the kernels are built for three shapes only.

A fourth, the **band route**, serves a latitude band of a space-sharded mesh
(``parallel/shard_transforms.py``): a transform whose ``band`` is set holds
its band's rows of the Legendre and 1/cos tables and is never on the kernel
route; ``grid2spec_many_p`` / ``spec2grid_many_p`` hand it to the band object,
which takes each field through the fft or einsum route on its rows and, for a
direct group, sums the partial Legendre sums of the bands with one
``all_reduce``.

The fft and einsum routes are routes of their own, not plain versions of the
kernels; their products go to ``torch.fft`` / ``torch.einsum`` as the JAX
package left them to XLA. A bfloat16 grid (the ``bf16_tendencies``
configuration) takes the 2-byte operand mode on the dense route and is
widened to the tables' type on the others (on the CPU), as in the JAX
package; the T47/T63 kernels refuse it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import constants as pc
from ..params import ModelParams
from . import transform_kernels as TK
from .geometry import Geometry

__all__ = [
    "SpectralTransform", "build_spectral", "gaussian_nodes_and_weights",
    "grid2spec_p", "spec2grid_p", "grid2spec_many_p", "spec2grid_many_p",
    "gradient_p", "vel2vort_p", "vort2vel_p",
    "grid_vel2vort_p", "pair", "unpair", "grid2spec", "spec2grid", "gradient",
    "vel2vort", "vort2vel", "grid_vel2vort",
    "truncate", "grid_filter", "laplacian", "laplacian_inv",
]

# The Fortran reference truncates the near-exact-underflow polynomial values
# (legendre.f90:297-302).
_POLY_FLOOR = 1.0e-30


def gaussian_nodes_and_weights(iy: int) -> tuple[np.ndarray, np.ndarray]:
    """Newton-converged Gaussian quadrature nodes and weights on the iy
    per-hemisphere points, replicating legendre.f90:224-257 (including its
    10-digit pi literal). Returns (z, w) with z > 0 descending from the pole."""
    n = 2 * iy
    eps = np.finfo(np.float64).eps  # epsilon(1.0_p)
    zs = np.empty(iy)
    w = np.empty(iy)
    z1 = 2.0
    for i in range(1, iy + 1):
        z = np.cos(3.141592654 * (i - 0.25) / (n + 0.5))
        pp = 0.0
        while abs(z - z1) > eps:
            p1, p2 = 1.0, 0.0
            for jj in range(1, n + 1):
                p3 = p2
                p2 = p1
                p1 = ((2.0 * jj - 1.0) * z * p2 - (jj - 1.0) * p3) / jj
            pp = n * (z * p1 - p2) / (z**2 - 1.0)
            z1 = z
            z = z1 - p1 / pp
        zs[i - 1] = z
        w[i - 1] = 2.0 / ((1.0 - z**2) * pp**2)
    return zs, w


def gaussian_weights(iy: int) -> np.ndarray:
    return gaussian_nodes_and_weights(iy)[1]


def _epsi_tables(mx: int, nx: int) -> tuple[np.ndarray, np.ndarray]:
    """Recursion coefficients eps(l,m)=sqrt((l^2-m^2)/(4 l^2-1)) on the
    (mx+1, nx+1) index grid (legendre.f90:79-95)."""
    m0 = np.arange(mx + 1)[:, None].astype(np.float64)
    n0 = np.arange(nx + 1)[None, :].astype(np.float64)
    ell2 = (m0 + n0) ** 2
    emm2 = m0**2
    with np.errstate(invalid="ignore", divide="ignore"):
        epsi = np.sqrt((ell2 - emm2) / (4.0 * ell2 - 1.0))
    epsi[0, 0] = 0.0
    epsi[:, nx] = 0.0
    repsi = np.where(epsi > 0.0, 1.0 / np.where(epsi > 0.0, epsi, 1.0), 0.0)
    return epsi, repsi


def _legendre_polys_at(x: float, y: float, mx: int, nx: int,
                       epsi: np.ndarray, repsi: np.ndarray) -> np.ndarray:
    """Associated Legendre polynomials at one latitude via the reference's
    diagonal-then-meridional recurrence (legendre.f90:260-307)."""
    alp = np.zeros((mx + 1, nx))
    m = np.arange(1, mx + 1, dtype=np.float64)
    consq = np.sqrt(0.5 * (2.0 * m + 1.0) / m)

    alp[0, 0] = np.sqrt(0.5)
    for i in range(1, mx + 1):
        alp[i, 0] = consq[i - 1] * y * alp[i - 1, 0]
    alp[:, 1] = x * alp[:, 0] * repsi[:, 1]
    for n in range(2, nx):
        alp[:, n] = (x * alp[:, n - 1] - epsi[:, n - 1] * alp[:, n - 2]) * repsi[:, n]

    alp[np.abs(alp) <= _POLY_FLOOR] = 0.0
    return alp[:mx, :]


class SpectralTransform(NamedTuple):
    """Precomputed transform operators and spectral coefficient tables, as
    tensors on one device in the model dtype."""

    # Legendre operators, nsh2-masked, split by meridional parity:
    cpol_even: torch.Tensor   # (iy, mx, nx) zero where n odd
    cpol_odd: torch.Tensor    # (iy, mx, nx) zero where n even
    wt: torch.Tensor          # (iy,) Gaussian weights
    # Latitude scalings
    cosgr: torch.Tensor       # (il,) 1/cos(lat)
    cosgr2: torch.Tensor      # (il,) 1/cos^2(lat)
    # Spectral operator tables (mx, nx) unless noted
    el2: torch.Tensor         # l(l+1)/a^2 Laplacian eigenvalues
    el4: torch.Tensor
    elm2: torch.Tensor        # 1/el2 (0 at l=0)
    trfilt: torch.Tensor      # 1 where l <= trunc else 0
    gradx: torch.Tensor       # (mx,) m/a
    gradym: torch.Tensor
    gradyp: torch.Tensor
    uvdx: torch.Tensor
    uvdym: torch.Tensor
    uvdyp: torch.Tensor
    vddym: torch.Tensor
    vddyp: torch.Tensor
    # Zonal DFT as matmul:
    dft_fwd_re: torch.Tensor  # (ix, mx) cos(2 pi m i / ix) / ix
    dft_fwd_im: torch.Tensor  # (ix, mx) -sin(2 pi m i / ix) / ix
    dft_inv_re: torch.Tensor  # (mx, ix) (2-delta_m0) cos(2 pi m i / ix)
    dft_inv_im: torch.Tensor  # (mx, ix) -(2-delta_m0) sin(2 pi m i / ix)
    # Full-sphere Legendre operators with the hemispheric parity fold (and,
    # for the direct one, the Gaussian weights) baked in:
    cpol_inv_full: torch.Tensor  # (il, mx, nx)
    cpol_dir_full: torch.Tensor  # (il, mx, nx)
    # Real-pair DFT operators: c indexes (cos, sin) parts. Note
    # dft_inv_ri[1, 0, :] == 0 (sin(0)), which is exactly the reference's
    # "discard the m=0 imaginary part" rule (fourier.f90:72-76) fused into
    # the operator.
    dft_fwd_ri: torch.Tensor  # (2, ix, mx)
    dft_inv_ri: torch.Tensor  # (2, mx, ix)
    # Dense block-diagonal Legendre operators: flattening (j,m)->(m,n) into
    # ONE dense matrix (zeros off the m-diagonal) turns the whole Legendre
    # stage into a plain (..., il*mx) @ (il*mx, mx*nx) product with no batch
    # dimension. The mx-fold redundancy in operations buys one large GEMM.
    # They serve the plain matmul chain of the dense route only (CPU tensors,
    # and the kernels' yardstick on the card).
    leg_dir_dense: torch.Tensor  # (il*mx, mx*nx) or (1,1) placeholder
    leg_inv_dense: torch.Tensor  # (mx*nx, il*mx) or (1,1) placeholder
    # The direct DFT tables rounded to bfloat16 for the 2-byte operand mode
    # (that mode's plain chain rounds leg_dir_dense where it is called).
    dft_fwd_ri_bf16: torch.Tensor     # (2, ix, mx) bfloat16
    # What the fused kernels read, in the order of their shared memory (see
    # _fold_tables): the folded DFT and Legendre tables of the direct
    # transform (fold_dir; fold_dir_bf16 holds the bfloat16 roundings of the
    # same values, as float32) and of the inverse one (fold_inv). (1,)
    # placeholders off the kernel route.
    fold_dir: torch.Tensor
    fold_dir_bf16: torch.Tensor
    fold_inv: torch.Tensor
    use_matmul_fft: bool = False
    # The dense tables and the 2-byte operand mode: T30 only.
    use_dense_legendre: bool = False
    # The fused kernels serve this shape (T30, T47, T63 with the matmul DFT).
    use_fused_kernels: bool = False
    # A latitude band of a space-sharded mesh
    # (parallel/shard_transforms.py::LatitudeBand), or None for the full
    # sphere. A band transform holds its band's rows of cpol_inv_full,
    # cpol_dir_full, cosgr and cosgr2, is never on the dense route, and routes
    # its transforms through the band object.
    band: Any = None

    @property
    def iy(self):
        return self.cpol_even.shape[0]

    @property
    def mx(self):
        return self.cpol_even.shape[1]

    @property
    def nx(self):
        return self.cpol_even.shape[2]

    @property
    def il(self):
        return self.cosgr.shape[0]

    @property
    def ix(self):
        return self.dft_fwd_re.shape[0]

    @property
    def rdtype(self):
        return self.wt.dtype

    @property
    def device(self):
        return self.wt.device


def _fold_tables(dft_fwd, leg_dir, dft_inv, leg_inv):
    """The fused kernels' tables, flat, in the order of their shared memory.

    The transforms are folded by the structure of their tables: the Legendre
    operators have hemispheric parity, L[il-1-j, m, n] = (-1)^n L[j, m, n],
    and vanish where m + n > nx - 1, so only the northern latitudes and the
    triangle of (m, n) pairs are kept, row p = (m, n) in m-major order; the
    DFT tables have half-period symmetry, D[i + ix/2] = (-1)^m D[i], so only
    the first half of the longitudes is kept, with the wavenumbers split by
    parity into columns c * h + q for m = 2q + parity (h = ceil(mx/2); zero
    where m >= mx).
    direct:  (2 parity, ix/2, 2h) DFT, then (il/2, triangle) Legendre;
    inverse: (il/2, triangle) Legendre, then (2 parity, 2h, ix/2) DFT."""
    _, ix, mx = dft_fwd.shape
    il, _, nx = leg_dir.shape
    ih, iy, h = ix // 2, il // 2, (mx + 1) // 2
    tri_m, tri_n = np.array([(m, n) for m in range(mx)
                             for n in range(nx - m)]).T
    d_fwd = np.zeros((2, ih, 2 * h))
    d_inv = np.zeros((2, 2 * h, ih))
    for par in range(2):
        ms = np.arange(par, mx, 2)
        for c in range(2):
            d_fwd[par, :, c * h:c * h + len(ms)] = dft_fwd[c][:ih, ms]
            d_inv[par, c * h:c * h + len(ms)] = dft_inv[c][ms, :ih]
    return (np.concatenate([d_fwd.ravel(), leg_dir[:iy, tri_m, tri_n].ravel()]),
            np.concatenate([leg_inv[:iy, tri_m, tri_n].ravel(), d_inv.ravel()]))


def build_spectral(params: ModelParams, geom: Geometry,
                   use_matmul_fft: bool = False,
                   device="cuda") -> SpectralTransform:
    """Build all transform tables (numpy f64, rounded to the configured
    dtype, placed on `device`).

    use_matmul_fft selects a dense-DFT zonal transform (one (ix, mx) product
    per part and direction) instead of torch.fft."""
    mx, nx, iy, trunc = params.mx, params.nx, params.iy, params.trunc

    epsi, repsi = _epsi_tables(mx, nx)
    wt = gaussian_weights(iy)

    # cpol at the (f32-rounded) geometry nodes, masked to the transform
    # triangle nsh2 (legendre.f90:68-77): l <= trunc+1 when ix == 4*iy.
    cpol = np.zeros((iy, mx, nx))
    for j in range(iy):
        cpol[j] = _legendre_polys_at(geom.sia_half[j], geom.coa_half[j],
                                     mx, nx, epsi, repsi)

    m0 = np.arange(mx)[:, None]
    n0 = np.arange(nx)[None, :]
    ell = (m0 + n0).astype(np.float64)
    if params.ix == 4 * params.iy:
        nsh2_mask = (m0 + n0 <= trunc + 1).astype(np.float64)
    else:
        nsh2_mask = np.ones((mx, nx))
    cpol = cpol * nsh2_mask[None, :, :]

    parity_even = ((n0 % 2) == 0).astype(np.float64)  # n'-m' = n even
    cpol_even = cpol * parity_even[None, :, :]
    cpol_odd = cpol * (1.0 - parity_even)[None, :, :]

    # Operator tables (spectral.f90:72-112)
    el2 = ell * (ell + 1.0) / pc.REARTH**2
    el4 = el2**2
    elm2 = np.zeros_like(el2)
    elm2[el2 > 0] = 1.0 / el2[el2 > 0]
    trfilt = (ell <= trunc).astype(np.float64)

    gradx = np.arange(mx, dtype=np.float64) / pc.REARTH

    # eps(l, m) lookups: epsi0[m0, n0] has l = m0+n0; the tables use the
    # "next-l" entries epsi0[m0, n0] (for the n-1 coupling) and
    # epsi0[m0, n0+1] (for the n+1 coupling).
    eps_m = epsi[:mx, :nx]        # eps at (m0, n0):   l = m0+n0
    eps_p = epsi[:mx, 1:nx + 1]   # eps at (m0, n0+1): l = m0+n0+1

    with np.errstate(divide="ignore", invalid="ignore"):
        uvdx = np.where(
            n0 == 0,
            -pc.REARTH / (m0 + 1.0),
            -pc.REARTH * m0 / np.where(n0 == 0, 1.0, ell * (ell + 1.0)),
        )
        gradym = np.where(n0 == 0, 0.0, (ell - 1.0) * eps_m / pc.REARTH)
        uvdym = np.where(n0 == 0, 0.0, -pc.REARTH * eps_m / np.where(ell == 0, 1.0, ell))
        vddym = np.where(n0 == 0, 0.0, (ell + 1.0) * eps_m / pc.REARTH)
    gradyp = (ell + 2.0) * eps_p / pc.REARTH
    uvdyp = -pc.REARTH * eps_p / (ell + 1.0)
    vddyp = ell * eps_p / pc.REARTH

    # Zonal DFT matrices
    ix = params.ix
    theta = 2.0 * np.pi * np.outer(np.arange(ix), np.arange(mx)) / ix
    dft_fwd_re = np.cos(theta) / ix
    dft_fwd_im = -np.sin(theta) / ix
    dup = np.where(np.arange(mx) == 0, 1.0, 2.0)
    dft_inv_re = (dup[:, None] * np.cos(theta).T)
    dft_inv_im = (-dup[:, None] * np.sin(theta).T)

    # Full-sphere fold operators (south rows: even-odd; north rows: flipped
    # even+odd; direct variant with quadrature weights folded in)
    cpol_inv_full = np.concatenate(
        [cpol_even - cpol_odd, (cpol_even + cpol_odd)[::-1]], axis=0)
    wt3 = wt[:, None, None]
    cpol_dir_full = np.concatenate(
        [(cpol_even - cpol_odd) * wt3,
         ((cpol_even + cpol_odd) * wt3)[::-1]], axis=0)

    # The fused kernels' folded tables at the shapes they are built for;
    # the dense block-diagonal Legendre matrices (see SpectralTransform
    # docstring), their CPU plain version and the 2-byte mode's, at T30
    # alone (at T63 they would be 6,144 x 4,160 entries; the JAX package's
    # size gate, il*mx*mx*nx <= 4e6 entries per operator, keeps T47/T63 on
    # its einsums too). Every other truncation takes the einsum form (one
    # that passes the JAX gate takes the dense one there: the same
    # transform).
    il = 2 * iy
    use_kernels = use_matmul_fft and (il, ix, mx, nx) in TK.KERNEL_SHAPES
    use_dense = use_matmul_fft and (il, ix, mx, nx) == TK.T30_SHAPE
    if use_dense:
        idx = np.arange(mx)
        Dd = np.zeros((il, mx, mx, nx))
        Dd[:, idx, idx, :] = cpol_dir_full
        leg_dir_dense = Dd.reshape(il * mx, mx * nx)
        Ed = np.zeros((mx, nx, il, mx))
        Ed[idx, :, :, idx] = cpol_inv_full.transpose(1, 2, 0)
        leg_inv_dense = Ed.reshape(mx * nx, il * mx)
    else:
        leg_dir_dense = np.zeros((1, 1))
        leg_inv_dense = np.zeros((1, 1))
    if use_kernels:
        fold_dir, fold_inv = _fold_tables(
            np.stack([dft_fwd_re, dft_fwd_im]), cpol_dir_full,
            np.stack([dft_inv_re, dft_inv_im]), cpol_inv_full)
    else:
        fold_dir = fold_inv = np.zeros((1,))

    a = lambda x: torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, dtype=params.np_dtype))).to(device)
    # Rounded to bfloat16 from the float32 value, as a cast of the float32
    # table would.
    bf = lambda x: torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, dtype=np.float32))).to(device).to(torch.bfloat16)
    return SpectralTransform(
        cpol_even=a(cpol_even), cpol_odd=a(cpol_odd), wt=a(wt),
        cosgr=a(geom.cosgr), cosgr2=a(geom.cosgr2),
        el2=a(el2), el4=a(el4), elm2=a(elm2), trfilt=a(trfilt),
        gradx=a(gradx), gradym=a(gradym), gradyp=a(gradyp),
        uvdx=a(uvdx), uvdym=a(uvdym), uvdyp=a(uvdyp),
        vddym=a(vddym), vddyp=a(vddyp),
        dft_fwd_re=a(dft_fwd_re), dft_fwd_im=a(dft_fwd_im),
        dft_inv_re=a(dft_inv_re), dft_inv_im=a(dft_inv_im),
        cpol_inv_full=a(cpol_inv_full), cpol_dir_full=a(cpol_dir_full),
        dft_fwd_ri=a(np.stack([dft_fwd_re, dft_fwd_im])),
        dft_inv_ri=a(np.stack([dft_inv_re, dft_inv_im])),
        leg_dir_dense=a(leg_dir_dense), leg_inv_dense=a(leg_inv_dense),
        dft_fwd_ri_bf16=bf(np.stack([dft_fwd_re, dft_fwd_im])),
        fold_dir=a(fold_dir), fold_dir_bf16=bf(fold_dir).float(),
        fold_inv=a(fold_inv),
        use_matmul_fft=use_matmul_fft,
        use_dense_legendre=use_dense,
        use_fused_kernels=use_kernels,
    )


# ---------------------------------------------------------------------------
# Transforms on real pairs
# ---------------------------------------------------------------------------
# Spectral fields are REAL tensors with a size-2 axis c (c=0: real part, c=1:
# imaginary part): vor is (2, kx, mx, nx), or (B, 2, kx, mx, nx) with a
# member axis in front. Every spectral-space operator in the model is linear
# with real coefficients except multiplication by i*m (the zonal derivative),
# which is a plane swap with a sign, so the whole spectral side runs in real
# arithmetic. All right-aligned (mx, nx)-table broadcasts work unchanged on
# pairs, wherever the pair axis sits.


def grid2spec_p(sp: SpectralTransform, grid: torch.Tensor,
                pdim: int = 0) -> torch.Tensor:
    """Grid (..., il, ix) -> spectral pair (spectral.f90:263-273), the pair
    axis inserted at `pdim` of the result: (2, ..., mx, nx) for pdim=0,
    (B, 2, ..., mx, nx) for pdim=1. A group of one (see grid2spec_many_p): on
    the kernel route a CUDA tensor goes through the fused kernel and a CPU
    tensor through its plain chain (see the module docstring); a bfloat16
    grid takes the 2-byte operand mode on the dense route and is widened on
    the other routes."""
    return grid2spec_many_p(sp, [grid], pdim)[0]


def spec2grid_p(sp: SpectralTransform, p: torch.Tensor, kcos: int = 1,
                pdim: int = 0) -> torch.Tensor:
    """Spectral pair -> grid (..., il, ix) (spectral.f90:251-261); `pdim` is
    the position of the pair axis in `p`. kcos=1: raw field; otherwise the
    output is scaled by 1/cos(lat). A group of one (see spec2grid_many_p).

    The reference's "discard the m=0 imaginary part" rule (fourier.f90:72-76)
    is inherent in dft_inv_ri[1, 0, :] == 0 on the matmul paths and explicit
    on the fft path. On the kernel route a CUDA tensor goes through the fused
    kernel (the 1/cos scaling folded into its store) and a CPU tensor through
    its plain chain."""
    return spec2grid_many_p(sp, [p], [kcos], pdim)[0]


def grid2spec_many_p(sp: SpectralTransform, grids, pdim: int = 0) -> list:
    """grid2spec_p of each field of a list, the same values as one call per
    field. On the kernel route the fields go to the fused kernel in groups of
    up to TK.MAX_SEGMENTS, one launch per group and element type on the card
    (the plain chain, field by field, on the CPU); on the other routes one
    field at a time."""
    grids = list(grids)
    if sp.band is not None:
        return sp.band.grid2spec_many_p(sp, grids, pdim)
    if not sp.use_fused_kernels:
        return [_grid2spec_routes(sp, g, pdim) for g in grids]
    n = TK.MAX_SEGMENTS
    return [out for i in range(0, len(grids), n)
            for out in TK.fused_grid2spec_many(sp, grids[i:i + n], pdim)]


def spec2grid_many_p(sp: SpectralTransform, pairs, kcos=1,
                     pdim: int = 0) -> list:
    """spec2grid_p of each spectral pair of a list, `kcos` one value or one
    per field; the same values as one call per field. On the kernel route
    the fields go to the fused kernel in groups of up to TK.MAX_SEGMENTS
    (each field with its own 1/cos(lat) flag); on the other routes one field
    at a time."""
    pairs = list(pairs)
    kcos = TK.kcos_list(kcos, len(pairs))
    if sp.band is not None:
        return sp.band.spec2grid_many_p(sp, pairs, kcos, pdim)
    if not sp.use_fused_kernels:
        return [_spec2grid_routes(sp, p, k, pdim) for p, k in zip(pairs, kcos)]
    n = TK.MAX_SEGMENTS
    return [out for i in range(0, len(pairs), n)
            for out in TK.fused_spec2grid_many(sp, pairs[i:i + n],
                                               kcos[i:i + n], pdim)]


def _grid2spec_routes(sp: SpectralTransform, grid: torch.Tensor,
                      pdim: int) -> torch.Tensor:
    """grid2spec_p on the fft and einsum routes."""
    if grid.dtype == torch.bfloat16:
        grid = grid.to(sp.rdtype)
    if not sp.use_matmul_fft:
        # numpy's/torch's rfft convention (C - iS packing) coincides with
        # FFTPACK's rfftf; 1/ix normalized (fourier.f90:96-123).
        F = torch.fft.rfft(grid, dim=-1)[..., : sp.mx] / grid.shape[-1]
        F2 = torch.view_as_real(F).movedim(-1, pdim)      # pair axis at pdim
        return torch.einsum("jmn,...jm->...mn", sp.cpol_dir_full, F2)
    return TK.einsum_grid2spec(sp, grid, pdim)


def _spec2grid_routes(sp: SpectralTransform, p: torch.Tensor, kcos: int,
                      pdim: int) -> torch.Tensor:
    """spec2grid_p on the fft and einsum routes."""
    if sp.use_matmul_fft:
        return TK.einsum_spec2grid(sp, p, kcos, pdim)
    ix = 2 * sp.il  # ix == 2*il for the supported grids (96 = 2*48)
    F2 = torch.einsum("jmn,...mn->...jm", sp.cpol_inv_full, p)
    Fr = F2.movedim(pdim, -1).contiguous()            # (..., il, mx, 2)
    Fr[..., 0, 1] = 0.0     # fresh tensor: written in place
    F = torch.view_as_complex(Fr)
    Fp = torch.nn.functional.pad(F, (0, ix // 2 + 1 - sp.mx))
    g = torch.fft.irfft(Fp, n=ix, dim=-1) * ix
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return g


# ---------------------------------------------------------------------------
# Spectral-space operators
# ---------------------------------------------------------------------------

def _imul_p(coef, p: torch.Tensor, pdim: int) -> torch.Tensor:
    """(i * coef) * p for a real broadcastable coef: (re, im) -> (-c*im, c*re)."""
    re, im = p.unbind(pdim)
    return torch.stack([-coef * im, coef * re], dim=pdim)


def _shift_dn(x: torch.Tensor) -> torch.Tensor:
    """x[..., n] -> x[..., n-1] with zero inflow (n axis last)."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """x[..., n] -> x[..., n+1] with zero inflow."""
    return torch.nn.functional.pad(x[..., 1:], (0, 1))


def _no_zonal_last_row(z: torch.Tensor) -> torch.Tensor:
    """The reference omits the zonal-derivative term on the last n row
    (spectral.f90:174-177, 201-205). `z` is always a fresh tensor here, so
    the row is zeroed in place, on the device (a CUDA graph of the step
    records it)."""
    z[..., -1].fill_(0.0)
    return z


def gradient_p(sp: SpectralTransform, psi: torch.Tensor, pdim: int = 0):
    """Spectral zonal/meridional gradient of a real pair
    (spectral.f90:275-296). Returns (psdx, psdy); the grid-space x-derivative
    requires a later 1/cos(lat) scaling."""
    psdx = _imul_p(sp.gradx[:, None], psi, pdim)
    psdy = -sp.gradym * _shift_dn(psi) + sp.gradyp * _shift_up(psi)
    return psdx, psdy


def vel2vort_p(sp: SpectralTransform, ucosm: torch.Tensor,
               vcosm: torch.Tensor, pdim: int = 0):
    """Spectral (U, V)=(u,v)*cos(lat) -> (vor, div) on real pairs
    (spectral.f90:160-186)."""
    zp = _no_zonal_last_row(_imul_p(sp.gradx[:, None], ucosm, pdim))
    zc = _no_zonal_last_row(_imul_p(sp.gradx[:, None], vcosm, pdim))
    vorm = sp.vddym * _shift_dn(ucosm) - sp.vddyp * _shift_up(ucosm) + zc
    divm = -sp.vddym * _shift_dn(vcosm) + sp.vddyp * _shift_up(vcosm) + zp
    return vorm, divm


def vort2vel_p(sp: SpectralTransform, vorm: torch.Tensor,
               divm: torch.Tensor, pdim: int = 0):
    """Spectral (vor, div) -> (U, V)=(u,v)*cos(lat) on real pairs
    (spectral.f90:190-214)."""
    zp = _no_zonal_last_row(_imul_p(sp.uvdx, vorm, pdim))
    zc = _no_zonal_last_row(_imul_p(sp.uvdx, divm, pdim))
    ucosm = sp.uvdym * _shift_dn(vorm) - sp.uvdyp * _shift_up(vorm) + zc
    vcosm = -sp.uvdym * _shift_dn(divm) + sp.uvdyp * _shift_up(divm) + zp
    return ucosm, vcosm


def grid_vel2vort_p(sp: SpectralTransform, ug: torch.Tensor,
                    vg: torch.Tensor, kcos: int = 2, pdim: int = 0):
    """Grid (u, v) -> spectral (vor, div) on real pairs (spectral.f90:218-248).
    kcos=2 scales the input by 1/cos(lat), otherwise by 1/cos^2(lat)."""
    scale = (sp.cosgr if kcos == 2 else sp.cosgr2)[:, None]
    specu = grid2spec_p(sp, ug * scale, pdim)
    specv = grid2spec_p(sp, vg * scale, pdim)
    return vel2vort_p(sp, specu, specv, pdim)


# ---------------------------------------------------------------------------
# The complex-dtype API: the same operators on complex (..., mx, nx) tensors.
# Every function converts at its boundary and runs the real-pair code, so the
# transforms take the same routes (and the same kernels) as above.
# ---------------------------------------------------------------------------

def pair(spec: torch.Tensor) -> torch.Tensor:
    """Complex (..., mx, nx) -> real pair (2, ..., mx, nx)."""
    return torch.stack([spec.real, spec.imag])


def unpair(p: torch.Tensor) -> torch.Tensor:
    """Real pair (2, ..., mx, nx) -> complex (..., mx, nx)."""
    return torch.complex(p[0], p[1])


def grid2spec(sp: SpectralTransform, grid: torch.Tensor) -> torch.Tensor:
    """Grid (..., il, ix) -> complex spectral (..., mx, nx)
    (spectral.f90:263-273)."""
    return unpair(grid2spec_p(sp, grid))


def spec2grid(sp: SpectralTransform, spec: torch.Tensor,
              kcos: int = 1) -> torch.Tensor:
    """Complex spectral (..., mx, nx) -> grid (..., il, ix)
    (spectral.f90:251-261)."""
    return spec2grid_p(sp, pair(spec), kcos)


def _on_pairs(fn, sp, *specs):
    return tuple(unpair(x) for x in fn(sp, *(pair(s) for s in specs)))


def gradient(sp: SpectralTransform, psi: torch.Tensor):
    """Spectral zonal/meridional gradient (spectral.f90:275-296)."""
    return _on_pairs(gradient_p, sp, psi)


def vel2vort(sp: SpectralTransform, ucosm: torch.Tensor, vcosm: torch.Tensor):
    """Spectral (U, V)=(u,v)*cos(lat) -> (vor, div) (spectral.f90:160-186)."""
    return _on_pairs(vel2vort_p, sp, ucosm, vcosm)


def vort2vel(sp: SpectralTransform, vorm: torch.Tensor, divm: torch.Tensor):
    """Spectral (vor, div) -> (U, V)=(u,v)*cos(lat) (spectral.f90:190-214)."""
    return _on_pairs(vort2vel_p, sp, vorm, divm)


def grid_vel2vort(sp: SpectralTransform, ug: torch.Tensor, vg: torch.Tensor,
                  kcos: int = 2):
    """Grid (u, v) -> complex spectral (vor, div) (spectral.f90:218-248)."""
    return tuple(unpair(x) for x in grid_vel2vort_p(sp, ug, vg, kcos))


def truncate(sp: SpectralTransform, spec: torch.Tensor) -> torch.Tensor:
    """Triangular truncation to l <= trunc (spectral.f90:134-138)."""
    return spec * sp.trfilt


def laplacian(sp: SpectralTransform, spec: torch.Tensor) -> torch.Tensor:
    return -spec * sp.el2


def laplacian_inv(sp: SpectralTransform, spec: torch.Tensor) -> torch.Tensor:
    return -spec * sp.elm2


def grid_filter(sp: SpectralTransform, fg: torch.Tensor) -> torch.Tensor:
    """Spectrally truncate a grid-point field (spectral.f90:299-317)."""
    return spec2grid_p(sp, truncate(sp, grid2spec_p(sp, fg)), 1)
