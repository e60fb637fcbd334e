"""Model configuration parameters.

Counterpart of the reference's compile-time configuration
(``speedy.f90/params.f90:18-44``). The resolution is a runtime dataclass so
several resolutions can coexist in one process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ModelParams", "T30L8", "T30L5", "T30L7", "T47L8", "T63L8"]


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Static model configuration (hashable)."""

    # Spectral truncation / grid (reference params.f90:18-29)
    trunc: int = 30          # triangular truncation total wavenumber
    ix: int = 96             # number of longitudes
    iy: int = 24             # latitudes per hemisphere
    kx: int = 8              # vertical sigma levels
    ntr: int = 1             # number of tracers (q is tracer 1)

    # Time stepping (params.f90:32-39)
    nsteps: int = 36         # steps per day
    rob: float = 0.05        # Robert filter coefficient
    wil: float = 0.53        # Williams filter parameter
    alph: float = 0.5        # semi-implicit centering parameter

    # Physics cadence (params.f90:42-44)
    iseasc: int = 1          # seasonal cycle on/off
    nstrad: int = 3          # shortwave radiation period (steps)
    sppt_on: bool = False    # stochastic physics

    # Horizontal-diffusion damping times [hours] (reference compile-time
    # constants, physical_constants.f90:40-43). Runtime-configurable because
    # higher truncations need stronger damping.
    thd: float = 2.4         # del^8, temperature and vorticity
    thdd: float = 2.4        # del^8, divergence
    thds: float = 12.0       # del^2, stratospheric

    # Numerics: "f64" for reference parity, "f32" for the fast path.
    precision: str = "f64"
    # The precision SPPT's normals are drawn in (their stream depends on it:
    # float64 normals take 64 bits of a threefry pair, float32 ones 32):
    # the configuration's, whatever precision the reference computes in.
    # None: `precision`.
    noise_precision: str | None = None

    # Zonal transform implementation: "fft" (torch.fft), "matmul" (dense DFT
    # plus dense Legendre operator), or "auto" (matmul on CUDA, fft on CPU).
    fft_mode: str = "auto"

    # The reference evaluates Legendre polynomials at first-guess (and
    # f32-rounded) Gaussian nodes while the quadrature weights are
    # Newton-converged (geometry.f90:110 vs legendre.f90:224-257), making its
    # transforms non-orthogonal at the ~5e-4 level. False replicates that for
    # parity; True uses converged f64 nodes (orthogonal to ~1e-12).
    exact_nodes: bool = False

    def __post_init__(self):
        if 86400 % self.nsteps != 0:
            raise ValueError(
                f"nsteps={self.nsteps} must divide 86400 so the model "
                "calendar advances an exact whole-second step")

    @property
    def il(self) -> int:
        return 2 * self.iy

    @property
    def mx(self) -> int:
        return self.trunc + 1

    @property
    def nx(self) -> int:
        return self.trunc + 2

    @property
    def t_levs(self) -> int:
        return 2

    @property
    def aux_dim(self) -> int:
        return 3

    @property
    def delt(self) -> float:
        return 86400.0 / self.nsteps

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "f64" else torch.float32

    @property
    def noise_dtype(self) -> torch.dtype:
        p = self.noise_precision or self.precision
        return torch.float64 if p == "f64" else torch.float32

    @property
    def np_dtype(self):
        """The numpy dtype tables are rounded to before they become tensors."""
        return np.float64 if self.precision == "f64" else np.float32


T30L8 = ModelParams()

# Additional resolution presets. The time step scales inversely with
# truncation (advective CFL); nsteps stays a multiple of 3 for the shortwave
# cadence.
T30L5 = ModelParams(kx=5)
T30L7 = ModelParams(kx=7)
T47L8 = ModelParams(trunc=47, ix=144, iy=36, nsteps=54)   # dt = 1600 s
T63L8 = ModelParams(trunc=63, ix=192, iy=48, nsteps=72,   # dt = 1200 s
                    thd=0.8, thdd=0.8, thds=6.0)
