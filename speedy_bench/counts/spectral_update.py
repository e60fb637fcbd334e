"""Row 6, the spectral side of a step (flux combination, linear
tendencies, semi-implicit solve, diffusion and drag, leapfrog), per member:
reads the direct transform's (7 + 2 ntr) kx + 1 spectra, the log-ps
tendency, both time levels of vor, div, t, ps and the tracers and the
geopotential (kx); writes both time levels. A spectrum is 2 x mx x nx
values. About 116 + 6 kx + 25 ntr operations a level at each (part, m, n)
point and 20 for log-ps, counted from the kernel."""

from . import itemsize


def count(params, members: int, sppt: bool) -> tuple:
    kx, ntr, mx, nx = params.kx, params.ntr, params.mx, params.nx
    pair = 2 * (3 * kx + 1 + ntr * kx)
    spectra = ((7 + 2 * ntr) * kx + 1) + 1 + pair + kx + pair
    flops = members * 2 * mx * nx * (kx * (116 + 6 * kx + 25 * ntr) + 20)
    return flops, members * spectra * 2 * mx * nx * itemsize(params)
