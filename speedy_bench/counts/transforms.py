"""Rows 3-4, the spectral transforms of a step: the dynamics' inverse group
(vor, div, t, the tracers, u and v: 6 kx rows, and the two ps gradients),
the physics' inverse group (u, v, t, q: 4 kx rows, ps; with SPPT the
pattern's kx rows), and one direct group of 9 kx + 1 rows (the ten
outputs of the grid dynamics, the physics' tendencies added into them).
A row is one (member, field level) plane: il x ix grid points against
mx x nx spectral pairs. Each grid row and spectral pair is moved once, the
DFT and Legendre tables once a launch (three launches a step). Operations:
the DFT folded by the half period (il mx ix multiply-adds a row) and the
Legendre stage over the triangle (il x (mx nx - mx (mx - 1) / 2)), two
operations a multiply-add. At T47 and T63 the port's kernels run the DFT on
the tensor cores (3xTF32 in float32, the FP64 tensor cores in float64):
their peak is that rate; at T30 they run outside the tensor cores."""

from . import itemsize


# (il, ix, mx, nx) of the truncations whose kernels use the tensor cores.
TENSOR_CORE_SHAPES = ((72, 144, 48, 49), (96, 192, 64, 65))


def peak_key(params) -> str | None:
    if (params.il, params.ix, params.mx, params.nx) in TENSOR_CORE_SHAPES:
        return ("float64_tensor_flops_per_s" if params.precision == "f64"
                else "tf32x3_flops_per_s")
    return None


def rows(params, sppt: bool) -> tuple:
    """(inverse rows, direct rows) a member and step."""
    kx, ntr = params.kx, params.ntr
    dyn = (5 + ntr) * kx + 2
    phys = 4 * kx + 1 + (kx if sppt else 0)
    direct = (7 + 2 * ntr) * kx + 1
    return dyn + phys, direct


def count(params, members: int, sppt: bool) -> tuple:
    il, ix, mx, nx = params.il, params.ix, params.mx, params.nx
    w = itemsize(params)
    tri = mx * nx - mx * (mx - 1) // 2
    inv, direct = rows(params, sppt)
    n = members * (inv + direct)
    row_bytes = il * ix * w + 2 * mx * nx * w
    table_bytes = (2 * ix * mx + il * mx * nx) * w
    flops = n * 2 * (il * mx * ix + il * tri)
    return flops, n * row_bytes + 3 * table_bytes
