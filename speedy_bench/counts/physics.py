"""Row 2, the column physics of a step, the shortwave and the other steps
weighted by the cadence (one in nstrad with shortwave). Per column it reads
the lowest level of u and v, t and q (kx each), ps, the lapse-rate
correction (kx values a latitude), the boundary fields that differ by
member (8 planes: the slab models' and the forcing's fields; the shared
ones count once a call and are left out), with SPPT the pattern (kx) and,
on a step without shortwave, the radiation cache it reads (5 kx + 3
planes); it writes the four tendencies (4 kx), the diagnostics (2 kx + 28
planes) and, on a shortwave step, the cache (5 kx + 6 planes). About 190
operations a level, 120 more with shortwave (an exponential taken as 20)
and 150 a column for the surface fluxes."""

from . import itemsize

BC_MEMBER_PLANES = 8


def step_kind(params, members: int, sppt: bool, shortwave: bool) -> tuple:
    kx = params.kx
    columns = members * params.il * params.ix
    planes_in = 2 + 2 * kx + 1 + kx / params.ix + BC_MEMBER_PLANES
    planes_in += kx if sppt else 0
    planes_out = 4 * kx + 2 * kx + 28
    if shortwave:
        planes_out += 5 * kx + 6
    else:
        planes_in += 5 * kx + 3
    flops = columns * (kx * (310 if shortwave else 190) + 150)
    return flops, columns * (planes_in + planes_out) * itemsize(params)


def count(params, members: int, sppt: bool) -> tuple:
    sw = step_kind(params, members, sppt, True)
    other = step_kind(params, members, sppt, False)
    k = params.nstrad
    return ((sw[0] + (k - 1) * other[0]) / k,
            (sw[1] + (k - 1) * other[1]) / k)
