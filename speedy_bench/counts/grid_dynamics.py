"""Row 1, the grid-point dynamics of a step, per column: reads vor, div, t,
the tracers, u and v (5 + ntr levels of kx) and the two ps gradients;
writes the three wind and temperature tendencies, the tracer tendencies,
the grid log-ps tendency, the two temperature fluxes, the two tracer
fluxes and the kinetic energy ((7 + 2 ntr) kx + 1 planes). About 70
operations a level, 11 a tracer level and 5 a column, counted from the
plain version (models/tendencies.py::grid_dynamics_core of the port)."""

from . import itemsize


def count(params, members: int, sppt: bool) -> tuple:
    kx, ntr = params.kx, params.ntr
    columns = members * params.il * params.ix
    planes = ((5 + ntr) * kx + 2) + ((7 + 2 * ntr) * kx + 1)
    flops = columns * (kx * (70 + 11 * ntr) + 5)
    return flops, columns * planes * itemsize(params)
