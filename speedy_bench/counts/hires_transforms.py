"""Rows 3-4 at T47 and T63, each direction alone: the work of the
thread-block-cluster kernels (``csrc/fused_transform_hires.cu``) in one
step of a chunk. The direct kernel takes the step's direct group in one
launch, the inverse kernel the dynamics' and the physics' groups in two.
Rows, bytes a row and a table, and operations a row are those of
``transforms.py`` (the two directions there summed); so is the peak,
``peak_key("transforms", params)``: 3xTF32 in float32, the FP64 tensor
cores in float64."""

from . import itemsize
from .transforms import rows

__all__ = ["direct", "inverse"]


def _count(params, n_rows: int, launches: int) -> tuple:
    il, ix, mx, nx = params.il, params.ix, params.mx, params.nx
    w = itemsize(params)
    tri = mx * nx - mx * (mx - 1) // 2
    row_bytes = il * ix * w + 2 * mx * nx * w
    table_bytes = (2 * ix * mx + il * mx * nx) * w
    flops = n_rows * 2 * (il * mx * ix + il * tri)
    return flops, n_rows * row_bytes + launches * table_bytes


def direct(params, members: int, sppt: bool) -> tuple:
    """(flops, bytes) of the direct kernel in one step of `members`."""
    return _count(params, members * rows(params, sppt)[1], 1)


def inverse(params, members: int, sppt: bool) -> tuple:
    """(flops, bytes) of the inverse kernel in one step of `members`."""
    return _count(params, members * rows(params, sppt)[0], 2)
