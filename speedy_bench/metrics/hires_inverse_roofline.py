"""Row 4 at T47/T63: ``hires_inverse_ws_kernel``'s share of its roofline
(the dynamics' and the physics' groups, two launches a step), read as
hires_direct_roofline reads row 3's. None where the window holds no record
of it (T30)."""

from ..counts import hires_transforms as H
from .hires_direct_roofline import kernel_roofline

KERNEL = "hires_inverse_ws_kernel"


def read(r):
    return kernel_roofline(r, KERNEL, H.inverse)
