"""Row 3 at T47/T63: ``hires_direct_cluster_kernel``'s share of its
roofline, the larger of its operations at the peak of its units (3xTF32's
165 TFLOP/s in float32) and its bytes at the memory rate
(counts/hires_transforms.py), over its device seconds in the traced window
(every record whose name holds the kernel's, as
layers/transforms/fused_transform_hires.json matches it), in %. The
window's daily forcing, if it holds one, adds time and no counted work, as
in transform_roofline. None where the window holds no record of it (T30)."""

import re

from .. import counts
from ..counts import hires_transforms as H

KERNEL = "hires_direct_cluster_kernel"


def kernel_roofline(r, kernel: str, count) -> float | None:
    """The share of its roofline of the records of `kernel` in the traced
    window of Reading `r`, `count(params, members, sppt)` its work a
    step."""
    pattern = re.compile(kernel)
    t = sum(v[0] for name, v in r.trace.by_name.items()
            if pattern.search(name))
    if t <= 0.0:
        return None
    flops, nbytes = count(r.params, r.trace.members, r.sppt)
    p = r.peaks
    bound = max(flops / p[counts.peak_key("transforms", r.params)],
                nbytes / p["hbm_bytes_per_s"])
    return 100.0 * bound * r.trace.chunk_steps / t


def read(r):
    return kernel_roofline(r, KERNEL, H.direct)
