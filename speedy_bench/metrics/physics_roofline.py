"""The physics layer's share of its roofline: the larger of its operations
at the float32 peak and its bytes at the memory rate (counts/physics.py),
over its device time in the traced window, in %."""


def read(r):
    return r.roofline_pct("physics")
