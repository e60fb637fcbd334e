"""Device records (kernels, copies, fills) a step of a chunk in the traced
window."""


def read(r):
    t = r.trace
    if t.records == 0:
        return None
    return t.records / t.chunk_steps
