"""The host's enqueue calls (kernel launches, copies, fills, graph
launches) a step of a chunk in the traced window."""


def read(r):
    t = r.trace
    if t.records == 0:
        return None
    return t.host_calls / t.chunk_steps
