"""Device ms a step of a chunk in records that the host launched outside a
CUDA graph (the copy-in and clone-out of a run call, the daily forcing,
SPPT's noise draw), by the profiler's link from a record to its launch."""


def read(r):
    t = r.trace
    if t.records == 0 or t.linked == 0:
        return None
    return r.per_step_ms(t.eager_s)
