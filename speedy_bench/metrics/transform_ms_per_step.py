"""Device ms a step of a chunk in the transforms' records
(layers/transforms)."""


def read(r):
    s = r.trace.by_layer.get("transforms", 0.0)
    return r.per_step_ms(s) if s > 0.0 else None
