"""Device ms a step of a chunk in records that match no layer's pattern:
PyTorch's own kernels, copies and fills (the coupler, the glue of the
models, the runner's copies)."""


def read(r):
    s = r.trace.by_layer.get("torch_passes", 0.0)
    return r.per_step_ms(s) if s > 0.0 else None
