"""Device ms a step of a chunk in the self time of the port's `step` span:
the step less its transforms, grid dynamics, physics, spectral update,
coupler and copies into the runner's buffers, which is the models' glue
(the passes of models/*.py between the kernels, the diagnostics check,
SPPT's AR(1) step), from the program's span store over the traced window's
run calls. None where the program keeps no store or it holds no step."""


def read(r):
    try:
        from pyspeedy_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    s = t["spans"].get("step")
    if not t["steps"] or s is None:
        return None
    return s["self_ms"] / t["steps"]
