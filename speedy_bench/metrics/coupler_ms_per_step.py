"""Device ms a step of a chunk in the port's `coupler` span
(coupling/coupler.py::couple_sea_land inside the step graphs: the slab land
and sea exchange), from the program's span store over the traced window's
run calls. None where the program keeps no store or it holds no step."""


def read(r):
    try:
        from pyspeedy_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    s = t["spans"].get("coupler")
    if not t["steps"] or s is None:
        return None
    return s["ms"] / t["steps"]
