"""Device ms a step of a chunk in SPPT's noise draw (the span `sppt.draw`,
physics/sppt.py::_draw_steps, eager), from the program's span store over
the traced window's run calls. None without SPPT, and where the program
keeps no store or it holds no step."""


def read(r):
    try:
        from pyspeedy_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    s = t["spans"].get("sppt.draw")
    if not t["steps"] or s is None:
        return None
    return s["ms"] / t["steps"]
