"""Seconds the process's batched runners spent capturing their step graphs
(each key's graph and its traced twin, the eager warm-up step included):
the set-up counters of the program's span store. None where the program
keeps no store, it holds no step, or nothing was captured."""


def read(r):
    try:
        from pyspeedy_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    if not t["steps"] or not t["captures"]:
        return None
    return t["capture_s"]
