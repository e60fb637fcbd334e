"""Device ms a step of a chunk in the batched runner's copy-in of the state
into its buffers and clone-out of the state after the call (the spans
`runner.copy_in` and `runner.clone_out`), from the program's span store
over the traced window's run calls. None where the program keeps no store
or it holds no step."""


def read(r):
    try:
        from pyspeedy_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    spans = [t["spans"].get(n) for n in ("runner.copy_in", "runner.clone_out")]
    if not t["steps"] or None in spans:
        return None
    return sum(s["ms"] for s in spans) / t["steps"]
