"""Bytes the batched runner copies a member-step: the copy-in of the state
into its buffers, the clones out and each step's coupler tables and SPPT
noise (the counters bytes_in, bytes_out, bytes_inputs), over the
member-steps of the traced window's run calls, from the program's span
store. None where the program keeps no store or it holds no step."""


def read(r):
    try:
        from pyspeedy_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    if not t["member_steps"]:
        return None
    return (t["bytes_in"] + t["bytes_out"] + t["bytes_inputs"]) \
        / t["member_steps"]
