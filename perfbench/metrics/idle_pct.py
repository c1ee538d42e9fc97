"""Share of the traced stretch in which no kernel ran on the card (the
union of the profiler's kernel intervals against its wall time)."""


def read(ctx):
    if not ctx["kernels_seen"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
