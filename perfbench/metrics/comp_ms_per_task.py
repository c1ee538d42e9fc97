"""Mean milliseconds of an execution's compute: its prefill and decode
steps, from graphs on the card (the program's host clock around work its
stream has finished), over the window's executions."""

from pb_common import mean


def read(ctx):
    comp = [e.record.comp_ms for e in ctx["execs"]]
    return mean(comp) if comp else None
