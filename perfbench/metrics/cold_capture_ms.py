"""Mean milliseconds an executor's cold start spends capturing its prefill
and decode graphs (the program's ``cold.capture`` span, its wait for the
capture locks included), over every cold start of the run."""

import pb_spans
from pb_common import mean


def read(ctx):
    ms = pb_spans.durations_ms(ctx, "cold.capture")
    return mean(ms) if ms else None
