"""Mean milliseconds an executor's cold start spends drawing its weights
on the device (the program's ``cold.weights`` span), over every cold start
of the run: calibration's, the pool's edge executor's, the warm-up's and
the window's."""

import pb_spans
from pb_common import mean


def read(ctx):
    ms = pb_spans.durations_ms(ctx, "cold.weights")
    return mean(ms) if ms else None
