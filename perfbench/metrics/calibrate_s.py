"""Seconds the run spends calibrating the slice catalog on real executions
(the program's ``calibrate`` span: cold starts, warm measurements, fits)."""

import pb_spans


def read(ctx):
    ms = pb_spans.durations_ms(ctx, "calibrate")
    return sum(ms) / 1e3 if ms else None
