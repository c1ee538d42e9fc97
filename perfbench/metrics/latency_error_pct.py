"""The predictor's error: the gap between the window's mean predicted and
mean actual latency, over the mean actual (the paper's latency prediction
error), from the records."""

from pb_common import latency_error_pct


def read(ctx):
    r = ctx["records"]
    return latency_error_pct(r["predicted_ms"], r["latency_ms"])
