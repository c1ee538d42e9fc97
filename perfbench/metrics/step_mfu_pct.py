"""The steps' share of the card's bf16 peak over the traced stretch: the
model operations (the mixture's active experts only) of every prefill and
decode step that finished there, over its wall time times 989 TFLOP/s."""


def read(ctx):
    rf = ctx["roofline"]
    pre, dec = rf.step_flops(ctx["cfg"], ctx["prompt_len"], ctx["family"])
    done = [e for e in ctx["execs"] if e.traced]
    if not done:
        return None
    flops = sum(pre + e.steps * dec for e in done)
    return 100.0 * flops / (ctx["trace_window_s"] * rf.PEAK_BF16)
