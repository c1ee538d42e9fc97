"""K4's share of its roofline over the traced stretch: the bound of each of
its calls (operations and bytes from the launch shapes, ``pb_roofline``)
over the device time of all its passes, by kernel name from the profiler."""


def read(ctx):
    return ctx["roofline"].roofline_pct(ctx, "K4")
