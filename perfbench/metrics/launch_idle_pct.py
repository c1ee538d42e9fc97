"""Share of the traced stretch in which the card idled while the host was
replaying an execution's graphs: the idle gaps of 20 us or more that end
at a kernel launched from inside the program's ``exec.launch`` span (the
prefill replay, ``DecodeGraph.load`` and every decode replay), over the
stretch's wall time (``pb_spans.idle_split``)."""

import pb_spans


def read(ctx):
    return pb_spans.idle_pct(ctx, pb_spans.LAUNCH)
