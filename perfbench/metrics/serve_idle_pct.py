"""Share of the traced stretch in which the card idled for the serve loop:
every idle gap of 20 us or more that ends at a kernel launched outside a
``pool.dispatch`` span (placement, records, the workers' start and join),
and the idle before the first kernel and after the last, over the
stretch's wall time (``pb_spans.idle_split``). With the launch and pool
shares and the gaps under 20 us it makes up ``idle_pct``."""

import pb_spans


def read(ctx):
    return pb_spans.idle_pct(ctx, pb_spans.SERVE)
