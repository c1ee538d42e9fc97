"""Share of the traced stretch in which the card idled while the executor
pool's host work ran: the idle gaps of 20 us or more that end at a kernel
launched from inside a ``pool.dispatch`` span but outside ``exec.launch``
(the lease, the executor's lock, a cold start, the feed, the sync, the
store, the landing), over the stretch's wall time
(``pb_spans.idle_split``)."""

import pb_spans


def read(ctx):
    return pb_spans.idle_pct(ctx, pb_spans.POOL)
