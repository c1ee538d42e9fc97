"""Mean milliseconds an execution of the window waited in a queue of the
executor pool, on the stream's clock: at the pool's resident cap, or in the
edge executor's FIFO. Read from the execution records the pool returns (the
records of ``serve_async`` carry the edge FIFO's waits alone in their
``queue_wait_ms``; a cap wait is in their latency only)."""

from pb_common import mean


def read(ctx):
    waits = [e.record.queue_ms for e in ctx["execs"]]
    return mean(waits) if waits else None
