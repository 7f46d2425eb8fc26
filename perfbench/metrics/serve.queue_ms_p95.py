"""95th percentile of the window's requests' time from enqueue to
admission (their own RequestTrace), ms; of those enqueued before the
traced part, since the profiler's stop holds the scheduler up."""

from perfbench import readers


def read(r):
    return readers.p95_ms(r, "queue_s")
