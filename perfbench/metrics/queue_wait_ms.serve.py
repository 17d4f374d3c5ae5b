"""ms a request of the window waited in the daemon's queue before the
batcher's worker took it: the program's span ``serve.queue_wait``, median
over the window's requests (the profiled segment follows the window and
is not among them)."""

from perfbench.readers import span_median_ms


def read(record):
    return span_median_ms(record, 'serve.queue_wait')
