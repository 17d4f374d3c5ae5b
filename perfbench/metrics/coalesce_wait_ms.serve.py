"""ms a request of the window waited, once the batcher's worker took it,
for its batch's sample to start (the coalescing window, or the batch
filling): the program's span ``serve.coalesce_wait``, median over the
window's requests (the profiled segment follows the window and is not
among them)."""

from perfbench.readers import span_median_ms


def read(record):
    return span_median_ms(record, 'serve.coalesce_wait')
