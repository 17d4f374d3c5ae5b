"""ms a training step waits for its batch: a host-clock span around each
fetch from the device prefetcher in the window, mean (the Real-ESRGAN
degradation on the data threads shows here when it cannot keep up)."""

from perfbench.readers import span_ms


def read(record):
    waits = span_ms(record, 'data_wait')
    return sum(waits) / len(waits) if waits else None
