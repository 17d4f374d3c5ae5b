"""ms a U-Net forward (a batch of 8 tiles): CUDA events around every call of
the net in the window, mean."""

from perfbench.readers import span_ms


def read(record):
    fwd = span_ms(record, 'forward')
    return sum(fwd) / len(fwd) if fwd else None
