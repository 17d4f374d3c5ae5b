"""int8_conv's share of its roofline: the frozen least time of the W8A8
convolutions of the forwards the profiled part holds whole (by their tile
batches, read from the forwards' marks) over their device time in those
forwards, in %."""

from perfbench.readers import roofline_pct


def read(record):
    return roofline_pct(record, 'int8_conv')
