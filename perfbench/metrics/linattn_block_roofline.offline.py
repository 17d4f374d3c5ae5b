"""linattn_block's share of its roofline: the frozen least time of its calls
over their device time in the profiled call, in %."""

from perfbench.readers import roofline_pct


def read(record):
    return roofline_pct(record, 'linattn_block', merge_owner='linattn_block')
