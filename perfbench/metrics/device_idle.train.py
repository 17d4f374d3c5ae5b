"""Share of the profiled training steps' wall time with no kernel on the
device, %."""

from perfbench.readers import device_idle_pct


def read(record):
    return device_idle_pct(record)
