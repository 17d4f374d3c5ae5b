"""The whole training step's share of the chip's bf16 peak: three forwards'
model FLOPs (forward and backward) for every tile of the window's steps
over the window's wall time, in %."""

from perfbench.readers import step_mfu_pct


def read(record):
    return step_mfu_pct(record)
