"""The whole step's share of the chips' bf16 peak: model FLOPs of the real
tiles the window denoised over its wall time, in %."""

from perfbench.readers import step_mfu_pct


def read(record):
    return step_mfu_pct(record)
