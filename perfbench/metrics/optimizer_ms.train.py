"""ms a training step spends in its optimizer: ``zero_grad``, the learning
rate and AdamW's step, launched parameter by parameter; its two intervals
summed.
The device time between CUDA events the program's train step records on its
stream (the span ``train.optimizer``), median of the window's steps (the
last ``steps`` entries; the two profiled steps after the window are among
them and do not move a median)."""

import statistics


def read(record):
    steps = record.counters.get('steps')
    if not steps:
        return None
    try:
        from srgd_tpu_torch.utils.profiling import SPANS
    except ImportError:         # a program without spans
        return None
    ring = SPANS.ring('train.optimizer')
    if len(ring) < steps:
        return None
    return statistics.median(e.seconds for e in ring[-steps:]) * 1e3
