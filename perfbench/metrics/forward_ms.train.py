"""ms a training step spends in its forward: the uint8 normalisation, the
step's draws and the loss.
The device time between CUDA events the program's train step records on its
stream (the span ``train.forward``), median of the window's steps (the
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
    ring = SPANS.ring('train.forward')
    if len(ring) < steps:
        return None
    return statistics.median(e.seconds for e in ring[-steps:]) * 1e3
