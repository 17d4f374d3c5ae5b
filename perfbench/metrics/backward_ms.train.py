"""ms a training step spends in its backward: ``loss.backward()``, the
kernels' recomputed VJPs included.
The device time between CUDA events the program's train step records on its
stream (the span ``train.backward``), median of the window's steps (the
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
    ring = SPANS.ring('train.backward')
    if len(ring) < steps:
        return None
    return statistics.median(e.seconds for e in ring[-steps:]) * 1e3
