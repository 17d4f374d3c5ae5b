"""What the per-layer readers in ``metrics/`` share: each reads a traced
run's ``harness.Record`` and returns a number, or None when the record has
nothing for it (the metric is then left out of the result line)."""

from __future__ import annotations

import statistics

from perfbench import kernels
from perfbench.counts import formulas


def device_idle_pct(record):
    if not record.window_s or record.busy_s is None:
        return None
    return (1.0 - record.busy_s / record.window_s) * 100.0


def roofline_pct(record, kernel: str, merge_owner: str | None = None):
    """The kernel's least time (frozen counts, by the tile batches of the
    forwards the profiled part holds whole) over its device time in those
    same forwards, in %."""
    ms = sum(v for _, seg in record.forwards for k, v in seg.items()
             if kernels.owner(k, merge_owner) == kernel)
    if ms <= 0:
        return None
    bound = sum(formulas.forward_bound_s(kernel, b)
                for b, _ in record.forwards)
    return bound * 1e3 / ms * 100.0


def step_mfu_pct(record, dtype: str = 'bfloat16'):
    """Model FLOPs of the real tiles the window denoised over the window's
    time and the chips' peak, in %."""
    c = record.counters
    if not c.get('window_s') or not c.get('real_tiles'):
        return None
    flops = c['real_tiles'] * formulas.unet_counts()['model_flops_per_tile']
    peak = formulas.peaks()['flops_per_s'][dtype] * c.get('chips', 1)
    return flops / (c['window_s'] * peak) * 100.0


def group_ms_per_forward(record, exclude: tuple):
    """Device ms a forward in kernels outside the groups ``exclude``, over
    the forwards the profiled part holds whole."""
    if not record.forwards:
        return None
    return sum(v for _, seg in record.forwards for k, v in seg.items()
               if kernels.group(k) not in exclude) / len(record.forwards)


def span_ms(record, name: str):
    return [ms for ms, _ in record.spans.get(name, [])]


def span_median_ms(record, name: str):
    v = span_ms(record, name)
    return statistics.median(v) if v else None
