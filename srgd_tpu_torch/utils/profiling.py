"""Tracing and profiling hooks.

Counterpart of ``srgd_tpu/utils/profiling.py``: a phase timer whose report
feeds the training log, and a ``torch.profiler`` trace around any phase.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase, and keeps each call's time
    (``durations``). ``phase(name, sync=device)`` waits for the device's
    queued work before it stops the clock (``torch.cuda.synchronize``, where
    the JAX timer blocks on a result)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.durations: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and torch.device(sync).type == 'cuda':
                torch.cuda.synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.durations[name].append(dt)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f'{name}: {tot:.3f}s total, {n} calls, '
                         f'{tot / n * 1e3:.1f} ms/call')
        return '\n'.join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the CPU and, when present, the card,
    written to ``log_dir`` as a Chrome trace; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
