"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a fixed
piece of work, reduced to device-kernel rows, the device's busy time and
the breakdown the result line carries.

The profiler on the card drops the records of the first device kernels of
a session, more of them the more device work the process ran before it
(a finding of chip_smoke.py's profiling). So each session opens with
``PROFILE_PAD`` spin kernels, left out of everything below, and counts how
many of them were dropped; a session that dropped them all may have lost
real records too, and fails the run instead of reporting a short device
time (copied from chip_smoke.py's ``_device_rows``).

A forward of the net is told apart on the device's own timeline: the
drivers wrap it in ``ForwardMarks``, which puts tiny marker kernels on its
stream before it (one more than its tile batch) and after it. A kernel's
share of its roofline then takes its bound and its device time from the
same forwards, the ones whose marks the session holds whole after its pad,
whichever thread launched them and however far the host ran ahead."""

from __future__ import annotations

import re
import time

PROFILE_PAD = 64
PAD_KERNEL = 'spin_kernel'
# a fill of a float64 tensor opens a forward (tile batch + 1 of them), a fill
# of an int16 one closes it: kernels no forward of the net launches
MARK_OPEN = 'FillFunctor<double>'
MARK_CLOSE = 'FillFunctor<short>'


class ForwardMarks:
    """Wraps a forward ``fn(x, ...)`` so that the device's timeline marks
    where it starts and ends and how many tiles ``x`` holds."""

    def __init__(self, torch, device):
        self.open = torch.empty(1, dtype=torch.float64, device=device)
        self.close = torch.empty(1, dtype=torch.int16, device=device)

    def wrap(self, fn):
        def marked(x, *a, **k):
            for _ in range(x.shape[0] + 1):
                self.open.fill_(1.0)
            out = fn(x, *a, **k)
            self.close.fill_(1)
            return out
        return marked


def _mark(name: str):
    return 'open' if MARK_OPEN in name else 'close' if MARK_CLOSE in name \
        else None


def function(key: str) -> str:
    """The function name of a profiler key: ``ns::name<args>(params)``."""
    m = re.search(r'(\w+)(<.*>)?\(', key)
    return m.group(1) if m else key


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profiled(torch, work, record) -> None:
    """Run ``work()`` under the profiler and fill ``record``: ``rows``
    ((ms, count, key) of every device kernel, largest first), ``busy_s``
    (the union of device-kernel intervals), ``window_s`` (host wall time
    of ``work`` between two synchronisations) and ``breakdown``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    reduce_events(prof.events(), window, record)


def reduce_events(events, window: float, record) -> None:
    """Fill ``record`` from a session's events (see ``profiled``); fails
    when the session dropped every pad record or recorded no kernel."""
    from torch.autograd import DeviceType
    # a range the host opened (record_function, the optimizer's step) is
    # mirrored on the device's timeline under the same name: not a kernel
    host_ranges = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in host_ranges
               and e.time_range.end > e.time_range.start]
    pads = [e for e in kernels if function(e.name) == PAD_KERNEL]
    lost = PROFILE_PAD - len(pads)
    if lost >= PROFILE_PAD:
        raise RuntimeError(f'the profiler dropped all {PROFILE_PAD} pad '
                           'records: real records may be lost too')
    real = [e for e in kernels if function(e.name) != PAD_KERNEL
            and _mark(e.name) is None]
    if not real:
        raise RuntimeError('the profiler recorded no device kernel')
    by_key = {}
    for e in real:
        ms, n = by_key.get(e.name, (0.0, 0))
        by_key[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                          n + 1)
    record.rows = sorted(((ms, n, k) for k, (ms, n) in by_key.items()),
                         reverse=True)
    spans = _union((e.time_range.start, e.time_range.end) for e in real)
    record.busy_s = sum(e - s for s, e in spans) / 1e6
    record.window_s = window
    record.counters['records_lost_at_session_start'] = lost
    record.forwards = forwards(
        [e for e in kernels if function(e.name) != PAD_KERNEL],
        after=max(e.time_range.end for e in pads))
    record.counters['profiled_batches'] = [b for b, _ in record.forwards]
    record.counters['profiled_forwards'] = len(record.forwards)
    record.breakdown = {
        'device_ops': [[function(k), ms / 1e3] for ms, _, k
                       in _top_by_function(record.rows)],
        'idle_gaps': _idle_gaps(events, spans, DeviceType)}


def forwards(kernels, after: float) -> list:
    """(tile batch, {kernel key: ms}) of every forward whose marks, in
    device-time order, read: the opening run, begun after the session's
    pad (``after``), the forward's own kernels, the close. A run broken by
    a stray mark is left out whole."""
    out, state, n, seg, start = [], None, 0, {}, 0.0
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        m = _mark(e.name)
        if m == 'open':
            if state == 'inside' or state == 'broken':
                state = 'broken'        # until the next close
                continue
            if state is None:
                state, n, seg = 'opening', 0, {}
                start = e.time_range.start
            n += 1
        elif m == 'close':
            if state == 'inside' and start >= after:
                out.append((n - 1, seg))
            state = None
        elif state in ('opening', 'inside'):
            state = 'inside'
            seg[e.name] = seg.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    return out


def _top_by_function(rows, n: int = 10):
    by_fn = {}
    for ms, cnt, key in rows:
        f = function(key)
        prev = by_fn.get(f, (0.0, 0, key))
        by_fn[f] = (prev[0] + ms, prev[1] + cnt, key)
    return sorted(by_fn.values(), reverse=True)[:n]


def _idle_gaps(events, spans, DeviceType, n: int = 10):
    """The ``n`` longest gaps between device kernels, each named by the
    innermost host operation running at its middle (``host`` when none)."""
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1],
                    spans[i + 1][0]) for i in range(len(spans) - 1)),
                  reverse=True)[:n]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    out = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        covering = [c for c in cpu
                    if c.time_range.start <= mid <= c.time_range.end]
        name = (min(covering, key=lambda c: c.time_range.end
                    - c.time_range.start).name if covering else 'host')
        out.append([name, length / 1e6])
    return out
