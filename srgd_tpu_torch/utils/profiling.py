"""Spans and phase timers: the port's one tracing API.

Counterpart of ``srgd_tpu/utils/profiling.py``'s phase timer, widened into
spans. A span has a name, a duration and the identifier it shares with the
other spans of its step or request (the training step's index; the daemon's
request id, beside the id of the batch the request was sampled in).

- Each span opens a ``torch.profiler.record_function`` range of its name, so
  a profiler session names the device's idle gaps that the span covers; with
  no session open the range costs a few microseconds.
- On a CUDA device a span is timed by a pair of CUDA events on the current
  stream: its device time, read once ``query()`` says the events completed
  (at the latest when a ring is read), never by synchronising the device.
  Elsewhere a span takes the host clock.
- A store (``Spans``) keeps, for each name, a total, a count and a ring of
  the latest ``RING`` entries, so its memory stays bounded over a long run.

The spans are always on. ``SPANS`` is the process's store; the training step
(``train.trainer.make_train_step``, ``train.loop._DevicePrefetcher``) and the
serving daemon (``serve.py``) write into it, one entry a step or a request:

- ``train.data_wait`` (host): the step's wait for its batch;
- ``train.forward`` (device): the uint8 normalisation, the draws, the loss;
- ``train.backward`` (device): ``loss.backward()``;
- ``train.optimizer`` (device): ``zero_grad``, the learning rate and the
  optimizer's step, two intervals summed;
- ``train.ema`` (device): the EMA update;
- ``train.mesh`` (device; under a mesh only): the loss and gradient
  reduction and the gather of the updated shards;
- ``serve.decode``, ``serve.prepare``, ``serve.queue_wait``,
  ``serve.coalesce_wait``, ``serve.sample``, ``serve.encode`` and
  ``serve.total`` (host): a request's stages (``serve.py``'s docstring).

``train.loop`` hands its own ``PhaseTimer`` to the step in place of
``SPANS``, so a run's log reports its own steps.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple

import torch
from torch.profiler import record_function

RING = 4096


class Entry(NamedTuple):
    """One span: the step's or request's ``id``, its ``seconds``, and for a
    coalesced daemon request the number of the ``batch`` it was sampled in,
    so a reader of the rings can group one batch's requests (its head, which
    waited out the window, and the members that joined it)."""
    id: Any
    seconds: float
    batch: Any = None


class Trace:
    """The spans of one step or request. ``with trace(name):`` times an
    interval (on ``device``'s current stream when that is a CUDA device);
    ``add(name, seconds)`` adds one timed elsewhere, such as a wait that
    begins on one thread and ends on another. A name's intervals are summed
    into one entry, written when ``end()`` is called and its events have
    completed. A trace that is never ended writes nothing."""

    def __init__(self, store: 'Spans', id=None, device=None):
        self.store, self.id, self.batch = store, id, None
        self.device = device
        self.cuda = device is not None and torch.device(device).type == 'cuda'
        self.host: Dict[str, float] = {}
        self.events: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        with record_function(name):
            if self.cuda:
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                try:
                    yield
                finally:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(stream)
                    self.events.append((name, start, end))
            else:
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.host[name] = self.host.get(name, 0.0) + seconds

    def end(self) -> None:
        self.store._finish(self)

    def _done(self, wait: bool) -> bool:
        if wait:
            for _, _, end in self.events:
                end.synchronize()
            return True
        return all(end.query() for _, _, end in self.events)

    def _seconds(self) -> Dict[str, float]:
        out = dict(self.host)
        for name, start, end in self.events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end) / 1e3
        return out


class Spans:
    """Named spans: for each name a total (``totals``, seconds), a count
    (``counts``) and a ring of the latest ``capacity`` entries
    (``ring(name)``). Entries are written in the order their traces end.
    Safe to share between threads."""

    def __init__(self, capacity: int = RING):
        self.capacity = capacity
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.rings: Dict[str, deque] = {}
        self._pending: deque = deque()  # traces waiting for their events
        self._lock = threading.Lock()

    def trace(self, id=None, device=None) -> Trace:
        return Trace(self, id, device)

    @contextlib.contextmanager
    def span(self, name: str, id=None):
        """One host-clock span as a trace of its own, written when it
        closes."""
        t = self.trace(id)
        with t(name):
            yield
        t.end()

    def ring(self, name: str) -> List[Entry]:
        """``name``'s latest entries, oldest first, once every pending
        trace's events have completed."""
        with self._lock:
            pending = list(self._pending)
        for t in pending:
            t._done(wait=True)
        self._resolve()
        with self._lock:
            return list(self.rings.get(name, ()))

    def report(self) -> str:
        """One line a name, the largest total first."""
        self._resolve()
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        lines = []
        for name in sorted(totals, key=totals.get, reverse=True):
            n, tot = counts[name], totals[name]
            lines.append(f'{name}: {tot:.3f}s total, {n} calls, '
                         f'{tot / n * 1e3:.1f} ms/call')
        return '\n'.join(lines)

    def _finish(self, trace: Trace) -> None:
        with self._lock:
            self._pending.append(trace)
        self._resolve()

    def _resolve(self) -> None:
        """Write the pending traces whose events have completed, in order."""
        with self._lock:
            while self._pending and self._pending[0]._done(wait=False):
                t = self._pending.popleft()
                for name, s in t._seconds().items():
                    self.totals[name] = self.totals.get(name, 0.0) + s
                    self.counts[name] = self.counts.get(name, 0) + 1
                    ring = self.rings.get(name)
                    if ring is None:
                        ring = self.rings[name] = deque(maxlen=self.capacity)
                    ring.append(Entry(t.id, s, t.batch))

    def __getstate__(self):
        for t in list(self._pending):
            t._done(wait=True)
        self._resolve()
        return {k: v for k, v in self.__dict__.items()
                if k not in ('_lock', '_pending')}

    def __setstate__(self, state):
        self.__dict__.update(state, _lock=threading.Lock(), _pending=deque())


SPANS = Spans()


class PhaseTimer(Spans):
    """A run's spans and its host-clock phases. ``phase(name, sync=device)``
    waits for the device's queued work before it stops the clock
    (``torch.cuda.synchronize``, where the JAX timer blocks on a result);
    ``durations``: each name's latest durations, in seconds."""

    @contextlib.contextmanager
    def phase(self, name: str, sync=None, id=None):
        with self.span(name, id):
            yield
            if sync is not None and torch.device(sync).type == 'cuda':
                torch.cuda.synchronize(sync)

    @property
    def durations(self) -> Dict[str, List[float]]:
        self._resolve()
        with self._lock:
            return {name: [e.seconds for e in ring]
                    for name, ring in self.rings.items()}
