"""What every cell shares: the registry of cells, configurations, drivers and
per-layer metrics (found by name, as files), the seeded inputs and noise,
the run environment, the record a traced run fills, and the result line.

Nothing here imports the program under test or JAX: the drivers import the
program, inside their functions.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent          # perfbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'srgd_tpu')
SEED_MOD = 2 ** 63


# ---------------------------------------------------------------------------
# Registry: everything specific is a file found by its name
# ---------------------------------------------------------------------------

def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """``cells/<name>.json`` with its configuration (``configs/<config>.json``)
    under ``config_data``."""
    path = ROOT / 'cells' / f'{name}.json'
    if not path.is_file():
        raise KeyError(f'no cell {name!r}: {path} is missing')
    c = _json(path)
    c['name'] = name
    c['config_data'] = config(c['config'])
    return c


def traffic(name: str) -> dict:
    """``traffic/<name>.json``: the driver's name and its parameters."""
    path = ROOT / 'traffic' / f'{name}.json'
    if not path.is_file():
        raise KeyError(f'no traffic mix {name!r}: {path} is missing')
    return _json(path)


def config(name: str) -> dict:
    path = ROOT / 'configs' / f'{name}.json'
    if not path.is_file():
        raise KeyError(f'no configuration {name!r}: {path} is missing')
    return _json(path)


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """``drivers/<name>.py``: a module with ``run(cell, opts) -> Outcome``."""
    path = ROOT / 'drivers' / f'{name}.py'
    if not path.is_file():
        raise KeyError(f'no driver {name!r}: {path} is missing')
    return _load_file(path, f'perfbench_driver_{name}')


def metric_reader(name: str):
    """``metrics/<name>.py``: a module with ``read(record) -> float | None``."""
    path = ROOT / 'metrics' / f'{name}.py'
    if not path.is_file():
        raise KeyError(f'no reader for metric {name!r}: {path} is missing')
    return _load_file(path, 'perfbench_metric_' + name.replace('.', '_'))


def benchmark() -> dict:
    return _json(CHECKOUT / 'BENCHMARK.json')


def cell_metrics(name: str, trace: bool, spec: dict | None = None) -> list:
    """The metric entries of BENCHMARK.json that cell ``name`` reports: with
    ``trace`` the per-layer ones, else the end-to-end ones."""
    spec = spec or benchmark()
    key = 'per_layer' if trace else 'end_to_end'
    return [m for m in spec[key]
            if 'workloads' not in m or name in m['workloads']]


# ---------------------------------------------------------------------------
# Seeded inputs
# ---------------------------------------------------------------------------

def seed_of(*parts) -> int:
    """A 63-bit seed from the run's seed and labels (stable across runs)."""
    import hashlib
    h = hashlib.sha256(repr(tuple(int(p) % SEED_MOD if isinstance(p, int)
                                  else p for p in parts)).encode())
    return int.from_bytes(h.digest()[:8], 'little') % SEED_MOD


def photo(seed: int, h: int, w: int) -> np.ndarray:
    """A smooth random RGB image (h, w, 3) uint8: octaves of bicubically
    upsampled noise and a few hard edges, as photo content."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    img = torch.zeros(1, 3, h, w)
    for octave, amp in ((4, 1.0), (16, 0.5), (64, 0.25)):
        base = torch.rand(1, 3, max(h // octave, 2), max(w // octave, 2),
                          generator=g)
        img += amp * F.interpolate(base, size=(h, w), mode='bicubic',
                                   align_corners=False)
    yy = torch.arange(h)[:, None].float()
    xx = torch.arange(w)[None, :].float()
    for _ in range(3):
        a, b, c0 = (torch.rand(3, generator=g) * 2 - 1).tolist()
        img += 0.3 * ((a * yy + b * xx) / max(h, w) > c0 * 0.5).float()
    img = (img - img.amin()) / (img.amax() - img.amin() + 1e-6)
    return (img[0].permute(1, 2, 0) * 255).round().to(torch.uint8).numpy()


class SeededNoise:
    """A sampler's noise source: one ``torch.Generator`` seeded with
    ``seed`` on ``device``; ``init``, ``step`` and ``margin`` each draw a
    float32 standard normal of the given shape, in call order. The reference
    makes a second one with the same seed and draws the same shapes in the
    same order, so both sides see the same noise."""

    def __init__(self, seed: int, device):
        import torch
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            int(seed) % SEED_MOD)

    def _draw(self, shape):
        import torch
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.float32)

    def init(self, shape):
        return self._draw(shape)

    def step(self, i, shape):
        return self._draw(shape)

    def margin(self, i, shape):
        return self._draw(shape)


# ---------------------------------------------------------------------------
# Environment and device
# ---------------------------------------------------------------------------

def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's nvcc library is built into ``build/srgd_tpu_torch/`` by its own
    rule; Triton, where anything loads it, and PyTorch's extensions here)."""
    build = CHECKOUT / 'build'
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def forbidden_modules(modules=None) -> list:
    """Modules of JAX or of the JAX package in this process (or among the
    names ``modules``), compared by whole top-level name."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def device_info(torch, count: int) -> dict:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count, 'memory_peak_bytes': int(peak)}


# ---------------------------------------------------------------------------
# The traced run's record
# ---------------------------------------------------------------------------

class Record:
    """What a traced run collects for the per-layer readers: ``spans``
    (name -> list of (ms, rows)), ``counters`` (name -> number), the
    profiler's device ``rows`` ((ms, count, kernel key), summed over the
    profiled part), ``forwards`` ((tile batch, {kernel key: ms}) of each
    forward the profiled part holds whole), ``busy_s``, ``window_s`` and
    ``breakdown`` of that part."""

    def __init__(self):
        self.spans: dict = {}
        self.counters: dict = {}
        self.rows: list = []
        self.forwards: list = []
        self.busy_s = None
        self.window_s = None
        self.breakdown = None

    def span(self, name: str, ms: float, rows: int = 0) -> None:
        self.spans.setdefault(name, []).append((ms, rows))

    def count(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value


class CudaSpans:
    """CUDA-event spans around calls into a layer: ``wrap(fn, name,
    rows_of)`` returns fn with an event pair around each call, resolved
    after the window (``flush``) into ``record``."""

    def __init__(self, torch, record: Record):
        self.torch, self.record, self.pending = torch, record, []

    def wrap(self, fn, name: str, rows_of=lambda *a, **k: 0):
        torch = self.torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pending.append((name, start, end, rows_of(*args, **kw)))
            return out
        return timed

    def flush(self) -> None:
        self.torch.cuda.synchronize()
        for name, s, e, rows in self.pending:
            self.record.span(name, s.elapsed_time(e), rows)
        self.pending = []


def note(opts: dict, what: str) -> None:
    """A set-up mark on standard error: seconds since the process began."""
    if 't_start' in opts:
        print(f'[{time.perf_counter() - opts["t_start"]:8.2f} s] {what}',
              file=sys.stderr, flush=True)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics;
    infinite values (failed requests) sort last."""
    v = sorted(values)
    if not v:
        return math.inf
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (k - lo)
