"""The port's spans (``srgd_tpu_torch.utils.profiling``): one entry a step
for each phase of the training step, one a request for each stage of the
daemon, bounded rings, ranges a profiler session sees, and the benchmark's
readers of them."""

from __future__ import annotations

import http.client
import io
import json
import statistics
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from srgd_tpu_torch.utils import profiling
from srgd_tpu_torch.utils.profiling import PhaseTimer, Spans

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

STEP_SPANS = ('train.forward', 'train.backward', 'train.optimizer',
              'train.ema')
TINY = dict(model='conditional_continuous', unet_dim=16,
            ddpm_unet_dim_mults='1,2', full_attn='False,True',
            learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
            hr_image_size=16, lr_image_size=4, batch_size=2, num_workers=1,
            epochs=1, warmup_epochs=0, ema_decay=0.9, seed=0, lr=1e-3,
            min_lr=1e-5)


def _batches(n):
    rng = np.random.default_rng(0)
    for _ in range(n):
        yield (rng.integers(0, 255, (2, 16, 16, 3), dtype=np.uint8),
               rng.integers(0, 255, (2, 16, 16, 3), dtype=np.uint8),
               np.array([0, 2], np.int64))


def _add(spans, name, seconds, id=None):
    t = spans.trace(id)
    t.add(name, seconds)
    t.end()


def _step(spans):
    from srgd_tpu_torch.config import Config
    from srgd_tpu_torch.factory import build_wrapper
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    from srgd_tpu_torch.train import trainer
    conf = Config(**TINY)
    net = build_unet_from_config(conf)
    net.init_weights(torch.Generator().manual_seed(3))
    wrapper = build_wrapper(conf, net)
    live = trainer.trainable_params(wrapper)
    state = trainer.create_train_state(
        live, trainer.make_optimizer(conf, live, steps_per_epoch=4))
    return state, trainer.make_train_step(wrapper, 0.9, True, conf.seed,
                                          spans=spans)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def test_rings_stop_at_their_capacity():
    spans = Spans(capacity=4)
    for k in range(10):
        _add(spans, 'x', 0.5 + k, id=k)
    ring = spans.ring('x')
    assert [e.id for e in ring] == [6, 7, 8, 9]
    assert [e.seconds for e in ring] == [6.5, 7.5, 8.5, 9.5]
    assert spans.counts['x'] == 10
    assert spans.totals['x'] == pytest.approx(sum(0.5 + k for k in range(10)))
    timer = PhaseTimer(capacity=3)
    for k in range(5):
        with timer.phase('step', id=k):
            pass
    assert len(timer.durations['step']) == 3 and timer.counts['step'] == 5
    assert 'step:' in timer.report()
    assert profiling.SPANS.capacity == profiling.RING == 4096


def test_a_trace_sums_its_intervals_and_writes_when_ended():
    spans = Spans()
    trace = spans.trace(7)
    with trace('a'):
        time.sleep(0.01)
    trace.add('a', 1.0)
    trace.add('b', 2.0)
    assert spans.ring('a') == []            # nothing before the end
    trace.end()
    (a,), (b,) = spans.ring('a'), spans.ring('b')
    assert a.id == b.id == 7 and 1.01 <= a.seconds < 1.5 and b.seconds == 2.0
    spans.trace(8).add('a', 1.0)            # never ended: never written
    assert spans.counts['a'] == 1


class _FakeEvent:
    """Stands in for a CUDA event: ``done`` says whether the device reached
    it; ``synchronize`` waits for it."""

    def __init__(self, at):
        self.at, self.done = at, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def test_device_spans_are_written_in_order_once_their_events_complete():
    """A trace whose events have not completed holds back the traces that
    ended after it; reading a ring waits for them."""
    spans = Spans()
    first, second = spans.trace(0), spans.trace(1)
    events = []
    for t, (a, b) in ((first, (0.0, 0.25)), (second, (1.0, 1.5))):
        start, end = _FakeEvent(a), _FakeEvent(b)
        t.events.append(('train.forward', start, end))
        events.append(end)
    events[1].done = True
    first.end()
    second.end()
    assert 'train.forward' not in spans.counts      # the first is pending
    events[0].done = True
    spans._resolve()
    assert [e.id for e in spans.rings['train.forward']] == [0, 1]
    assert spans.totals['train.forward'] == pytest.approx(0.75)
    third = spans.trace(2)
    third.events.append(('train.forward', _FakeEvent(2.0), _FakeEvent(2.5)))
    third.end()
    assert spans.counts['train.forward'] == 2
    assert [e.id for e in spans.ring('train.forward')] == [0, 1, 2]


def test_a_timer_survives_pickling():
    import pickle
    timer = PhaseTimer()
    with timer.phase('step', id=0):
        pass
    back = pickle.loads(pickle.dumps(timer))
    assert back.counts['step'] == 1 and len(back.durations['step']) == 1
    with back.phase('step', id=1):
        pass
    assert back.counts['step'] == 2


def test_spans_appear_as_host_ranges_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    spans = Spans()
    state, step = _step(spans)
    hr, cond, label = next(_batches(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, torch.from_numpy(hr), torch.from_numpy(cond),
             torch.from_numpy(label))
        with spans.span('serve.decode', 0):
            torch.zeros(4).add_(1)
    names = {e.name for e in prof.events()}
    assert set(STEP_SPANS) | {'serve.decode'} <= names


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

def test_train_step_writes_one_entry_per_span_and_step():
    """Two dim-16 steps fed by the device prefetcher: each phase and the
    data wait hold one entry a step, under the step's index; no mesh
    span without a mesh."""
    from srgd_tpu_torch.train.loop import _DevicePrefetcher
    spans = Spans()
    state, step = _step(spans)
    feed = _DevicePrefetcher(_batches(2), torch.device('cpu'), spans=spans)
    try:
        for _ in range(2):
            hr, cond, label = next(feed)
            step(state, hr, cond, label)
    finally:
        feed.close()
    for name in STEP_SPANS + ('train.data_wait',):
        ring = spans.ring(name)
        assert [e.id for e in ring] == [0, 1], name
        assert spans.counts[name] == 2
        assert all(e.seconds > 0 for e in ring), name
    assert 'train.mesh' not in spans.counts
    assert state.step == 2


def test_train_loop_reports_its_steps_spans(tmp_path, monkeypatch):
    """``train.loop``'s timer holds the steps' spans beside its phases,
    from a resumed step's index on, and its report lists them."""
    import srgd_tpu_torch.train.data as tdata
    from srgd_tpu_torch.config import Config
    from srgd_tpu_torch.train.loop import train

    class ConstData:
        def __init__(self, *a, **kw):
            pass

        def __iter__(self):
            batch = next(_batches(1))
            while True:
                yield batch

    monkeypatch.setattr(tdata, 'DegradationDataset', ConstData)
    conf = Config(**dict(TINY, unet_dim=8))
    state = train(conf, str(tmp_path), str(tmp_path / 'run'), total_steps=2,
                  log_every=1, save_every=2, device='cpu')
    for name in STEP_SPANS + ('train.data_wait', 'step'):
        assert state.timer.counts[name] == 2, name
    report = state.timer.report()
    assert 'train.backward:' in report and 'train.data_wait:' in report
    state = train(conf, str(tmp_path), str(tmp_path / 'run'), total_steps=3,
                  log_every=1, save_every=2, device='cpu')
    assert [e.id for e in state.timer.ring('train.forward')] == [2]
    assert [e.id for e in state.timer.ring('train.data_wait')] == [2]


# ---------------------------------------------------------------------------
# The daemon
# ---------------------------------------------------------------------------

def test_batcher_times_each_requests_waits_and_numbers_its_batch():
    """A head waits about the window, a member that came later less, both
    in one batch; a request that comes during a sample waits in the queue
    for its end; each batch's close is counted by its reason."""
    from srgd_tpu_torch.serve import BatchingQueue
    window, sample_s = 0.3, 0.2

    def slow(conds, labels):
        time.sleep(sample_s)
        return np.repeat(conds, 4, axis=1).repeat(4, axis=2)

    bq = BatchingQueue(slow, window=window, max_images=4)
    traces = [profiling.SPANS.trace(k) for k in range(3)]
    cond = np.zeros((1, 8, 8, 3), np.float32)

    def go(k):
        bq.submit(cond, 0, traces[k])

    threads = [threading.Thread(target=go, args=(k,)) for k in range(3)]
    try:
        threads[0].start()
        time.sleep(0.1)
        threads[1].start()
        time.sleep(window - 0.1 + sample_s / 2)     # inside the sample
        threads[2].start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        bq.shutdown()
    head, member, late = (t.host for t in traces)
    assert window - 0.02 <= head['serve.coalesce_wait'] <= window + 0.25
    assert member['serve.coalesce_wait'] < head['serve.coalesce_wait'] - 0.05
    assert head['serve.queue_wait'] < 0.1 and member['serve.queue_wait'] < 0.1
    assert sample_s / 2 - 0.05 <= late['serve.queue_wait'] <= sample_s + 0.2
    assert late['serve.coalesce_wait'] >= window - 0.02
    for t in (head, member, late):
        assert sample_s - 0.01 <= t['serve.sample'] <= sample_s + 0.25
    assert traces[0].batch == traces[1].batch == 0 and traces[2].batch == 1
    assert bq.stats['batches_closed_deadline'] == 2

    full = BatchingQueue(lambda c, l: c, window=30.0, max_images=1)
    try:
        full.submit(cond, 0)
        full.submit(np.zeros((1, 4, 4, 3), np.float32), 0)
    finally:
        full.shutdown()
    assert full.stats['batches_closed_full'] == 2

    mixed = BatchingQueue(slow, window=0.5, max_images=4)
    shapes = [(1, 8, 8, 3), (1, 4, 4, 3)]
    threads = [threading.Thread(target=mixed.submit, args=(
        np.zeros(s, np.float32), 0)) for s in shapes]
    try:
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        mixed.shutdown()
    assert mixed.stats['batches_closed_mismatch'] == 1
    assert mixed.stats['batches_closed_deadline'] == 1


class _EchoSampler:
    def sample(self, conds, labels, seed, guidance=None):
        time.sleep(0.02)
        return conds + np.asarray(labels).reshape(-1, 1, 1, 1) / 255.0


@pytest.fixture
def stub_http(tmp_path):
    """A daemon over a stand-in sampler, with its batcher, through HTTP."""
    from srgd_tpu_torch.serve import BatchingQueue, Server, parse_args
    srv = object.__new__(Server)
    srv.args = parse_args(['-c', 'unused', '-m', '', '--mode', 'http',
                           '--port', '0', '--lr_bucket', '8',
                           '--coalesce_window', '0.05', '--test_label', '1'])
    srv.stop = threading.Event()
    srv.stats = {'served': 0, 'errors': 0, 'mpix': 0.0,
                 'sample_seconds': 0.0, 'started': time.time()}
    srv.stats_lock = threading.Lock()
    srv.quarantined = {}
    srv.sampler = _EchoSampler()
    srv.lock = threading.Lock()
    srv._sample_started = None
    srv.model_info = {'mesh': None}
    srv.batcher = BatchingQueue(srv._sample_batch, 0.05, 4)
    httpd = srv.make_http_server()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection('127.0.0.1', httpd.server_address[1],
                                      timeout=60)
    try:
        yield srv, conn
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        srv.batcher.shutdown()


def _post(conn, query=''):
    """One request; returns once the handler wrote its spans, which it does
    after its response is out."""
    before = profiling.SPANS.counts.get('serve.total', 0)
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (6, 7, 3)).astype(np.uint8)).save(buf, format='PNG')
    conn.request('POST', '/v1/sr' + query, body=buf.getvalue())
    r = conn.getresponse()
    assert r.status == 200
    r.read()
    deadline = time.time() + 10
    while profiling.SPANS.counts.get('serve.total', 0) == before:
        assert time.time() < deadline
        time.sleep(0.005)


def _entries_of_last_request():
    total = profiling.SPANS.ring('serve.total')[-1]
    out = {}
    for stage in ('decode', 'prepare', 'queue_wait', 'coalesce_wait',
                  'sample', 'encode'):
        hits = [e for e in profiling.SPANS.ring(f'serve.{stage}')
                if e.id == total.id]
        assert len(hits) <= 1
        if hits:
            out[stage] = hits[0]
    return total, out


def test_an_http_requests_total_covers_its_stages(stub_http):
    srv, conn = stub_http
    _post(conn)
    total, stages = _entries_of_last_request()
    assert set(stages) == {'decode', 'prepare', 'queue_wait',
                           'coalesce_wait', 'sample', 'encode'}
    inside = sum(e.seconds for e in stages.values())
    assert inside <= total.seconds
    assert total.seconds - inside < 0.03 + 0.05 * total.seconds
    assert stages['sample'].batch is not None
    assert stages['coalesce_wait'].seconds >= 0.04   # the 0.05 s window

    _post(conn, '?seed=3')                           # runs alone
    total, stages = _entries_of_last_request()
    assert set(stages) == {'decode', 'prepare', 'sample', 'encode'}
    assert stages['sample'].seconds >= 0.02


def test_stats_and_metrics_show_the_stages_and_close_reasons(stub_http):
    from srgd_tpu_torch.serve import STAGES
    srv, conn = stub_http
    before = srv.stats_snapshot()
    _post(conn)
    conn.request('GET', '/stats')
    stats = json.loads(conn.getresponse().read())
    for stage in STAGES:
        assert stats[f'serve_{stage}_count'] == \
            before[f'serve_{stage}_count'] + 1, stage
        assert stats[f'serve_{stage}_seconds'] > \
            before[f'serve_{stage}_seconds'], stage
    assert stats['batches_closed_deadline'] == 1
    assert stats['batches_closed_full'] == stats[
        'batches_closed_mismatch'] == 0
    assert {'served', 'errors', 'mpix', 'sample_seconds', 'batches',
            'batched_images'} <= set(stats)
    conn.request('GET', '/metrics')
    metrics = conn.getresponse().read().decode()
    parsed = {line.split()[0]: float(line.split()[1])
              for line in metrics.splitlines() if not line.startswith('#')}
    for key in ('serve_total_seconds', 'serve_queue_wait_count',
                'batches_closed_deadline', 'batches_closed_full',
                'batches_closed_mismatch'):
        assert f'# TYPE srgd_{key} counter' in metrics
    assert parsed['srgd_serve_sample_count'] == stats['serve_sample_count']
    assert parsed['srgd_batches_closed_deadline'] == 1


def test_a_failed_request_writes_no_spans(stub_http):
    srv, conn = stub_http
    before = profiling.SPANS.counts.get('serve.total', 0)
    conn.request('POST', '/v1/sr', body=b'not a png')
    r = conn.getresponse()
    assert r.status == 400
    r.read()
    assert profiling.SPANS.counts.get('serve.total', 0) == before


def test_the_warm_up_writes_no_request_spans(stub_http):
    srv, conn = stub_http
    srv.args.warmup_sizes = '8,16'
    before = dict(profiling.SPANS.counts)
    srv.warmup()
    assert dict(profiling.SPANS.counts) == before
    assert srv.stats['served'] == 0


def test_watched_files_write_their_stages_without_waits_or_total(stub_http):
    """A watch batch: each file gets ``prepare``, the batch's one
    ``sample`` and ``encode``, under an id of its own; no HTTP stage and no
    batcher wait."""
    srv, conn = stub_http
    rng = np.random.RandomState(1)
    images = [Image.fromarray(rng.randint(0, 255, (6, 7, 3)).astype(
        np.uint8)) for _ in range(2)]
    before = dict(profiling.SPANS.counts)
    srs = srv._batched_super_resolve(images)
    assert [im.size for im in srs] == [(28, 24), (28, 24)]
    after = profiling.SPANS.counts
    for stage in ('prepare', 'sample', 'encode'):
        assert after[f'serve.{stage}'] == \
            before.get(f'serve.{stage}', 0) + 2, stage
    for stage in ('decode', 'queue_wait', 'coalesce_wait', 'total'):
        assert after.get(f'serve.{stage}', 0) == \
            before.get(f'serve.{stage}', 0), stage
    samples = profiling.SPANS.ring('serve.sample')[-2:]
    encodes = profiling.SPANS.ring('serve.encode')[-2:]
    assert samples[0].id != samples[1].id
    assert [e.id for e in encodes] == [e.id for e in samples]
    assert samples[0].seconds == samples[1].seconds >= 0.02


def test_a_request_of_another_geometry_waits_for_the_batch_it_closed():
    """The request that closes a batch by its canvas shape waits in the
    queue's place through that batch's sample, then heads the next batch
    and waits out a window of its own."""
    from srgd_tpu_torch.serve import BatchingQueue
    window, sample_s = 0.3, 0.2

    def slow(conds, labels):
        time.sleep(sample_s)
        return conds

    bq = BatchingQueue(slow, window=window, max_images=4)
    traces = [profiling.SPANS.trace(k) for k in range(2)]
    shapes = [(1, 8, 8, 3), (1, 4, 4, 3)]
    threads = [threading.Thread(target=bq.submit, args=(
        np.zeros(s, np.float32), 0, t)) for s, t in zip(shapes, traces)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        bq.shutdown()
    head, other = (t.host for t in traces)
    assert head['serve.coalesce_wait'] < 0.2        # closed by the other
    assert other['serve.queue_wait'] >= sample_s - 0.01
    assert other['serve.coalesce_wait'] >= window - 0.02
    assert traces[0].batch == 0 and traces[1].batch == 1
    assert bq.stats['batches_closed_mismatch'] == 1
    assert bq.stats['batches_closed_deadline'] == 1


# ---------------------------------------------------------------------------
# The benchmark's readers of the spans
# ---------------------------------------------------------------------------

TRAIN_READERS = {'forward_ms.train': 'train.forward',
                 'backward_ms.train': 'train.backward',
                 'optimizer_ms.train': 'train.optimizer',
                 'ema_ms.train': 'train.ema'}


def _reader(name):
    from perfbench import harness
    return harness.metric_reader(name).read


@pytest.mark.parametrize('name', TRAIN_READERS)
def test_a_reader_reads_nothing_without_its_counters_or_entries(
        name, monkeypatch):
    from perfbench import harness
    spans = Spans()
    monkeypatch.setattr(profiling, 'SPANS', spans)
    assert _reader(name)(harness.Record()) is None
    record = harness.Record()
    record.counters.update(steps=3)
    for k in range(2):                  # fewer entries than it needs
        t = spans.trace(k)
        for span in STEP_SPANS:
            t.add(span, 0.1)
        t.end()
    assert _reader(name)(record) is None


@pytest.mark.parametrize('name', TRAIN_READERS)
def test_a_train_reader_takes_the_median_of_the_last_steps(name,
                                                           monkeypatch):
    from perfbench import harness
    spans = Spans()
    monkeypatch.setattr(profiling, 'SPANS', spans)
    for k, s in enumerate((9.0, 9.0, 0.1, 0.4, 0.3, 0.2, 5.0)):
        _add(spans, TRAIN_READERS[name], s, id=k)
    record = harness.Record()
    record.counters['steps'] = 5
    assert _reader(name)(record) == pytest.approx(
        statistics.median((0.1, 0.4, 0.3, 0.2, 5.0)) * 1e3)
