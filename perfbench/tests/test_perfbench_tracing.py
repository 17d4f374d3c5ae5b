"""The traced run's reduction of profiler events (fake events here) and the
per-layer readers."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, tracing  # noqa: E402
from perfbench.counts import formulas  # noqa: E402


def ev(name, start, end, cuda=True):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if cuda
                           else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end))


def pads(n):
    return [ev('void spin_kernel(long)', i, i + 0.5) for i in range(n)]


OPEN = 'void at::native::vectorized_elementwise_kernel<4, ' \
    'at::native::FillFunctor<double>, std::array<char*, 1ul> >(int)'
CLOSE = OPEN.replace('double', 'short')


def marked(batch, start, kernels, end):
    """A forward of ``batch`` tiles as ForwardMarks leaves it on the
    device's timeline: batch + 1 opening marks from ``start``, its
    kernels, a closing mark at ``end``."""
    return ([ev(OPEN, start + 0.3 * j, start + 0.3 * j + 0.2)
             for j in range(batch + 1)] + kernels + [ev(CLOSE, end, end + 0.2)])


KERNELS = marked(8, 70, [ev('Optimizer.step#Adam.step', 90, 420),
           ev('Optimizer.step#Adam.step', 80, 430, cuda=False),
           ev('void (anonymous namespace)::phase_b_mma<128>(Args)', 100, 300),
           ev('void at::native::elementwise_kernel<4>(int)', 250, 400),
           ev('sm90_xmma_fprop_implicit_gemm_bf16_cudnn', 500, 600),
           ev('aten::conv2d', 420, 480, cuda=False)], 650)


def test_reduction_leaves_out_the_pad_and_counts_what_it_lost():
    rec = harness.Record()
    tracing.reduce_events(pads(60) + KERNELS, 0.001, rec)
    assert rec.counters['records_lost_at_session_start'] == 4
    assert [r[1] for r in rec.rows] == [1, 1, 1]
    assert rec.busy_s == pytest.approx(400e-6)          # 100-400, 500-600
    assert rec.breakdown['idle_gaps'][0] == ['aten::conv2d',
                                             pytest.approx(100e-6)]
    assert rec.breakdown['device_ops'][0][0] == 'phase_b_mma'


def test_a_session_that_lost_its_whole_pad_fails():
    with pytest.raises(RuntimeError, match='dropped all'):
        tracing.reduce_events(KERNELS, 0.001, harness.Record())


def reader(name):
    return harness.metric_reader(name).read


def test_readers_on_an_empty_record_read_nothing():
    spec = harness.benchmark()
    for m in spec['per_layer']:
        assert reader(m['name'])(harness.Record()) is None, m['name']


def test_readers_on_a_filled_record():
    rec = harness.Record()
    tracing.reduce_events(pads(64) + KERNELS, 0.0005, rec)
    assert rec.counters['profiled_batches'] == [8]
    rec.counters.update(steps=2, window_s=1.0, real_tiles=145, chips=1)
    rec.span('forward', 300.0, 8)
    rec.span('forward', 100.0, 8)
    assert reader('forward_ms.offline')(rec) == 200.0
    assert reader('sampler_ms.offline')(rec) == 300.0
    assert reader('torch_ops_ms.offline')(rec) == pytest.approx(0.15)
    assert reader('device_idle.offline')(rec) == pytest.approx(20.0)
    bound = formulas.forward_bound_s('linattn_block', 8) * 1e3
    assert reader('linattn_block_roofline.offline')(rec) == \
        pytest.approx(bound / 0.2 * 100)
    mfu = 145 * formulas.unet_counts()['model_flops_per_tile'] / 989e12 * 100
    assert reader('step_mfu.offline')(rec) == pytest.approx(mfu)
    rec.counters.update(batches=4, batched_images=22, steps_per_sample=25)
    rec.span('sample', 2000.0, 8)
    assert reader('images_per_batch.serve')(rec) == 5.5
    rec.span('data_wait', 3.0)
    rec.span('data_wait', 5.0)
    assert reader('data_wait_ms.train')(rec) == 4.0
    for ms in (250.0, 10.0, 400.0):
        rec.span('serve.queue_wait', ms)
    for ms in (500.0, 0.5, 300.0, 100.0):
        rec.span('serve.coalesce_wait', ms)
    rec.counters['request_p90_ms'] = 1800.0
    assert reader('request_p90_ms.serve')(rec) == 1800.0
    assert reader('queue_wait_ms.serve')(rec) == 250.0
    assert reader('coalesce_wait_ms.serve')(rec) == 200.0
    assert reader('step_mfu.serve')(rec) == pytest.approx(
        8 * 25 * formulas.unet_counts()['model_flops_per_tile']
        / (2.0 * 989e12) * 100)


def test_forwards_are_told_apart_by_their_marks():
    conv = 'void int8_conv_wgmma<128>(Params)'
    gn = 'void at::native::elementwise_kernel<4>(int)'
    events = (
        # began before the session's pad ended: its opening run may be cut
        marked(8, 10, [ev(conv, 80, 81)], 82)
        + pads(64)
        + marked(3, 100, [ev(conv, 110, 112), ev(gn, 112, 113)], 120)
        + marked(6, 200, [ev(conv, 210, 215)], 220)
        # a stray opening mark inside: left out whole
        + marked(2, 300, [ev(conv, 310, 311), ev(OPEN, 312, 312.1),
                          ev(conv, 313, 314)], 320)
        # the session closed before this one did
        + [ev(OPEN, 400, 400.1), ev(OPEN, 401, 401.1), ev(conv, 402, 403)])
    rec = harness.Record()
    tracing.reduce_events(events, 0.001, rec)
    assert rec.counters['profiled_batches'] == [3, 6]
    assert [seg for _, seg in rec.forwards] == [
        {conv: pytest.approx(0.002), gn: pytest.approx(0.001)},
        {conv: pytest.approx(0.005)}]
    assert not any('FillFunctor' in r[2] for r in rec.rows)
    bound = (formulas.forward_bound_s('int8_conv', 3)
             + formulas.forward_bound_s('int8_conv', 6)) * 1e3
    assert reader('int8_conv_roofline.serve')(rec) == \
        pytest.approx(bound / 0.007 * 100)


def test_traced_serve_run_profiles_only_after_its_window(monkeypatch):
    """The profiler opens, closes and reduces its events only once the
    window's load generator has finished, on a segment of the same traffic
    that follows; the record holds the window's own spans (the daemon's
    waits, one a request; the samples' span, the window's alone) and the
    batches' fill of the window, the segment's lead-in and the profiled
    part; under load the sampling thread has a CPU of its own."""
    import time

    from perfbench.run import judge
    from perfbench.tests.test_perfbench_faults import SEED, tiny_cell
    cell, overrides, seconds = tiny_cell('serve-lr64-w8a8')
    cell['traffic_data'].update(profile_after_s=0.5, profile_s=0.5)
    drv = harness.driver('daemon_http')
    events, pinned = [], []
    plain_finish = drv.finish_load
    cpus = sorted(os.sched_getaffinity(0))

    def thread_cpus():
        return sorted(sorted(os.sched_getaffinity(int(t)))
                      for t in os.listdir('/proc/self/task'))

    def finish(proc, timeout):
        out = plain_finish(proc, timeout)
        events.append(('load finished', len(out['results'])))
        pinned.append(thread_cpus())
        return out

    def profiled(torch, work, record):
        events.append(('profiler opened', None))
        work()
        events.append(('profiler closed', None))
        # what tracing.profiled writes besides
        record.busy_s, record.window_s = 0.1, 0.5
        record.counters.update(profiled_batches=[1], profiled_forwards=1)

    monkeypatch.setattr(drv, 'finish_load', finish)
    monkeypatch.setattr(tracing, 'profiled', profiled)
    out = drv.run(cell, dict(seed=SEED, seconds=seconds, trace=True,
                             device='cpu', t_start=time.perf_counter(),
                             overrides=overrides))
    assert [e for e, _ in events] == ['load finished', 'profiler opened',
                                      'profiler closed', 'load finished']
    assert events[0][1] == out['attempted'] and out['failed'] == 0
    assert judge(out['checks'], cell['limits'])[0], out['checks']
    rec = out['record']
    for name in ('serve.queue_wait', 'serve.coalesce_wait'):
        assert len(rec.spans[name]) == out['attempted']
    assert reader('queue_wait_ms.serve')(rec) is not None
    assert reader('coalesce_wait_ms.serve')(rec) is not None
    assert reader('request_p90_ms.serve')(rec) >= out['e2e']['request_p50_ms']
    assert sum(n for _, n in rec.spans['sample']) == \
        rec.counters['batched_images'] == out['attempted']
    # under load the sampling thread had a CPU of its own, every other
    # thread the rest; afterwards every thread is back on every CPU
    if len(cpus) >= 3:
        for got in pinned:
            assert [cpus[-1:]] == [c for c in got if c != cpus[:-1]]
    assert all(c == cpus for c in thread_cpus())
    # the batches' fill before and in the profiled part, to set beside the
    # window's
    for k in ('batches', 'batched_images', 'batches_closed_full',
              'batches_closed_deadline'):
        assert k in rec.counters and rec.counters[f'traced_{k}'] >= 0 \
            and rec.counters[f'lead_{k}'] >= 0
