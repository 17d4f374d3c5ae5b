"""The traced run's reduction of profiler events (fake events here) and the
per-layer readers."""

from __future__ import annotations

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
