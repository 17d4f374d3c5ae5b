"""The port's serving daemon (``srgd_tpu_torch.serve``) on the CPU.

Against the JAX package: one ``srgd_tpu.serve.Server`` and one port
``Server`` load the same reference-format ``.pth`` (seeded JAX params through
``export_torch_state_dict``), and the port replays the JAX key schedule
(``tests/test_torch_sampler.JaxKeyNoise``): a seeded labelled request, a
coalesced two-canvas batch with labels (0, 1) and a guided request agree
within the sampler bar of ``tests/test_e2e_parity.py`` (max error < 5e-4,
PSNR > 60 dB) and their PNGs within 1/255; the bucketing helpers are
bit-equal to the JAX ones.

The port's own contract mirrors ``tests/test_serve.py`` test for test, on a
port server with random weights: coalescing, error propagation, submit after
shutdown, watch grouping, quarantine and retry, the watch pass, the HTTP
endpoints with stall detection, warmup counters and per-request guidance;
the JAX file's int8 test runs on the port, and a calibrated int8 daemon
restarts from its calibration cache.
"""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from srgd_tpu import serve as jserve
from srgd_tpu.checkpoint.torch_convert import export_torch_state_dict
from srgd_tpu.infer import pending_outputs as jax_pending_outputs
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch import infer as tinfer
from srgd_tpu_torch.serve import (
    BatchingQueue, Server, bucket_crop, bucket_pad, parse_args)
from tests.test_torch_sampler import JaxKeyNoise, assert_golden

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_YAML = """
model: conditional_continuous
noise_schedule: linear
unet_dim: 16
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 8
num_classes: 3
image_size: 16
"""

# both daemons: float32, 2 steps, 16-px tiles, a tile batch of 4
SAMPLING = ['--num_sample_steps', '2', '--tile_size', '16', '--batch_size',
            '4', '--lr_bucket', '8', '--test_label', '0', '--precision',
            'fp32']


def _rand_image(seed, h, w):
    return Image.fromarray((np.random.RandomState(seed).rand(h, w, 3) * 255)
                           .astype(np.uint8))


def _png_bytes(img):
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return buf.getvalue()


@pytest.fixture(scope='module')
def conf(tmp_path_factory):
    path = tmp_path_factory.mktemp('serve_conf') / 'tiny.yaml'
    path.write_text(TINY_YAML)
    return path


# ---------------------------------------------------------------------------
# Against the JAX daemon
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def pair(conf, tmp_path_factory):
    """(JAX Server, port Server) on one .pth, the port replaying JAX keys."""
    params = JaxUnet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                     learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
                     num_classes=3).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
        class_label=jnp.zeros((1,), jnp.int32))['params']
    sd = export_torch_state_dict({'params': params},
                                 model='conditional_continuous')
    ckpt = tmp_path_factory.mktemp('serve_ckpt') / 'tiny.pth'
    torch.save({'ema_model': {k: torch.from_numpy(np.array(v))
                              for k, v in sd.items()}}, ckpt)
    argv = ['-c', str(conf), '-m', str(ckpt), '--mode', 'http', *SAMPLING]
    jax_server = jserve.Server(jserve.parse_args(argv))
    port_server = Server(
        parse_args([*argv, '--device', 'cpu']),
        noise_for_seed=lambda seed, device: JaxKeyNoise(
            jax.random.PRNGKey(seed)))
    return jax_server, port_server


def _conds(images):
    """The daemon's condition canvases: bucketed, x4 bicubic, [0, 1]."""
    return np.concatenate([
        np.asarray(tinfer.upscale_bicubic(bucket_pad(im, 8)[0]),
                   np.float32)[None] / 255.0 for im in images])


# case -> (sample call on a Server, super_resolve keywords or None)
PARITY = {
    'seeded': (lambda s, c: s._timed_sample(c[:1], 1, 5),
               dict(seed=5, test_label=1)),
    'coalesced': (lambda s, c: s._sample_batch(c, np.asarray([0, 1],
                                                              np.int32)),
                  None),
    'guided': (lambda s, c: s._timed_sample(
        c[:1], 1, 5, guidance={'class_cond_scale': 2.0}),
        dict(seed=5, test_label=1, class_cond_scale=2.0)),
}


@pytest.mark.parametrize('case', sorted(PARITY))
def test_server_matches_jax(pair, case):
    jax_server, port_server = pair
    images = [_rand_image(10, 6, 7), _rand_image(11, 6, 7)]
    run, request = PARITY[case]
    conds = _conds(images)
    want, got = run(jax_server, conds), run(port_server, conds)
    assert got.shape == want.shape == (len(got), 32, 32, 3)
    assert_golden(got, np.asarray(want))
    if request is not None:
        want_png = np.asarray(jax_server.super_resolve(images[0], **request))
        got_png = np.asarray(port_server.super_resolve(images[0], **request))
        assert got_png.shape == want_png.shape == (24, 28, 3)
        assert np.abs(got_png.astype(int) - want_png).max() <= 1


def test_sampler_label_array_and_guidance_match_jax(pair):
    """``Sampler.sample`` takes a per-canvas label array and a per-call
    guidance override as ``SamplerCache.sample`` does (the shapes and scales
    of the cases above, so JAX compiles nothing new); an int label is the
    array of that label on every canvas."""
    jax_server, port_server = pair
    conds = _conds([_rand_image(12, 6, 7), _rand_image(13, 6, 7)])
    for cond, labels, guidance in (
            (conds, np.asarray([2, 0], np.int32), None),
            (conds[:1], np.asarray([1]), {'class_cond_scale': 2.0})):
        want = jax_server.sampler.sample(cond, labels, 9, guidance=guidance)
        got = port_server.sampler.sample(cond, labels, 9, guidance=guidance)
        assert_golden(got, np.asarray(want))
    # the override is for that call only
    assert port_server.sampler.opts['class_cond_scale'] == 1.0
    np.testing.assert_array_equal(
        port_server.sampler.sample(conds, 1, 9),
        port_server.sampler.sample(conds, np.asarray([1, 1]), 9))


@pytest.mark.parametrize('hw, bucket', [((10, 13), 8), ((16, 16), 8),
                                        ((5, 3), 4), ((9, 9), 0),
                                        ((20, 7), 64)])
def test_bucket_helpers_equal_jax(hw, bucket):
    img = _rand_image(sum(hw), *hw)
    got, got_orig = bucket_pad(img, bucket)
    want, want_orig = jserve.bucket_pad(img, bucket)
    assert got_orig == want_orig and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    fake_sr = got.resize((got.size[0] * 4, got.size[1] * 4))
    np.testing.assert_array_equal(
        np.asarray(bucket_crop(fake_sr, got_orig)),
        np.asarray(jserve.bucket_crop(fake_sr, want_orig)))


def test_pending_outputs_prints_skip_only_when_asked(tmp_path, capsys):
    """The watch pass polls: it must not print 'skip' for every finished
    file; the batch CLI asks for the reference's print."""
    (tmp_path / 'in').mkdir()
    (tmp_path / 'out').mkdir()
    for name in ('a.png', 'b.png'):
        (tmp_path / 'in' / name).write_bytes(b'')
    (tmp_path / 'out' / 'a_out.png').write_bytes(b'')
    args = (str(tmp_path / 'in'), str(tmp_path / 'out'))
    for verbose in (False, True):
        got = list(tinfer.pending_outputs(*args, verbose_skip=verbose))
        printed = capsys.readouterr().out
        want = list(jax_pending_outputs(*args, verbose_skip=verbose))
        assert printed == capsys.readouterr().out == (
            'skip\n' if verbose else '')
        assert got == want == [(str(tmp_path / 'in' / 'b.png'),
                                str(tmp_path / 'out' / 'b_out.png'))]
    assert list(tinfer.pending_outputs(*args)) == got
    assert capsys.readouterr().out == ''


# ---------------------------------------------------------------------------
# The port's own contract, mirroring tests/test_serve.py
# ---------------------------------------------------------------------------

def test_bucket_pad_and_crop_roundtrip():
    img = _rand_image(0, 10, 13)
    padded, orig = bucket_pad(img, 8)
    assert padded.size == (16, 16)       # PIL size is (w, h)
    assert orig == (13, 10)
    np.testing.assert_array_equal(np.asarray(padded)[:10, :13],
                                  np.asarray(img))
    cropped = bucket_crop(padded.resize((64, 64)), orig)
    assert cropped.size == (13 * 4, 10 * 4)


def test_bucket_pad_noop_when_aligned():
    img = Image.fromarray(np.zeros((16, 16, 3), np.uint8))
    padded, orig = bucket_pad(img, 8)
    assert padded is img and orig == (16, 16)
    padded, orig = bucket_pad(img, 0)
    assert padded is img


def test_batching_queue_coalesces_same_geometry():
    calls = []

    def fake_sample(conds, labels):
        calls.append((conds.shape, None if labels is None else list(labels)))
        time.sleep(0.05)
        return np.repeat(conds, 4, axis=1).repeat(4, axis=2)

    bq = BatchingQueue(fake_sample, window=0.4, max_images=4)
    try:
        conds = [np.full((1, 8, 8, 3), i, np.float32) for i in range(3)]
        outs = [None] * 3

        def go(i):
            outs[i] = bq.submit(conds[i], i)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for i in range(3):
            assert outs[i].shape == (32, 32, 3)
            np.testing.assert_array_equal(outs[i], np.full((32, 32, 3), i))
        assert bq.stats['batched_images'] == 3
        assert bq.stats['batches'] < 3
        # each canvas kept its own label in the stacked batch
        assert sorted(sum((c[1] for c in calls), [])) == [0, 1, 2]

        out = bq.submit(np.zeros((1, 16, 16, 3), np.float32), None)
        assert out.shape == (64, 64, 3)
        for shape, _labels in calls:
            assert shape[1:] in ((8, 8, 3), (16, 16, 3))
    finally:
        bq.shutdown()


def test_batching_queue_propagates_errors():
    def boom(conds, labels):
        raise RuntimeError('card on fire')

    bq = BatchingQueue(boom, window=0.05, max_images=4)
    try:
        with pytest.raises(RuntimeError, match='card on fire'):
            bq.submit(np.zeros((1, 8, 8, 3), np.float32), None)
    finally:
        bq.shutdown()


def test_batching_queue_submit_after_shutdown_never_hangs():
    """A submit that slips past the stop check while shutdown drains still
    fails promptly instead of blocking forever."""
    bq = BatchingQueue(lambda c, l: c, window=0.01, max_images=2)
    bq.shutdown()
    # the race: stop reads clear at submit's check and flips after the put,
    # with the worker already gone
    bq.stop.clear()
    timer = threading.Timer(0.2, bq.stop.set)
    timer.start()
    t0 = time.time()
    try:
        with pytest.raises(RuntimeError, match='shutting down'):
            bq.submit(np.zeros((1, 8, 8, 3), np.float32), None)
    finally:
        timer.cancel()
        bq.stop.set()
    assert time.time() - t0 < 10
    with pytest.raises(RuntimeError, match='shutting down'):
        bq.submit(np.zeros((1, 8, 8, 3), np.float32), None)


def _stub_watch_server(root, max_failures=3, retry_after_polls=30,
                       max_batch_images=8):
    """A Server with the watch bookkeeping and no model, for
    process_dir_once's grouping and quarantine with a stubbed
    _batched_super_resolve."""
    args = parse_args([
        '-c', 'unused', '-m', '', '--mode', 'watch',
        '--input_dir', str(root / 'in'), '--output_dir', str(root / 'out'),
        '--lr_bucket', '8', '--max_batch_images', str(max_batch_images),
        '--max_failures', str(max_failures),
        '--retry_after_polls', str(retry_after_polls)])
    srv = object.__new__(Server)
    srv.args = args
    srv.stop = threading.Event()
    srv.stats = {'served': 0, 'errors': 0, 'mpix': 0.0,
                 'sample_seconds': 0.0, 'started': time.time()}
    srv.stats_lock = threading.Lock()
    srv.failed_inputs = {}
    srv.quarantined = {}
    srv._poll_index = 0
    return srv


def _fake_sr(images):
    return [Image.fromarray(np.zeros((im.size[1] * 4, im.size[0] * 4, 3),
                                     np.uint8)) for im in images]


def test_watch_groups_interleaved_geometries(tmp_path):
    """An interleaved folder of two geometries samples as two batched
    canvases, each of one geometry."""
    (tmp_path / 'in').mkdir()
    for name, size in [('a.png', 6), ('b.png', 14), ('c.png', 6),
                       ('d.png', 14)]:
        Image.fromarray(np.zeros((size, size, 3), np.uint8)).save(
            tmp_path / 'in' / name)
    srv = _stub_watch_server(tmp_path)
    batches = []

    def fake(images):
        batches.append([im.size for im in images])
        return _fake_sr(images)

    srv._batched_super_resolve = fake
    assert srv.process_dir_once() == 4
    assert sorted(len(b) for b in batches) == [2, 2]
    for sizes in batches:
        assert len(set(sizes)) == 1
    for name in ('a_out.png', 'b_out.png', 'c_out.png', 'd_out.png'):
        assert (tmp_path / 'out' / name).exists()


def test_watch_quarantine_after_failures_then_retry(tmp_path):
    (tmp_path / 'in').mkdir()
    Image.fromarray(np.zeros((6, 6, 3), np.uint8)).save(
        tmp_path / 'in' / 'x.png')
    srv = _stub_watch_server(tmp_path, max_failures=2, retry_after_polls=3)
    calls = {'n': 0}
    failing = {'on': True}

    def fake(images):
        calls['n'] += 1
        if failing['on']:
            raise RuntimeError('transient card hiccup')
        return _fake_sr(images)

    srv._batched_super_resolve = fake
    # poll 1: first failure, not quarantined
    assert srv.process_dir_once() == 0 and calls['n'] == 1
    assert not srv.quarantined and srv.failed_inputs
    # poll 2: second failure in a row, quarantined
    assert srv.process_dir_once() == 0 and calls['n'] == 2
    assert len(srv.quarantined) == 1
    assert srv.stats['errors'] == 2
    # polls 3-4: inside the retry window
    assert srv.process_dir_once() == 0 and calls['n'] == 2
    assert srv.process_dir_once() == 0 and calls['n'] == 2
    # poll 5: retried, succeeds
    failing['on'] = False
    assert srv.process_dir_once() == 1 and calls['n'] == 3
    assert (tmp_path / 'out' / 'x_out.png').exists()
    assert srv.process_dir_once() == 0
    assert not srv.quarantined and not srv.failed_inputs


class _EchoSampler:
    """A stand-in for ``Sampler``: each condition canvas back, plus its
    label, so a result shows whose request it was."""

    def sample(self, conds, labels, seed, guidance=None):
        time.sleep(0.001)
        return conds + np.asarray(labels).reshape(-1, 1, 1, 1) / 255.0


def test_concurrent_requests_keep_every_result_and_count(tmp_path):
    """More request threads than cores, with a short switch interval: every
    request gets its own image back, seeded or coalesced, and no counter
    update is lost."""
    srv = _stub_watch_server(tmp_path)
    srv.args.coalesce_window = 0.02
    srv.sampler = _EchoSampler()
    srv.lock = threading.Lock()
    srv._sample_started = None
    srv.batcher = BatchingQueue(srv._sample_batch, 0.02, 4)
    n = 4 * (os.cpu_count() or 1) + 8
    images = [_rand_image(i, 4 + i % 3, 5) for i in range(n)]
    outs = [None] * n
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def go(i):
            outs[i] = srv.super_resolve(
                images[i], seed=i if i % 3 == 0 else None, test_label=i % 2)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        srv.batcher.shutdown()
    for i, (img, out) in enumerate(zip(images, outs)):
        cond = np.asarray(tinfer.upscale_bicubic(bucket_pad(img, 8)[0]))
        want = np.clip(cond.astype(int) + i % 2, 0, 255)[
            :4 * img.size[1], :4 * img.size[0]]
        np.testing.assert_array_equal(np.asarray(out), want)
    assert srv.stats['served'] == n
    assert srv.stats['mpix'] == pytest.approx(
        sum(16 * im.size[0] * im.size[1] for im in images) / 1e6)
    assert srv.batcher.stats['batched_images'] == n - len(range(0, n, 3))


@pytest.fixture(scope='module')
def server(conf, tmp_path_factory):
    root = tmp_path_factory.mktemp('serve')
    args = parse_args([
        '-c', str(conf), '-m', '', '--mode', 'watch', '--device', 'cpu',
        '--input_dir', str(root / 'in'), '--output_dir', str(root / 'out'),
        *SAMPLING])
    (root / 'in').mkdir()
    srv = Server(args)
    srv.root = root
    return srv


def test_watch_pass_processes_and_skips(server, capsys):
    rng = np.random.RandomState(1)
    for name in ('a.png', 'b.png'):
        Image.fromarray((rng.rand(6, 7, 3) * 255).astype(np.uint8)).save(
            server.root / 'in' / name)
    assert server.process_dir_once() == 2
    out_a = Image.open(server.root / 'out' / 'a_out.png')
    assert out_a.size == (7 * 4, 6 * 4)
    assert server.stats['watch_batches'] == 1
    assert server.process_dir_once() == 0
    assert 'skip' not in capsys.readouterr().out
    (server.root / 'in' / 'bad.png').write_bytes(b'not a png')
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        server.root / 'in' / 'c.png')
    assert server.process_dir_once() == 1
    assert server.stats['served'] == 3


def test_coalesced_super_resolve_end_to_end(server):
    """Two concurrent seedless requests run as one sample with one label per
    canvas; an explicit seed bypasses the batcher and re-seeds."""
    calls = []
    sample = server.sampler.sample

    def spy(conds, labels, seed, guidance=None):
        calls.append((conds.shape[0], None if labels is None
                      else sorted(np.asarray(labels).reshape(-1).tolist()),
                      seed))
        return sample(conds, labels, seed, guidance=guidance)

    server.sampler.sample = spy
    server.batcher = BatchingQueue(server._sample_batch, window=1.0,
                                   max_images=4)
    try:
        imgs = [_rand_image(i, 8, 8) for i in range(2)]
        outs = [None, None]

        def go(i):
            outs[i] = server.super_resolve(imgs[i], test_label=i)

        threads = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        assert outs[0].size == (32, 32) and outs[1].size == (32, 32)
        assert server.batcher.stats == {
            'batches': 1, 'batched_images': 2, 'batches_closed_full': 0,
            'batches_closed_deadline': 1, 'batches_closed_mismatch': 0}
        assert calls == [(2, [0, 1], server.args.seed)]
        direct = [server.super_resolve(imgs[0], seed=5, test_label=0)
                  for _ in range(2)]
        assert direct[0].size == (32, 32)
        np.testing.assert_array_equal(np.asarray(direct[0]),
                                      np.asarray(direct[1]))
        assert server.batcher.stats['batched_images'] == 2
        assert calls[1:] == [(1, [0], 5)] * 2
    finally:
        server.sampler.sample = sample
        server.batcher.shutdown()
        server.batcher = None


@pytest.mark.parametrize('extra', [['--mesh', '1,1']])
def test_server_int8_precision_raises(conf, extra):
    """The JAX daemon's mesh flag, once refused, now serves: a ``Server``
    on a one-rank gloo mesh (in this process) reports the mesh in its
    health fields and gives the PNG of the daemon without it for a seeded
    request."""
    from srgd_tpu_torch.parallel.mesh import launch

    def serve(mesh, args):
        server = Server(args, mesh=mesh)
        try:
            return server.model_info['mesh'], np.asarray(server.super_resolve(
                _rand_image(3, 12, 10), seed=5, test_label=1))
        finally:
            server.close()

    argv = ['-c', str(conf), '-m', '', '--mode', 'http', '--device', 'cpu',
            *SAMPLING]
    want = np.asarray(Server(parse_args(argv)).super_resolve(
        _rand_image(3, 12, 10), seed=5, test_label=1))
    args = parse_args(argv + extra)
    shape, got = launch(serve, (1, 1), 'cpu', (args,))
    assert shape == [1, 1]
    np.testing.assert_array_equal(got, want)


def test_server_fast_sampler_flags(conf):
    """--continuous_sampler ddim --ddim_eta 1.0 reach the wrapper, and the
    daemon serves the default net in bf16 by default with w8a8 cleared."""
    args = parse_args([
        '-c', str(conf), '-m', '', '--mode', 'http', '--device', 'cpu',
        '--num_sample_steps', '2', '--tile_size', '16', '--batch_size', '2',
        '--lr_bucket', '8', '--test_label', '0',
        '--continuous_sampler', 'ddim', '--ddim_eta', '1.0'])
    assert args.precision == 'bf16'
    srv = Server(args)
    wrapper = srv.sampler.wrapper
    assert (wrapper.sampler, wrapper.ddim_eta) == ('ddim', 1.0)
    assert wrapper.net.dtype == torch.bfloat16
    assert not wrapper.net.downs[0][2].use_pallas
    assert srv.model_info['model'] == 'conditional_continuous'
    out = srv.super_resolve(_rand_image(2, 6, 6))
    assert out.size == (24, 24)


INT8_YAML = """
model: conditional_continuous
unet_dim: 8
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 8
num_classes: 3
image_size: 16
"""


def test_server_int8_precision(tmp_path):
    """tests/test_serve.py::test_server_int8_precision on the port: the
    daemon builds and serves with --precision int8 (quantized convs on the
    checkpoint-shaped params) and says so in model_info."""
    from srgd_tpu_torch.nn.quant import quant_convs
    conf = tmp_path / 'tiny.yaml'
    conf.write_text(INT8_YAML)
    args = parse_args([
        '-c', str(conf), '-m', '', '--mode', 'http', '--device', 'cpu',
        '--num_sample_steps', '2', '--tile_size', '16', '--batch_size', '2',
        '--lr_bucket', '8', '--test_label', '0', '--precision', 'int8',
        '--quantize_min_channels', '8', '--quantize_smooth_alpha', '0.5'])
    srv = Server(args)
    convs = quant_convs(srv.sampler.wrapper.net)
    assert convs and all(m.smooth_alpha == 0.5 for _, m in convs)
    out = srv.super_resolve(_rand_image(0, 6, 6))
    assert out.size == (24, 24)
    assert srv.model_info['precision'] == 'int8'


def test_server_int8_calibrates_once_with_cache(tmp_path, monkeypatch):
    """--quant_calibrate calibrates at start-up and writes the cache; a
    restarted daemon loads it instead, and both serve the same bytes."""
    from srgd_tpu_torch.nn import quant
    conf = tmp_path / 'tiny.yaml'
    conf.write_text(INT8_YAML)
    cache = tmp_path / 'cal.npz'
    argv = ['-c', str(conf), '-m', '', '--mode', 'http', '--device', 'cpu',
            '--num_sample_steps', '2', '--tile_size', '16', '--batch_size',
            '2', '--lr_bucket', '8', '--precision', 'int8',
            '--quantize_min_channels', '16', '--quant_calibrate',
            '--quant_calibrate_cache', str(cache)]
    outs = []
    for _ in range(2):
        srv = Server(parse_args(argv))
        assert cache.exists() and quant.has_calibration(srv.sampler.wrapper.net)
        outs.append(np.asarray(srv.super_resolve(_rand_image(1, 6, 6),
                                                 seed=3)))

        def boom(*a, **kw):
            raise AssertionError('calibrated again despite a valid cache')
        monkeypatch.setattr(quant, 'calibrate_sampler', boom)
    np.testing.assert_array_equal(outs[0], outs[1])


def _serve_http(server):
    server.args.port = 0
    httpd = server.make_http_server()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, http.client.HTTPConnection(
        '127.0.0.1', httpd.server_address[1], timeout=300)


def test_http_endpoints(server):
    httpd, conn = _serve_http(server)
    try:
        conn.request('GET', '/healthz')
        r = conn.getresponse()
        health = json.loads(r.read())
        assert r.status == 200 and health['status'] == 'ok'
        assert health['lr_bucket'] == 8 and health['busy'] is False
        assert health['device'] == 'cpu'

        # a sample in flight past --stall_timeout_seconds fails liveness
        with server.stats_lock:
            server._sample_started = time.time() - 9.0
        server.args.stall_timeout_seconds = 5.0
        conn.request('GET', '/healthz')
        r = conn.getresponse()
        stalled = json.loads(r.read())
        assert r.status == 503 and stalled['status'] == 'stalled'
        assert stalled['sample_inflight_seconds'] >= 9.0
        with server.stats_lock:
            server._sample_started = None
        conn.request('GET', '/healthz')
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())['status'] == 'ok'

        png = _png_bytes(_rand_image(2, 6, 6))
        conn.request('POST', '/v1/sr?seed=5&label=1', body=png)
        r = conn.getresponse()
        assert r.status == 200 and r.getheader('Content-Type') == 'image/png'
        assert Image.open(io.BytesIO(r.read())).size == (24, 24)

        conn.request('POST', '/v1/sr', body=b'garbage')
        r = conn.getresponse()
        assert r.status == 400
        json.loads(r.read())

        conn.request('GET', '/stats')
        r = conn.getresponse()
        stats = json.loads(r.read())
        assert r.status == 200
        # the fixture is shared: earlier tests may have counted already
        assert stats['served'] >= 1 and stats['errors'] >= 1
        assert stats['sample_inflight_seconds'] == 0.0
        server._sample_started = time.time() - 5.0
        try:
            assert server.stats_snapshot()['sample_inflight_seconds'] >= 5.0
        finally:
            server._sample_started = None

        conn.request('GET', '/metrics')
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader('Content-Type').startswith('text/plain')
        metrics = r.read().decode()
        for line in ('# TYPE srgd_served counter',
                     '# TYPE srgd_uptime_seconds gauge',
                     '# TYPE srgd_busy gauge',
                     '# TYPE srgd_sample_inflight_seconds gauge'):
            assert line in metrics
        parsed = {line.split()[0]: float(line.split()[1])
                  for line in metrics.splitlines() if not line.startswith('#')}
        assert parsed['srgd_served'] == stats['served']
        assert parsed['srgd_errors'] >= 1 and parsed['srgd_busy'] == 0

        conn.request('GET', '/nope')
        r = conn.getresponse()
        assert r.status == 404
        r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_warmup_compiles_and_restores_counters(server):
    """--warmup_sizes runs its geometries without counting them as
    traffic."""
    before = dict(server.stats)
    server.args.warmup_sizes = '6'
    try:
        server.warmup()
    finally:
        server.args.warmup_sizes = ''
    after = server.stats_snapshot()
    for k in ('served', 'errors', 'mpix', 'sample_seconds'):
        assert after[k] == before[k], (k, after[k], before[k])
    assert after['sample_inflight_seconds'] == 0.0


def test_http_per_request_guidance(server):
    """A guided request steers the output (other pixels, same seed) and runs
    alone; guidance on both axes is a 400 before any device work, and so is
    a malformed scale."""
    calls = []
    sample = server.sampler.sample

    def spy(*a, **k):
        calls.append(k.get('guidance'))
        return sample(*a, **k)

    server.sampler.sample = spy
    httpd, conn = _serve_http(server)
    try:
        png = _png_bytes(_rand_image(3, 6, 6))
        conn.request('POST', '/v1/sr?seed=5&label=1', body=png)
        r = conn.getresponse()
        assert r.status == 200
        base = np.asarray(Image.open(io.BytesIO(r.read())))

        conn.request('POST', '/v1/sr?seed=5&label=1&class_cond_scale=2',
                     body=png)
        r = conn.getresponse()
        assert r.status == 200
        guided = np.asarray(Image.open(io.BytesIO(r.read())))
        assert guided.shape == base.shape
        assert not np.array_equal(guided, base)
        assert calls == [None, {'class_cond_scale': 2.0}]

        conn.request('POST', '/v1/sr?cond_scale=1.5&class_cond_scale=1.5',
                     body=png)
        r = conn.getresponse()
        assert r.status == 400
        assert 'both axes' in json.loads(r.read())['error']

        conn.request('POST', '/v1/sr?class_cond_scale=nope', body=png)
        r = conn.getresponse()
        assert r.status == 400
        json.loads(r.read())
        assert len(calls) == 2
    finally:
        server.sampler.sample = sample
        httpd.shutdown()
        httpd.server_close()


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_daemon_process_serves_and_exits_on_sigterm(conf):
    """``python -m srgd_tpu_torch.serve --device cpu --mode http``: healthz,
    one request, then SIGTERM drains and the process exits 0."""
    port = _free_port()
    cmd = [sys.executable, '-m', 'srgd_tpu_torch.serve', '-c', str(conf),
           '-m', '', '--mode', 'http', '--device', 'cpu', '--port', str(port),
           '--num_sample_steps', '2', '--tile_size', '16', '--batch_size',
           '2', '--lr_bucket', '8', '--test_label', '0',
           '--coalesce_window', '0.05']
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            try:
                conn = http.client.HTTPConnection('127.0.0.1', port,
                                                  timeout=60)
                conn.request('GET', '/healthz')
                r = conn.getresponse()
                break
            except OSError:
                assert time.time() < deadline, 'daemon never answered'
                time.sleep(0.2)
        health = json.loads(r.read())
        assert r.status == 200 and health['precision'] == 'bf16'
        conn.request('POST', '/v1/sr', body=_png_bytes(_rand_image(4, 5, 6)))
        r = conn.getresponse()
        assert r.status == 200
        assert Image.open(io.BytesIO(r.read())).size == (24, 20)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-3000:]
        assert 'served 1 images, 0 errors' in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
