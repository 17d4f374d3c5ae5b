"""``python -m srgd_tpu_torch.infer --mesh`` and the serving daemon's
``--mesh``, against the same entry points without it.

The CLI spawns its own gloo ranks; the daemon's ranks are spawned by
``parallel.mesh.launch`` under the test's tmp path (see
tests/test_torch_parallel.py for the harness). The CLI's PNG is held to
test_cli_mesh_multichip's bar (tests/test_cli.py:129: within 1/255 on under
5 % of the pixels) and is bit-equal in fact; the daemon's PNG bytes equal
the one-rank daemon's.
"""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from srgd_tpu_torch import infer as tinfer
from tests import test_torch_mesh_ranks as ranks

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = ranks.JOIN_S
run_world = ranks.run_world


TINY_YAML = """
model: conditional_continuous
noise_schedule: linear
unet_dim: 8
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 4
num_classes: 3
image_size: 32
"""


@pytest.fixture(scope='module')
def tiny_conf(tmp_path_factory):
    path = tmp_path_factory.mktemp('mesh_conf') / 'tiny.yaml'
    path.write_text(TINY_YAML)
    return path


INT8 = ['--precision', 'int8', '--quantize_min_channels', '8',
        '--quant_calibrate', '--quant_calibrate_cache']


@pytest.mark.parametrize('extra', [[], INT8], ids=['fp32', 'int8_calibrated'])
def test_cli_mesh_multichip(tiny_conf, tmp_path, extra):
    """``python -m srgd_tpu_torch.infer --mesh 2,1 --device cpu`` spawns its
    own two gloo ranks; its PNG is the one the CLI writes without
    ``--mesh``: test_cli_mesh_multichip's bar, and bit-equal in fact. With
    int8 calibration rank 0 calibrates, writes the cache and sends the
    scales to rank 1."""
    in_dir = tmp_path / 'in'
    in_dir.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, size=(16, 20, 3), dtype=np.uint8)).save(in_dir / 'a.png')
    argv = ['-c', str(tiny_conf), '-m', '', '--input_dir', str(in_dir),
            '--device', 'cpu', '--num_sample_steps', '2', '--tile_size', '32',
            '--batch_size', '2', '--test_label', '1', '--seed', '3']

    def cache(name):
        return [*extra, str(tmp_path / f'{name}.npz')] if extra else []

    # the plain CLI here, the mesh CLI as its own command
    tinfer.main(argv + ['--output_dir', str(tmp_path / 'plain'),
                        *cache('plain')])
    res = subprocess.run(
        [sys.executable, '-m', 'srgd_tpu_torch.infer', *argv, '--output_dir',
         str(tmp_path / 'mesh'), *cache('mesh'), '--mesh', '2,1'], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                 TMPDIR=str(tmp_path)),
        capture_output=True, text=True, timeout=JOIN_S)
    assert res.returncode == 0, res.stderr[-3000:]
    if extra:
        assert (tmp_path / 'mesh.npz').exists()
        assert res.stderr.count('saved calibration cache') == 1
    outs = {}
    for name in ('mesh', 'plain'):
        assert sorted(os.listdir(tmp_path / name)) == ['a_out.png']
        outs[name] = np.asarray(Image.open(tmp_path / name / 'a_out.png'))
    a, b = (outs[k].astype(np.int16) for k in ('mesh', 'plain'))
    assert a.shape == (64, 80, 3)
    assert np.abs(a - b).max() <= 1
    assert np.mean(a != b) < 0.05
    np.testing.assert_array_equal(a, b)


def test_cli_mesh_rank_failure_fails_the_command(tiny_conf, tmp_path):
    """A rank that raises makes the launching command exit non-zero: a
    missing checkpoint fails every rank's model build."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               TMPDIR=str(tmp_path))
    res = subprocess.run(
        [sys.executable, '-m', 'srgd_tpu_torch.infer', '-c', str(tiny_conf),
         '-m', str(tmp_path / 'missing.pth'), '--input_dir', str(tmp_path),
         '--output_dir', str(tmp_path / 'out'), '--device', 'cpu',
         '--mesh', '2,1'], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=JOIN_S)
    assert res.returncode != 0
    assert 'missing.pth' in res.stderr


SERVE_ARGV = ['-m', '', '--mode', 'http', '--device', 'cpu',
              '--num_sample_steps', '2', '--tile_size', '16', '--batch_size',
              '4', '--lr_bucket', '8', '--precision', 'fp32']
SEEDED = [(5, 1, 12, 10), (6, 0, 8, 8)]


@pytest.fixture(scope='module')
def served(tiny_conf, tmp_path_factory):
    """The daemon at world 2 (rank 0 serving, rank 1 following) under a
    6 s process-group timeout: it idles 8 s, then answers a request whose
    first forward raises on rank 0 alone, then the two ``SEEDED``
    requests; and the world-1 daemon's answers to those two."""
    argv = ['-c', str(tiny_conf)] + SERVE_ARGV
    two = run_world(ranks.serve_rank, (2, 1),
                    (argv + ['--mesh', '2,1'], [(7, 2, 12, 12)] + SEEDED,
                     8.0, True), tmp_path_factory.mktemp('served'),
                    timeout_s=6)
    return two, ranks.serve_rank(None, argv, SEEDED)


def test_serve_mesh_matches_one_rank(served):
    """The daemon at world 2 gives the world-1 daemon's PNG bytes for two
    seeded requests, reports its mesh on /healthz's and /stats' fields,
    and its stop message ends the follower (the world joins)."""
    (pngs, health, stats), (want, one_health, one_stats) = served
    assert health == stats == [2, 1]
    assert pngs[1:] == want
    assert one_health is one_stats is None


def test_serve_mesh_outlives_its_timeout_and_a_failed_sample(served):
    """The world-2 daemon idled past its process group's timeout (rank 0's
    heartbeat keeps the follower's wait for the next sample short of it),
    and a request whose first forward raised on rank 0 alone failed on
    both ranks (they agree before the all-gather and raise
    ``MeshSampleError``) while the daemon served on: the next requests
    give the world-1 bytes (``test_serve_mesh_matches_one_rank``)."""
    (pngs, _, _), _ = served
    assert pngs[0] == 'MeshSampleError' and len(pngs) == 3


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def test_serve_mesh_daemon_serves_and_exits_on_sigterm(tiny_conf, tmp_path):
    """``python -m srgd_tpu_torch.serve --mesh 2,1 --device cpu``: /healthz
    names the mesh, one request is answered, and SIGTERM (passed on to both
    ranks) drains rank 0, whose stop message ends rank 1: exit 0."""
    port = _free_port()
    cmd = [sys.executable, '-m', 'srgd_tpu_torch.serve', '-c', str(tiny_conf),
           '-m', '', '--mode', 'http', '--device', 'cpu', '--port', str(port),
           '--num_sample_steps', '2', '--tile_size', '16', '--batch_size',
           '2', '--lr_bucket', '8', '--test_label', '0', '--mesh', '2,1']
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               TMPDIR=str(tmp_path))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        deadline = time.time() + JOIN_S
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
        assert r.status == 200 and health['mesh'] == [2, 1]
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(4).integers(
            0, 255, size=(6, 5, 3), dtype=np.uint8)).save(buf, format='PNG')
        conn.request('POST', '/v1/sr?seed=3', body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 200
        assert Image.open(io.BytesIO(r.read())).size == (20, 24)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=JOIN_S)
        assert proc.returncode == 0, err[-3000:]
        assert 'served 1 images, 0 errors' in err
    finally:
        if proc.poll() is None:   # the launcher and its ranks
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
