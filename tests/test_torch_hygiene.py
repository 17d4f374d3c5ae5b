"""The port stands alone: no JAX at import or run time, no CPU mode in
chip_smoke.py, and no silent fallback when the kernels cannot be built."""

import json
import os
import subprocess
import sys

import pytest

from srgd_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Rehearses chip_smoke.py's phases on the CPU at a tiny size (the kernels'
# plain versions; dim 16, 32-px tiles), then imports every module of the
# port, and reports which modules of JAX or the JAX package got imported.
_SLICE = r"""
import importlib, json, pkgutil, sys
import torch
import chip_smoke
cpu = torch.device('cpu')
kernels = chip_smoke.phase_kernels(torch, cpu, b=2, lin_shapes=((40, 32),),
                                   attn_shapes=((16, 64),), iters=1)
net = dict(dim=16, dim_mults=(1, 2), full_attn=(False, True))
slice_ = chip_smoke.phase_slice(torch, cpu, size=40, tile_size=32, steps=2,
                                batch_size=4, **net)
bench = chip_smoke.phase_bench(torch, cpu, lr_size=10, tile_size=32,
                               batch_size=4, **net)
smoke_imported = sorted(k for k in sys.modules if k.split('.')[0] in
                        ('jax', 'jaxlib', 'flax', 'srgd_tpu'))
import srgd_tpu_torch
for m in pkgutil.walk_packages(srgd_tpu_torch.__path__, 'srgd_tpu_torch.'):
    importlib.import_module(m.name)
print(json.dumps({
    'smoke_imported': smoke_imported,
    'port_imported': sorted(k for k in sys.modules if k.split('.')[0] in
                            ('jax', 'jaxlib', 'flax')),
    'ok': [kernels['ok'], slice_['ok'], bench['ok']],
    'slice': slice_, 'summary': chip_smoke.summary(kernels, slice_)}))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    return env


def test_port_and_chip_smoke_phases_import_no_jax():
    res = subprocess.run([sys.executable, '-c', _SLICE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    # chip_smoke.py's path imports nothing of JAX or of the JAX package; the
    # port's CLI and checkpoint loader add only srgd_tpu's jax-free config
    # and converter modules
    assert rep['smoke_imported'] == [], rep['smoke_imported']
    assert rep['port_imported'] == [], rep['port_imported']
    assert rep['ok'] == [True, True, True]
    s = rep['slice']
    # downs_0_2 and ups_1_2 are linear; downs_1_2, mid_attn and ups_0_2 full
    assert s['forwards'] > 0
    assert (s['linattn_blocks'], s['attn_blocks']) == (2, 3)
    # the CPU takes the plain versions, which never count as launches
    assert s['linattn_launches'] == s['attn_launches'] == 0
    names = [k['name'] for k in rep['summary']['kernels']]
    assert names == ['linattn_block', 'attn_block']


def test_chip_smoke_without_a_card_fails():
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=''),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert 'no CUDA device' in res.stderr


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path / 'empty'))
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setattr(_build, 'CUDA_BIN', str(tmp_path / 'cuda' / 'bin'))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_lib', None)
    with pytest.raises(RuntimeError, match='nvcc not found.*no fallback'):
        _build.load()
    assert not (tmp_path / 'build').exists()
