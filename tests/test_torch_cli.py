"""The port's inference CLI against the JAX package's, on the same weights.

A tiny config and a reference-format ``.pth`` (seeded JAX params through
``export_torch_state_dict``) feed both ``python -m srgd_tpu_torch.infer``
and ``srgd_tpu.infer``. The port's CLI keeps the reference's surface: the x4
output, the '.png' -> '_out.png' rename, skip-existing and per-image
re-seeding. With the JAX CLI's noise replayed (``PRNGKey(seed)`` per image)
the two output PNGs agree within 1/255."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from srgd_tpu.checkpoint.torch_convert import export_torch_state_dict
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch import infer as tinfer
from tests.test_torch_sampler import JaxKeyNoise

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_YAML = """
model: conditional_continuous
noise_schedule: linear
num_sample_steps: 2
unet_dim: 16
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 8
num_classes: 3
image_size: 32
"""

COMMON = ['--num_sample_steps', '2', '--tile_size', '32', '--test_label', '1',
          '--class_cond_scale', '2.0', '--seed', '5', '--batch_size', '4']


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    conf = root / 'tiny.yaml'
    conf.write_text(TINY_YAML)
    params = JaxUnet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                     learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
                     num_classes=3).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
        class_label=jnp.zeros((1,), jnp.int32))['params']
    sd = export_torch_state_dict({'params': params},
                                 model='conditional_continuous')
    ckpt = root / 'tiny.pth'
    torch.save({'ema_model': {k: torch.from_numpy(np.array(v))
                              for k, v in sd.items()}}, ckpt)
    in_dir = root / 'in'
    in_dir.mkdir()
    img = np.random.default_rng(0).integers(0, 255, size=(16, 16, 3),
                                            dtype=np.uint8)
    for name in ('a.png', 'b.png'):     # same pixels: per-image re-seeding
        Image.fromarray(img).save(in_dir / name)
    return conf, ckpt, in_dir, root


def _argv(conf, ckpt, in_dir, out_dir, extra=()):
    return ['-c', str(conf), '-m', str(ckpt), '--input_dir', str(in_dir),
            '--output_dir', str(out_dir), *COMMON, *extra]


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int16)


def test_port_cli_end_to_end(setup):
    conf, ckpt, in_dir, root = setup
    out_dir = root / 'port_out'
    cmd = [sys.executable, '-m', 'srgd_tpu_torch.infer',
           *_argv(conf, ckpt, in_dir, out_dir, ['--device', 'cpu'])]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    outs = [out_dir / 'a_out.png', out_dir / 'b_out.png']
    for p in outs:
        assert Image.open(p).size == (64, 64)
    np.testing.assert_array_equal(_png(outs[0]), _png(outs[1]))
    stamp = [os.path.getmtime(p) for p in outs]

    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count('skip') == 2
    assert [os.path.getmtime(p) for p in outs] == stamp


def test_port_cli_matches_jax_cli(setup):
    conf, ckpt, in_dir, root = setup
    from srgd_tpu.infer import main as jax_main
    jax_out = root / 'jax_out'
    jax_main(_argv(conf, ckpt, in_dir, jax_out))

    port_out = root / 'port_replay_out'
    args = tinfer.parse_args(_argv(conf, ckpt, in_dir, port_out,
                                   ['--device', 'cpu']))
    sampler = tinfer.build_sampler(
        args, noise_for_seed=lambda seed, device: JaxKeyNoise(
            jax.random.PRNGKey(seed)))
    tinfer.run(args, sampler)
    for name in ('a_out.png', 'b_out.png'):
        want, got = _png(jax_out / name), _png(port_out / name)
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize('extra, item', [
    (['--precision', 'int8'], 'Queue 1 item 14'),
    (['--quantize_min_channels', '0'], 'Queue 1 item 14'),
    (['--deep_cache', '2'], 'Queue 1 item 9'),
    (['--mesh', '1,1'], 'Queue 1 item 15'),
])
def test_unported_flags_raise(setup, extra, item):
    conf, ckpt, in_dir, root = setup
    args = tinfer.parse_args(_argv(conf, ckpt, in_dir, root / 'never',
                                   ['--device', 'cpu', *extra]))
    with pytest.raises(NotImplementedError, match=item):
        tinfer.build_sampler(args)
    assert not (root / 'never').exists()


def test_cuda_device_without_card_raises(setup, monkeypatch):
    conf, ckpt, in_dir, root = setup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = tinfer.parse_args(_argv(conf, ckpt, in_dir, root / 'never'))
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tinfer.build_sampler(args)
