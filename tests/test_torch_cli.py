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


@pytest.mark.parametrize('extra', [['--mesh', '1,1']])
def test_unported_flags_raise(setup, extra):
    """The flags the port once refused now run: ``--mesh 1,1`` on the CPU
    (a one-rank gloo mesh in this process, its chunks all-gathered at
    world 1) writes the PNGs of the run without it, byte for byte."""
    conf, ckpt, in_dir, root = setup
    plain, meshed = root / 'flags_plain', root / 'flags_mesh'
    tinfer.main(_argv(conf, ckpt, in_dir, plain, ['--device', 'cpu']))
    tinfer.main(_argv(conf, ckpt, in_dir, meshed,
                      ['--device', 'cpu', *extra]))
    for name in ('a_out.png', 'b_out.png'):
        assert (meshed / name).read_bytes() == (plain / name).read_bytes()


def test_cuda_device_without_card_raises(setup, monkeypatch):
    conf, ckpt, in_dir, root = setup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = tinfer.parse_args(_argv(conf, ckpt, in_dir, root / 'never'))
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tinfer.build_sampler(args)


FAMILY_YAML = {
    'conditional_gaussian': """
model: conditional_gaussian
timesteps: 12
sampling_timesteps: 6
beta_schedule: sigmoid
unet_dim: 16
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: false
num_classes: 3
image_size: 32
""",
    'conditional_elucidated': """
model: conditional_elucidated
num_sample_steps: 2
unet_dim: 16
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 8
num_classes: 3
image_size: 32
""",
}


@pytest.fixture(scope='module')
def family_setup(setup):
    """A tiny YAML and a reference-format ``.pth`` for each of the other two
    families, beside the continuous one of ``setup``."""
    conf, ckpt, in_dir, root = setup
    out = {'conditional_continuous': (conf, ckpt)}
    for model, yaml_text in FAMILY_YAML.items():
        path = root / f'{model}.yaml'
        path.write_text(yaml_text)
        lsc = model != 'conditional_gaussian'
        params = JaxUnet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                         learned_sinusoidal_cond=lsc, learned_sinusoidal_dim=8,
                         num_classes=3).init(
            jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
            class_label=jnp.zeros((1,), jnp.int32))['params']
        sd = export_torch_state_dict({'params': params}, model=model)
        weights = root / f'{model}.pth'
        torch.save({'ema_model': {k: torch.from_numpy(np.array(v))
                                  for k, v in sd.items()}}, weights)
        out[model] = (path, weights)
    return out, in_dir, root


FAMILY_RUNS = {
    'gaussian': ('conditional_gaussian', []),
    # two Karras steps go from sigma 80 to 0.002: the Heun correction divides
    # by 0.002 and amplifies float32 rounding past 1/255
    'elucidated': ('conditional_elucidated', ['--num_sample_steps', '4']),
    'continuous_deep_cache': ('conditional_continuous',
                              ['--deep_cache', '2', '--deep_cache_depth', '1',
                               '--num_sample_steps', '4']),
    'elucidated_deep_cache': ('conditional_elucidated',
                              ['--deep_cache', '2', '--deep_cache_depth', '1',
                               '--deep_cache_schedule', '1x1/1x2',
                               '--num_sample_steps', '4']),
}


@pytest.mark.parametrize('run', sorted(FAMILY_RUNS))
def test_port_cli_families_match_jax_cli(family_setup, run):
    """Each family, and DeepCache, through both CLIs on the same weights and
    replayed noise: x4 PNGs within 1/255 of each other."""
    confs, in_dir, root = family_setup
    model, extra = FAMILY_RUNS[run]
    conf, ckpt = confs[model]
    from srgd_tpu.infer import main as jax_main
    jax_out = root / f'jax_{run}'
    jax_main(_argv(conf, ckpt, in_dir, jax_out, extra))

    port_out = root / f'port_{run}'
    args = tinfer.parse_args(_argv(conf, ckpt, in_dir, port_out,
                                   ['--device', 'cpu', *extra]))
    sampler = tinfer.build_sampler(
        args, noise_for_seed=lambda seed, device: JaxKeyNoise(
            jax.random.PRNGKey(seed)))
    assert type(sampler.wrapper).__name__ == {
        'conditional_gaussian': 'GaussianDiffusion',
        'conditional_elucidated': 'ElucidatedDiffusion',
        'conditional_continuous': 'ContinuousDiffusion'}[model]
    assert sampler.wrapper.deep_cache_interval == (
        2 if '--deep_cache' in extra else 0)
    tinfer.run(args, sampler)
    for name in ('a_out.png', 'b_out.png'):
        want, got = _png(jax_out / name), _png(port_out / name)
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize('model', ['conditional_continuous',
                                   'conditional_gaussian',
                                   'conditional_elucidated'])
def test_cli_flags_plumb_to_wrapper(family_setup, model):
    """The DeepCache flags reach the wrapper, and ``--no_dpmpp_solver``
    reaches ``conf.use_dpmpp_solver`` and the elucidated wrapper; the
    continuous and gaussian families clear it, as the reference does."""
    confs, in_dir, root = family_setup
    conf, ckpt = confs[model]
    flags = ['--deep_cache', '3', '--deep_cache_depth', '1',
             '--deep_cache_schedule', '0.5x3/0.5x1']
    for dpmpp in (True, False):
        args = tinfer.parse_args(
            _argv(conf, ckpt, in_dir, root / 'never',
                  ['--device', 'cpu', *flags,
                   *([] if dpmpp else ['--no_dpmpp_solver'])]))
        assert args.use_dpmpp_solver is dpmpp
        w = tinfer.build_sampler(args).wrapper
        assert (w.deep_cache_interval, w.deep_cache_depth,
                w.deep_cache_schedule) == (3, 1, '0.5x3/0.5x1')
        if model == 'conditional_elucidated':
            assert w.use_dpmpp_solver is dpmpp
        else:
            assert not hasattr(w, 'use_dpmpp_solver')
    args = tinfer.parse_args(_argv(conf, ckpt, in_dir, root / 'never',
                                   ['--device', 'cpu']))
    assert tinfer.build_sampler(args).wrapper.deep_cache_interval == 0
    assert not (root / 'never').exists()


# --precision int8: the JAX CLI's W8A8 path, calibrated, on both CLIs
INT8 = ['--precision', 'int8', '--quantize_min_channels', '16',
        '--quant_calibrate']
INT8_RUNS = {
    'ancestral': [],
    'ddim': ['--continuous_sampler', 'ddim'],
}


def _float32_nets(monkeypatch):
    """Both packages' ``get_model`` build the net in float32."""
    import srgd_tpu.factory as jax_factory
    import srgd_tpu_torch.factory as port_factory
    for module in (jax_factory, port_factory):
        real = module.get_model

        def get_model(conf, *args, _real=real, **kw):
            conf.compute_dtype = 'float32'
            return _real(conf, *args, **kw)
        monkeypatch.setattr(module, 'get_model', get_model)


@pytest.mark.parametrize('run', sorted(INT8_RUNS))
def test_port_cli_int8_matches_jax_cli(setup, run, monkeypatch):
    """``--precision int8 --quant_calibrate --quant_calibrate_cache F``
    through both CLIs on the same .pth and one 16-px image, with the JAX
    calibration draws and sampling noise replayed: a tiled 2-step run with
    class CFG. The PNGs are equal.

    The int8 CLIs compute in bf16, whose rounding points differ between XLA
    and PyTorch on the CPU (the two bf16 CLIs alone differ by up to 226/255
    after these 2 steps on random weights), so both build their net in
    float32 here; everything int8 stays. A first step at log-SNR -10 divides
    the noise estimate by alpha = 0.007, so one int8 code flip (see
    tests/test_torch_quant.py: a float32 rounding apart at a half-integer)
    would reach the pixels: the port runs on the codes of the JAX run, each
    checked to be its own or one flip away (``JaxCodes``), the JAX CLI
    running eagerly for that. A second port run loads the port's cache and
    skips the calibrate phase, with the same PNG."""
    from srgd_tpu.infer import main as jax_main
    from srgd_tpu_torch.nn import quant
    from tests.test_torch_quant import JaxCodes
    from tests.test_torch_quant_cache import _jax_draws
    conf, ckpt, _, root = setup
    in_dir = root / 'in_one'
    if not in_dir.exists():
        in_dir.mkdir()
        Image.fromarray(np.random.default_rng(1).integers(
            0, 255, size=(16, 16, 3), dtype=np.uint8)).save(in_dir / 'a.png')
    extra = [*INT8, *INT8_RUNS[run]]
    _float32_nets(monkeypatch)
    codes = JaxCodes(monkeypatch)
    jax_out = root / f'jax_int8_{run}'
    with jax.disable_jit():
        jax_main(_argv(conf, ckpt, in_dir, jax_out, [
            *extra, '--quant_calibrate_cache', str(root / f'jax_{run}.npz')]))

    cache = root / f'port_{run}.npz'
    want = _png(jax_out / 'a_out.png')
    for attempt in range(2):
        port_out = root / f'port_int8_{run}_{attempt}'
        args = tinfer.parse_args(_argv(conf, ckpt, in_dir, port_out, [
            *extra, '--quant_calibrate_cache', str(cache),
            '--device', 'cpu']))
        sampler = tinfer.build_sampler(
            args, noise_for_seed=lambda seed, device: JaxKeyNoise(
                jax.random.PRNGKey(seed)), cal_draws=_jax_draws)
        assert quant.has_calibration(sampler.wrapper.net) and cache.exists()
        if attempt == 0:
            sampling = codes.used         # the JAX run's sampling codes
            # the second build must load the cache
            monkeypatch.setattr(quant, 'calibrate_sampler', _no_calibration)
        else:
            codes.used = sampling
        tinfer.run(args, sampler)
        got = _png(port_out / 'a_out.png')
        assert got.shape == want.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want)
    codes.done()


def _no_calibration(*args, **kw):
    raise AssertionError('calibrate_sampler ran despite a valid cache')


def test_serving_yaml_precision_sets_quantize(setup, tmp_path):
    """The serving YAML's ``quantize: w8a8``: --precision bf16 clears it (no
    QuantConv), --precision int8 keeps w8a8 at --quantize_min_channels. At
    dim 8 here, so the widths run 8 to 64."""
    from srgd_tpu_torch.nn.quant import quant_convs
    _, _, in_dir, root = setup
    text = open(os.path.join(
        REPO, 'conf/conditional_continuous_linear_df8kost_dim128_tpu_serving'
        '.yaml')).read()
    assert 'quantize: w8a8' in text and 'unet_dim: 128' in text
    conf = tmp_path / 'serving_dim8.yaml'
    conf.write_text(text.replace('unet_dim: 128', 'unet_dim: 8'))

    def net(extra):
        args = tinfer.parse_args(['-c', str(conf), '-m', '', '--input_dir',
                                  str(in_dir), '--output_dir',
                                  str(root / 'never'), '--device', 'cpu',
                                  *extra])
        return tinfer.build_sampler(args).wrapper.net

    assert not quant_convs(net(['--precision', 'bf16']))
    assert not quant_convs(net(['--precision', 'fp32']))
    quantized = net(['--precision', 'int8', '--quantize_min_channels', '32'])
    assert quantized.dtype == torch.bfloat16
    widths = {m.in_channels for _, m in quant_convs(quantized)}
    assert widths and min(widths) >= 32
    assert not quant_convs(net(['--precision', 'int8']))   # 512 > 64
