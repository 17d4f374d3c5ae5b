"""``--use_pallas`` and ``--continuous_sampler ddim|dpmpp`` of the port's CLI
against the JAX package's CLI on the same weights, input and replayed noise:
each writes a x4 PNG within 1/255 of the other's.

The JAX CLI reaches its Pallas kernels under ``--use_pallas``; they run in
interpret mode per call (the modules import them at call time)."""

import functools

import numpy as np
import pytest
import torch

import jax

from srgd_tpu_torch import infer as tinfer
from tests.test_torch_cli import _argv, _png, setup  # noqa: F401 (fixture)
from tests.test_torch_sampler import JaxKeyNoise

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

FLAGS = {
    'use_pallas': ['--use_pallas'],
    'ddim_eta1': ['--continuous_sampler', 'ddim', '--ddim_eta', '1.0'],
    'ddim_eta0_pallas': ['--continuous_sampler', 'ddim', '--use_pallas'],
    'dpmpp': ['--continuous_sampler', 'dpmpp'],
}


@pytest.fixture
def interpret_kernels(monkeypatch):
    from srgd_tpu.kernels import groupnorm_silu, linear_attention
    for mod, name in ((groupnorm_silu, 'fused_groupnorm_silu'),
                      (linear_attention, 'fused_linear_attention_qkv')):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))


@pytest.mark.parametrize('name', sorted(FLAGS))
def test_port_cli_flags_match_jax_cli(setup, interpret_kernels, name):  # noqa: F811
    conf, ckpt, in_dir, root = setup
    from srgd_tpu.infer import main as jax_main
    jax_out = root / f'jax_{name}'
    jax_main(_argv(conf, ckpt, in_dir, jax_out, FLAGS[name]))

    port_out = root / f'port_{name}'
    args = tinfer.parse_args(_argv(conf, ckpt, in_dir, port_out,
                                   ['--device', 'cpu', *FLAGS[name]]))
    sampler = tinfer.build_sampler(
        args, noise_for_seed=lambda seed, device: JaxKeyNoise(
            jax.random.PRNGKey(seed)))
    if '--use_pallas' in FLAGS[name]:
        assert sampler.wrapper.net.downs[0][0].block1.use_pallas
    assert sampler.wrapper.sampler == (
        args.continuous_sampler or 'ancestral')
    tinfer.run(args, sampler)
    for png in ('a_out.png', 'b_out.png'):
        want, got = _png(jax_out / png), _png(port_out / png)
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1
