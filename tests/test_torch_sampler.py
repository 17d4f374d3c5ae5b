"""The port's continuous-time ancestral samplers against the JAX package's.

Same weights (a small JAX U-Net through ``state_dict_from_jax``) and the same
noise: the untiled ``sample`` takes injected ``init_noise``/``step_noises``
in both; the tiled sampler's noise source replays the JAX key schedule
(rng -> (rng', init); step i: split(fold_in(rng', i)) -> (step, margin)).
Held to the bar of tests/test_e2e_parity.py: max error < 5e-4 and PSNR > 60
dB in [0, 1] pixel space."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.diffusion.continuous import ContinuousDiffusion as JaxDiffusion
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch.checkpoint import state_dict_from_jax
from srgd_tpu_torch.diffusion.continuous import (ContinuousDiffusion,
                                                 GeneratorNoise)
from srgd_tpu_torch.nn.unet import SRUnet

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

KW = dict(dim=16, dim_mults=(1, 2), full_attn=(False, True),
          learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
          num_classes=3)


@pytest.fixture(scope='module')
def pair():
    jnet = JaxUnet(**KW)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)),
                       jnp.zeros((1,)), class_label=jnp.zeros((1,), jnp.int32))
    net = SRUnet(**KW)
    net.load_state_dict(state_dict_from_jax(params['params']), strict=True)
    return jnet, params, net


def assert_golden(got, want):
    assert got.shape == want.shape
    max_err = np.abs(got - want).max()
    psnr = -10 * np.log10(max(np.mean((got - want) ** 2), 1e-20))
    assert max_err < 5e-4, (max_err, psnr)
    assert psnr > 60, psnr


@pytest.mark.parametrize('mode', ['none', 'cond', 'class'])
def test_sample_matches_jax(pair, mode):
    jnet, params, net = pair
    n_steps = 6
    rng = np.random.default_rng(0)
    cond01 = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    init = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    steps = rng.normal(size=(n_steps, 1, 16, 16, 3)).astype(np.float32)
    label = np.asarray([1])
    kw = dict(cond_scale=1.5 if mode == 'cond' else 1.0,
              class_cond_scale=2.0 if mode == 'class' else 1.0,
              class_guidance_start_steps=2)
    want = JaxDiffusion(net=jnet, image_size=16, num_sample_steps=n_steps).sample(
        params, jax.random.PRNGKey(0), jnp.asarray(cond01), jnp.asarray(label),
        init_noise=jnp.asarray(init), step_noises=jnp.asarray(steps), **kw)
    got = ContinuousDiffusion(net, image_size=16, num_sample_steps=n_steps).sample(
        torch.from_numpy(cond01), torch.from_numpy(label),
        init_noise=torch.from_numpy(init), step_noises=torch.from_numpy(steps),
        **kw)
    assert_golden(got.numpy(), np.asarray(want))


class JaxKeyNoise:
    """The JAX tiled sampler's key schedule, as a port noise source."""

    def __init__(self, rng):
        self.rng, self.init_key = jax.random.split(rng)

    @staticmethod
    def _normal(key, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(key, tuple(shape), jnp.float32)))

    def init(self, shape):
        return self._normal(self.init_key, shape)

    def step(self, i, shape):
        return self._normal(jax.random.split(jax.random.fold_in(self.rng, i))[0],
                            shape)

    def margin(self, i, shape):
        return self._normal(jax.random.split(jax.random.fold_in(self.rng, i))[1],
                            shape)


def test_tiled_sample_matches_jax(pair):
    """40x40 condition, tile 32: a 96 canvas, 9 aligned and 4 shifted tiles
    plus the margin re-noise, 4 steps, class CFG (doubled batch), tile
    batch 4 (remainder chunk padded)."""
    jnet, params, net = pair
    rng = np.random.default_rng(1)
    cond01 = rng.uniform(size=(1, 40, 40, 3)).astype(np.float32)
    label = np.asarray([2])
    kw = dict(tile_size=32, batch_size=4, class_cond_scale=2.0,
              num_sample_steps=4)
    key = jax.random.PRNGKey(17)
    want = JaxDiffusion(net=jnet, image_size=32).tiled_sample(
        params, key, jnp.asarray(cond01), jnp.asarray(label), **kw)
    got = ContinuousDiffusion(net, image_size=32).tiled_sample(
        torch.from_numpy(cond01), torch.from_numpy(label),
        noise=JaxKeyNoise(key), **kw)
    assert_golden(got.numpy(), np.asarray(want))


def test_tiled_sample_is_chunk_invariant(pair):
    """Noise is drawn at canvas resolution, so the tile batch size does not
    change the result. Not bitwise: the CPU convolutions pick their algorithm
    by batch size, which moves float32 sums by ~1e-7 per step; noise that
    followed the chunking would move the output by ~1e-1."""
    _, _, net = pair
    cond = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(1, 40, 40, 3)).astype(np.float32))
    d = ContinuousDiffusion(net, image_size=32, num_sample_steps=3)
    outs = [d.tiled_sample(cond, tile_size=32, batch_size=bs,
                           noise=GeneratorNoise(5, 'cpu')) for bs in (3, 13)]
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=0)


def test_unported_options_raise(pair):
    """Every option of the JAX wrapper is ported; the combinations the JAX
    package refuses stay refused: dpmpp with DeepCache, the learned schedule
    without its net, and both guidance scales at once."""
    _, _, net = pair
    with pytest.raises(NotImplementedError, match='dpmpp'):
        ContinuousDiffusion(net, image_size=16, sampler='dpmpp',
                            deep_cache_interval=2)
    with pytest.raises(ValueError, match='LearnedLogSNR'):
        ContinuousDiffusion(net, image_size=16, noise_schedule='learned')
    d = ContinuousDiffusion(net, image_size=16, deep_cache_interval=2)
    assert d.deep_cache_depth == 2 and d.deep_cache_schedule == ''
    d = ContinuousDiffusion(net, image_size=16)
    with pytest.raises(NotImplementedError, match='cond_scale and class'):
        d.sample(torch.zeros(1, 16, 16, 3), cond_scale=2.0,
                 class_cond_scale=2.0)
