"""The port's DeepCache against the JAX package's, on the same weights.

A 3-stage dim-16 U-Net, so that both cache depths (1, 2) exist, loaded into
the port through ``state_dict_from_jax``. The contracts of
tests/test_deep_cache.py, held in the port:

- fresh-cache identity: a cached forward fed the cache of the same (x, t)
  equals the full forward bit for bit, for both kernel sets, and the full
  forward and its cache agree with the JAX net's at f32 atol 1e-4;
- DeepCache that refreshes on every step (interval 1, or an every-step
  schedule) is plain sampling, bit for bit, untiled and tiled;
- cached sampling at interval 2 and on a non-uniform schedule, untiled and
  tiled, matches the JAX sampler's on the same noise at the samplers' bar
  (max error < 5e-4, PSNR > 60 dB);
- ``refresh_mask`` is the JAX function; the refusals are the JAX ones.
The other families' DeepCache runs are in tests/test_torch_families.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.diffusion.base import refresh_mask as jax_refresh_mask
from srgd_tpu.diffusion.continuous import ContinuousDiffusion as JaxDiffusion
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch.checkpoint import state_dict_from_jax
from srgd_tpu_torch.config import Config
from srgd_tpu_torch.diffusion.base import GeneratorNoise, refresh_mask
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.factory import build_wrapper
from srgd_tpu_torch.nn.unet import SRUnet
from tests.test_torch_sampler import JaxKeyNoise, assert_golden

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

KW = dict(dim=16, dim_mults=(1, 2, 4), full_attn=(False, False, True),
          learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
          num_classes=3)
FLAGS = {'default': {},
         'use_pallas': dict(use_pallas=True, use_pallas_attention=True,
                            fused_linattn=False)}


@pytest.fixture(scope='module')
def nets():
    jnet = JaxUnet(**KW)
    params = jnet.init(jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 3)),
                       jnp.zeros((1,)), class_label=jnp.zeros((1,), jnp.int32))
    sd = state_dict_from_jax(params['params'])
    ports = {}
    for name, flags in FLAGS.items():
        ports[name] = SRUnet(**KW, **flags)
        ports[name].load_state_dict(sd, strict=True)
    return jnet, params, ports


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize('flags', sorted(FLAGS))
@pytest.mark.parametrize('depth', [1, 2])
def test_fresh_cache_identity(nets, depth, flags):
    jnet, params, ports = nets
    net = ports[flags]
    rng = np.random.default_rng(depth)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.asarray([0.3, -1.2], np.float32)
    label = np.asarray([0, 2])
    args = (_nchw(x), torch.from_numpy(t))
    kw = dict(cond=_nchw(cond), class_label=torch.from_numpy(label))
    with torch.inference_mode():
        full = net(*args, **kw)
        out, cache = net(*args, **kw, cache_depth=depth, return_cache=True)
        cached = net(*args, **kw, cache_depth=depth, deep_cache=cache)
    assert torch.equal(out, full)
    assert torch.equal(cached, full)
    assert tuple(cache.shape) == (2, 16 * (1, 2, 4)[depth - 1],
                                  16 >> (depth - 1), 16 >> (depth - 1))

    want, want_cache = jnet.apply(
        params, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond),
        class_label=jnp.asarray(label), cache_depth=depth, return_cache=True)
    np.testing.assert_allclose(full.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(cache.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_cache), atol=1e-4, rtol=0)


def test_cache_depth_bounds_are_checked(nets):
    net = nets[2]['default']
    x, t = torch.zeros(1, 3, 16, 16), torch.zeros(1)
    for depth in (0, 3):
        with pytest.raises(ValueError, match='cache_depth'):
            net(x, t, cache_depth=depth, return_cache=True)
    with torch.inference_mode():
        _, cache = net(x, t, cache_depth=1, return_cache=True)
    with pytest.raises(ValueError, match='cannot also produce'):
        net(x, t, cache_depth=1, deep_cache=cache, return_cache=True)


# an every-step refresh, spelled as interval 1 and as a schedule on interval 3
EVERY_STEP = {'interval1': dict(deep_cache_interval=1),
              'schedule_1.0x1': dict(deep_cache_interval=3,
                                     deep_cache_schedule='1.0x1')}


@pytest.mark.parametrize('tiled', [False, True], ids=['untiled', 'tiled'])
@pytest.mark.parametrize('every', sorted(EVERY_STEP))
def test_every_step_refresh_is_plain_sampling(nets, every, tiled):
    """Bit for bit, with cond CFG (the cache's pair axis) and
    generation_start_steps, so the counter starts past 0."""
    net = nets[2]['default']
    size = 24 if tiled else 16
    cond = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(1, size, size, 3)).astype(np.float32))
    label = torch.tensor([1])
    kw = dict(cond_scale=1.5, num_sample_steps=5, generation_start_steps=1)
    outs = []
    for dc in ({}, EVERY_STEP[every]):
        d = ContinuousDiffusion(net, image_size=16, deep_cache_depth=2, **dc)
        if tiled:
            outs.append(d.tiled_sample(cond, label, tile_size=16, batch_size=2,
                                       noise=GeneratorNoise(4, 'cpu'), **kw))
        else:
            outs.append(d.sample(cond, label, noise=GeneratorNoise(4, 'cpu'),
                                 **kw))
    assert torch.equal(outs[0], outs[1])


# interval 2 refreshes at per-parity counters 0 and 2; '1x1/3x3' at 0 and 1
CACHED = {'interval2_depth2': dict(deep_cache_interval=2, deep_cache_depth=2),
          'schedule_depth1': dict(deep_cache_interval=3, deep_cache_depth=1,
                                  deep_cache_schedule='1x1/3x3')}


@pytest.mark.parametrize('case', sorted(CACHED))
def test_tiled_cached_sampling_matches_jax(nets, case):
    """40x40 condition, 32-px tiles, 6 steps with class CFG: full and
    cached steps on both grid parities; the per-parity cache stacks hold
    the padded tile batches."""
    jnet, params, ports = nets
    cond01 = np.random.default_rng(6).uniform(
        size=(1, 40, 40, 3)).astype(np.float32)
    label = np.asarray([2])
    kw = dict(tile_size=32, batch_size=4, class_cond_scale=2.0,
              num_sample_steps=6)
    key = jax.random.PRNGKey(21)
    want = JaxDiffusion(net=jnet, image_size=32, **CACHED[case]).tiled_sample(
        params, key, jnp.asarray(cond01), jnp.asarray(label), **kw)
    got = ContinuousDiffusion(ports['default'], image_size=32,
                              **CACHED[case]).tiled_sample(
        torch.from_numpy(cond01), torch.from_numpy(label),
        noise=JaxKeyNoise(key), **kw)
    assert_golden(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('sampler', ['ancestral', 'ddim'])
def test_untiled_cached_sampling_matches_jax(nets, sampler):
    """Interval 2 at depth 2, cond CFG, 6 steps, injected noise."""
    jnet, params, ports = nets
    rng = np.random.default_rng(7)
    cond01 = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    init = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    steps = rng.normal(size=(6, 1, 16, 16, 3)).astype(np.float32)
    label = np.asarray([1])
    dc = dict(sampler=sampler, ddim_eta=1.0, deep_cache_interval=2,
              deep_cache_depth=2, num_sample_steps=6)
    want = JaxDiffusion(net=jnet, image_size=16, **dc).sample(
        params, jax.random.PRNGKey(0), jnp.asarray(cond01),
        jnp.asarray(label), cond_scale=1.5, init_noise=jnp.asarray(init),
        step_noises=jnp.asarray(steps))
    got = ContinuousDiffusion(ports['default'], image_size=16, **dc).sample(
        torch.from_numpy(cond01), torch.from_numpy(label), cond_scale=1.5,
        init_noise=torch.from_numpy(init), step_noises=torch.from_numpy(steps))
    assert_golden(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('schedule, interval, n', [
    ('', 2, 6), ('', 3, 5), ('', 1, 4), ('0.5x3,0.5x1', 2, 8),
    ('0.5x3/0.5x1', 2, 8), ('2x2,2x1', 2, 7), ('1x9', 2, 3),
    ('1.0x3', 3, 10), ('1x1/3x3', 3, 4), ('0.25x4, 0.5x2 ,0.25x1', 2, 13),
    ('0.5x3/0.5x1', 3, 0)])
def test_refresh_mask_matches_jax(schedule, interval, n):
    np.testing.assert_array_equal(refresh_mask(schedule, interval, n),
                                  jax_refresh_mask(schedule, interval, n))


def test_refusals(nets):
    net = nets[2]['default']
    with pytest.raises(NotImplementedError, match='dpmpp'):
        ContinuousDiffusion(net, image_size=16, sampler='dpmpp',
                            deep_cache_interval=2)
    conf = Config(model='conditional_continuous', unet_dim=16,
                  ddpm_unet_dim_mults='1,2,4', full_attn='False,False,True',
                  deep_cache_interval=2, deep_cache_depth=3)
    with pytest.raises(ValueError, match='deep_cache_depth'):
        build_wrapper(conf, net)
    conf.deep_cache_depth = 2
    assert build_wrapper(conf, net).deep_cache_depth == 2
