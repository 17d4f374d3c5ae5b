"""The port's gaussian and elucidated families and the learned log-SNR
schedule against the JAX package's, on the same weights and noise.

Two-stage dim-16 U-Nets loaded into the port through ``state_dict_from_jax``
(the gaussian family's takes the integer timestep through the plain
sinusoidal embedding). The port's noise sources replay the JAX keys:
untiled, the init key of ``split(rng)`` and ``fold_in(rng', i)`` per step
(``UntiledJaxKeyNoise``); tiled, tests/test_torch_sampler.JaxKeyNoise. Held
to the samplers' bar: max error < 5e-4 and PSNR > 60 dB in [0, 1] pixel
space.

The gaussian family runs T = 12 (DDIM, 6 steps) or T = 8 (ancestral) on the
sigmoid beta schedule: the linear one has beta_end = (1000 / T) 0.02 > 1 at
so few steps, as in the reference."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.diffusion.continuous import ContinuousDiffusion as JaxContinuous
from srgd_tpu.diffusion.elucidated import ElucidatedDiffusion as JaxElucidated
from srgd_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussian
from srgd_tpu.diffusion.gaussian import ddim_time_pairs as jax_ddim_time_pairs
from srgd_tpu.diffusion.schedules import (init_learned_log_snr,
                                          learned_log_snr,
                                          make_discrete_schedule as
                                          jax_discrete_schedule)
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch.checkpoint import split_schedule, state_dict_from_jax
from srgd_tpu_torch.diffusion import schedules
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.diffusion.elucidated import ElucidatedDiffusion
from srgd_tpu_torch.diffusion.gaussian import GaussianDiffusion, ddim_time_pairs
from srgd_tpu_torch.nn.unet import SRUnet
from tests.test_torch_sampler import JaxKeyNoise, assert_golden

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once


class UntiledJaxKeyNoise:
    """The JAX untiled samplers' key schedule, as a port noise source."""

    def __init__(self, rng):
        self.rng, self.init_key = jax.random.split(rng)

    @staticmethod
    def _normal(key, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(key, tuple(shape), jnp.float32)))

    def init(self, shape):
        return self._normal(self.init_key, shape)

    def step(self, i, shape):
        return self._normal(jax.random.fold_in(self.rng, i), shape)


def _pair(learned_sinusoidal_cond, seed):
    kw = dict(dim=16, dim_mults=(1, 2), full_attn=(False, True),
              learned_sinusoidal_cond=learned_sinusoidal_cond,
              learned_sinusoidal_dim=8, num_classes=3)
    jnet = JaxUnet(**kw)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                       jnp.zeros((1,)), class_label=jnp.zeros((1,), jnp.int32))
    net = SRUnet(**kw)
    net.load_state_dict(state_dict_from_jax(params['params']), strict=True)
    return jnet, params, net


@pytest.fixture(scope='module')
def gauss_pair():
    return _pair(False, 8)


@pytest.fixture(scope='module')
def edm_pair():
    return _pair(True, 9)


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(10)
    return dict(cond16=rng.uniform(size=(1, 16, 16, 3)).astype(np.float32),
                cond40=rng.uniform(size=(1, 40, 40, 3)).astype(np.float32),
                label=np.asarray([1]))


def _untiled(jax_wrapper, port_wrapper, inputs, seed, **kw):
    key = jax.random.PRNGKey(seed)
    want = jax_wrapper.sample(jax_wrapper.params, key,
                              jnp.asarray(inputs['cond16']),
                              jnp.asarray(inputs['label']), **kw)
    got = port_wrapper.sample(torch.from_numpy(inputs['cond16']),
                              torch.from_numpy(inputs['label']),
                              noise=UntiledJaxKeyNoise(key), **kw)
    assert_golden(got.numpy(), np.asarray(want))
    return got


def _tiled(jax_wrapper, port_wrapper, inputs, seed, **kw):
    key = jax.random.PRNGKey(seed)
    kw = dict(tile_size=32, batch_size=4, **kw)
    want = jax_wrapper.tiled_sample(jax_wrapper.params, key,
                                    jnp.asarray(inputs['cond40']),
                                    jnp.asarray(inputs['label']), **kw)
    got = port_wrapper.tiled_sample(torch.from_numpy(inputs['cond40']),
                                    torch.from_numpy(inputs['label']),
                                    noise=JaxKeyNoise(key), **kw)
    assert_golden(got.numpy(), np.asarray(want))
    return got


def _wrappers(pair, jax_cls, port_cls, **kw):
    jnet, params, net = pair
    jw = jax_cls(net=jnet, image_size=16, **kw)
    jw.params = params
    return jw, port_cls(net, image_size=16, **kw)


# ---------------------------------------------------------------------------
# gaussian
# ---------------------------------------------------------------------------

DDIM = dict(timesteps=12, sampling_timesteps=6, beta_schedule='sigmoid')
ANCESTRAL = dict(timesteps=8, sampling_timesteps=None, beta_schedule='sigmoid')


@pytest.mark.parametrize('beta_schedule', ['linear', 'cosine', 'sigmoid'])
def test_discrete_schedule_matches_jax(beta_schedule):
    got = schedules.make_discrete_schedule(beta_schedule, 1000)
    want = jax_discrete_schedule(beta_schedule, 1000, 'pred_v')
    assert got.num_timesteps == 1000
    for field in dataclasses.fields(got):
        if field.name != 'num_timesteps':
            np.testing.assert_array_equal(getattr(got, field.name),
                                          np.asarray(getattr(want, field.name)))
    for total, steps in ((1000, 250), (12, 6), (1000, 7), (8, 8)):
        np.testing.assert_array_equal(ddim_time_pairs(total, steps),
                                      jax_ddim_time_pairs(total, steps))


@pytest.mark.parametrize('objective', ['pred_noise', 'pred_x0', 'pred_v'])
@pytest.mark.parametrize('loop', ['ddim', 'ancestral'])
def test_gaussian_sample_matches_jax(gauss_pair, inputs, loop, objective):
    """Class CFG at scale 2 with a 1-step guidance warmup."""
    kw = dict(DDIM if loop == 'ddim' else ANCESTRAL, objective=objective)
    jw, pw = _wrappers(gauss_pair, JaxGaussian, GaussianDiffusion, **kw)
    assert pw.is_ddim_sampling == (loop == 'ddim')
    _untiled(jw, pw, inputs, 1, class_cond_scale=2.0,
             class_guidance_start_steps=1)


@pytest.mark.parametrize('case', ['cond_cfg', 'class_cfg_cached'])
def test_gaussian_tiled_ddim_matches_jax(gauss_pair, inputs, case):
    """Tiled DDIM, 6 steps: cond CFG with generation_start_steps 2, and
    class CFG with DeepCache at interval 2 (depth 1)."""
    dc = dict(deep_cache_interval=2, deep_cache_depth=1) if 'cached' in case \
        else {}
    jw, pw = _wrappers(gauss_pair, JaxGaussian, GaussianDiffusion, **DDIM,
                       **dc)
    run = (dict(class_cond_scale=2.0) if dc
           else dict(cond_scale=1.5, generation_start_steps=2))
    _tiled(jw, pw, inputs, 2, **run)


@pytest.mark.parametrize('loop', ['ddim', 'ancestral'])
def test_gaussian_cached_sample_matches_jax(gauss_pair, inputs, loop):
    kw = dict(DDIM if loop == 'ddim' else ANCESTRAL, deep_cache_interval=2,
              deep_cache_depth=1)
    jw, pw = _wrappers(gauss_pair, JaxGaussian, GaussianDiffusion, **kw)
    _untiled(jw, pw, inputs, 3, cond_scale=1.5)


# ---------------------------------------------------------------------------
# elucidated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('start', [0, 2], ids=['start0', 'start2'])
@pytest.mark.parametrize('solver', ['heun', 'dpmpp'])
def test_elucidated_sample_matches_jax(edm_pair, inputs, solver, start):
    """5 steps with class CFG, from white noise and from step 2
    (generation_start_steps), through the use_dpmpp_solver dispatch."""
    jw, pw = _wrappers(edm_pair, JaxElucidated, ElucidatedDiffusion,
                       num_sample_steps=5,
                       use_dpmpp_solver=solver == 'dpmpp')
    _untiled(jw, pw, inputs, 4, class_cond_scale=2.0,
             generation_start_steps=start)


@pytest.mark.parametrize('solver', ['heun', 'dpmpp'])
def test_elucidated_cached_sample_matches_jax(edm_pair, inputs, solver):
    """DeepCache at interval 2, depth 1: Heun refreshes on its mask with
    both evaluations full; DPM++ refreshes uniformly."""
    jw, pw = _wrappers(edm_pair, JaxElucidated, ElucidatedDiffusion,
                       num_sample_steps=5, use_dpmpp_solver=solver == 'dpmpp',
                       deep_cache_interval=2, deep_cache_depth=1)
    _untiled(jw, pw, inputs, 5, class_cond_scale=2.0)


@pytest.mark.parametrize('case', ['class_cfg', 'start1_cached'])
def test_elucidated_tiled_heun_matches_jax(edm_pair, inputs, case):
    """Tiled Heun, 5 steps with class CFG: the churn at canvas level and the
    margin re-noise at the current sigma; then from step 1 with DeepCache
    at interval 2."""
    dc = (dict(deep_cache_interval=2, deep_cache_depth=1)
          if 'cached' in case else {})
    jw, pw = _wrappers(edm_pair, JaxElucidated, ElucidatedDiffusion,
                       num_sample_steps=5, **dc)
    _tiled(jw, pw, inputs, 6, class_cond_scale=2.0,
           generation_start_steps=1 if dc else 0)


def test_edm_schedule_and_preconditioners_match_jax():
    from srgd_tpu.diffusion.schedules import EDMParams as JaxEDM
    got, want = schedules.EDMParams(S_churn=40.0), JaxEDM(S_churn=40.0)
    for n in (5, 32):
        sig = got.sample_schedule(n)
        np.testing.assert_array_equal(sig, want.sample_schedule(n))
        np.testing.assert_array_equal(got.gammas(sig, n), want.gammas(sig, n))
    sig = got.sample_schedule(32)[:-1]
    for name in ('c_in', 'c_skip', 'c_out', 'c_noise'):
        mine = np.asarray([getattr(got, name)(s) for s in sig])
        assert mine.dtype == np.float32
        np.testing.assert_allclose(mine, np.asarray(getattr(want, name)(
            jnp.asarray(sig))), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# learned log-SNR schedule
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def learned(edm_pair):
    jnet, params, net = edm_pair
    tree = {'params': params['params'],
            'log_snr': init_learned_log_snr(jax.random.PRNGKey(12),
                                            hidden_dim=32)}
    unet_sd, schedule_sd = split_schedule(state_dict_from_jax(tree))
    assert sorted(unet_sd) == sorted(net.state_dict())
    log_snr = schedules.LearnedLogSNR(32)
    log_snr.load_state_dict(schedule_sd, strict=True)
    return jnet, tree, net, log_snr


def test_learned_schedule_matches_jax(learned):
    _, tree, _, log_snr = learned
    t = np.linspace(0.0, 1.0, 101).astype(np.float32)
    with torch.no_grad():
        got = log_snr(torch.from_numpy(t)).numpy()
    want = np.asarray(learned_log_snr(tree['log_snr'], jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got[0] == pytest.approx(schedules.LOG_SNR_MAX, rel=1e-4)
    assert got[-1] == pytest.approx(schedules.LOG_SNR_MIN, rel=1e-4)
    assert np.all(np.diff(got) <= 1e-5)


@pytest.mark.parametrize('sampler', ['ancestral', 'ddim'])
def test_learned_schedule_sampling_matches_jax(learned, inputs, sampler):
    """The continuous sampler's table comes from the learned net: 5 steps,
    class CFG, injected noise."""
    jnet, tree, net, log_snr = learned
    rng = np.random.default_rng(13)
    init = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    steps = rng.normal(size=(5, 1, 16, 16, 3)).astype(np.float32)
    kw = dict(noise_schedule='learned', num_sample_steps=5, sampler=sampler,
              ddim_eta=1.0)
    want = JaxContinuous(net=jnet, image_size=16, **kw).sample(
        tree, jax.random.PRNGKey(0), jnp.asarray(inputs['cond16']),
        jnp.asarray(inputs['label']), class_cond_scale=2.0,
        init_noise=jnp.asarray(init), step_noises=jnp.asarray(steps))
    got = ContinuousDiffusion(net, image_size=16, log_snr=log_snr, **kw).sample(
        torch.from_numpy(inputs['cond16']), torch.from_numpy(inputs['label']),
        class_cond_scale=2.0, init_noise=torch.from_numpy(init),
        step_noises=torch.from_numpy(steps))
    assert_golden(got.numpy(), np.asarray(want))


def test_learned_schedule_needs_its_module(edm_pair):
    net = edm_pair[2]
    with pytest.raises(ValueError, match='LearnedLogSNR'):
        ContinuousDiffusion(net, image_size=16, noise_schedule='learned')
    with pytest.raises(ValueError, match='LearnedLogSNR'):
        ContinuousDiffusion(net, image_size=16,
                            log_snr=schedules.LearnedLogSNR(4))
