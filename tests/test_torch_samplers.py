"""The port's DDIM(eta) and DPM-Solver++(2M) samplers against the JAX
package's, untiled and tiled.

Same weights and the same noise as tests/test_torch_sampler.py (injected
``init_noise``/``step_noises`` untiled, the replayed JAX key schedule tiled),
held to the same bar: max error < 5e-4 and PSNR > 60 dB in [0, 1] pixel
space. Plus the two identities tests/test_continuous.py holds the JAX package
to: eta = 1 is the ancestral sampler, and a one-step dpmpp is the eta = 0
update."""

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
from tests.test_torch_sampler import JaxKeyNoise, assert_golden

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

KW = dict(dim=8, dim_mults=(1, 2), full_attn=(False, True),
          learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
          num_classes=3)
SAMPLERS = {'ddim_eta0': dict(sampler='ddim', ddim_eta=0.0),
            'ddim_eta1': dict(sampler='ddim', ddim_eta=1.0),
            'dpmpp': dict(sampler='dpmpp')}


@pytest.fixture(scope='module')
def pair():
    jnet = JaxUnet(**KW)
    params = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)),
                       jnp.zeros((1,)), class_label=jnp.zeros((1,), jnp.int32))
    net = SRUnet(**KW)
    net.load_state_dict(state_dict_from_jax(params['params']), strict=True)
    return jnet, params, net


@pytest.fixture(scope='module')
def untiled_inputs():
    rng = np.random.default_rng(0)
    n_steps = 5
    return dict(
        n_steps=n_steps,
        cond01=rng.uniform(size=(1, 16, 16, 3)).astype(np.float32),
        init=rng.normal(size=(1, 16, 16, 3)).astype(np.float32),
        steps=rng.normal(size=(n_steps, 1, 16, 16, 3)).astype(np.float32),
        label=np.asarray([1]))


def _port_sample(net, inp, n_steps=None, **kw):
    n_steps = n_steps or inp['n_steps']
    d = ContinuousDiffusion(net, image_size=16, num_sample_steps=n_steps, **kw)
    return d.sample(torch.from_numpy(inp['cond01']),
                    torch.from_numpy(inp['label']), class_cond_scale=2.0,
                    init_noise=torch.from_numpy(inp['init']),
                    step_noises=torch.from_numpy(inp['steps'])).numpy()


@pytest.mark.parametrize('name', sorted(SAMPLERS))
def test_sample_matches_jax(pair, untiled_inputs, name):
    """Untiled, class CFG at scale 2 (doubled batch), 5 steps."""
    jnet, params, net = pair
    inp = untiled_inputs
    want = JaxDiffusion(net=jnet, image_size=16, num_sample_steps=inp['n_steps'],
                        **SAMPLERS[name]).sample(
        params, jax.random.PRNGKey(0), jnp.asarray(inp['cond01']),
        jnp.asarray(inp['label']), class_cond_scale=2.0,
        init_noise=jnp.asarray(inp['init']),
        step_noises=jnp.asarray(inp['steps']))
    assert_golden(_port_sample(net, inp, **SAMPLERS[name]), np.asarray(want))


@pytest.mark.parametrize('name', sorted(SAMPLERS))
def test_tiled_sample_matches_jax(pair, name):
    """40x40 condition, tile 32: a 96 canvas, 9 aligned and 4 shifted tiles
    with the margin re-noise, 4 steps, tile batch 4. dpmpp threads its
    previous-x0 canvas across the two grids."""
    jnet, params, net = pair
    rng = np.random.default_rng(1)
    cond01 = rng.uniform(size=(1, 40, 40, 3)).astype(np.float32)
    label = np.asarray([2])
    kw = dict(tile_size=32, batch_size=4, num_sample_steps=4)
    key = jax.random.PRNGKey(23)
    want = JaxDiffusion(net=jnet, image_size=32, **SAMPLERS[name]).tiled_sample(
        params, key, jnp.asarray(cond01), jnp.asarray(label), **kw)
    got = ContinuousDiffusion(net, image_size=32, **SAMPLERS[name]).tiled_sample(
        torch.from_numpy(cond01), torch.from_numpy(label),
        noise=JaxKeyNoise(key), **kw)
    assert_golden(got.numpy(), np.asarray(want))


def test_ddim_eta1_equals_ancestral(pair, untiled_inputs):
    """eta = 1 DDIM is algebraically the ancestral posterior; on the same
    noise the two agree to float tolerance, and eta = 0 does not."""
    _, _, net = pair
    anc = _port_sample(net, untiled_inputs, sampler='ancestral')
    eta1 = _port_sample(net, untiled_inputs, sampler='ddim', ddim_eta=1.0)
    np.testing.assert_allclose(eta1, anc, atol=2e-5, rtol=0)
    eta0 = _port_sample(net, untiled_inputs, sampler='ddim')
    assert np.abs(anc - eta0).max() > 1e-4


def test_dpmpp_one_step_equals_ddim(pair, untiled_inputs):
    """The first 2M step has no history: D = x0, the one-step DDIM update."""
    _, _, net = pair
    a = _port_sample(net, untiled_inputs, n_steps=1, sampler='dpmpp')
    b = _port_sample(net, untiled_inputs, n_steps=1, sampler='ddim')
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # with history the two differ
    a3 = _port_sample(net, untiled_inputs, n_steps=3, sampler='dpmpp')
    b3 = _port_sample(net, untiled_inputs, n_steps=3, sampler='ddim')
    assert np.abs(a3 - b3).max() > 1e-5


class CountingNoise(GeneratorNoise):
    def __init__(self):
        super().__init__(3, 'cpu')
        self.calls = []

    def step(self, i, shape):
        self.calls.append(i)
        return super().step(i, shape)


@pytest.mark.parametrize('name, n_draws', [('ddim_eta0', 0), ('ddim_eta1', 2),
                                           ('dpmpp', 0)])
def test_deterministic_samplers_draw_no_step_noise(pair, name, n_draws):
    """ddim at eta = 0 and dpmpp use no step noise and draw none; the others
    draw one per step but the last. Outputs stay in [0, 1]."""
    _, _, net = pair
    cond = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(1, 40, 40, 3)).astype(np.float32))
    d = ContinuousDiffusion(net, image_size=32, num_sample_steps=3,
                            **SAMPLERS[name])
    for run in (lambda nz: d.tiled_sample(cond, tile_size=32, batch_size=8,
                                          noise=nz),
                lambda nz: d.sample(cond[:, :16, :16], noise=nz)):
        nz = CountingNoise()
        out = run(nz)
        assert len(nz.calls) == n_draws
        assert torch.isfinite(out).all() and 0 <= out.min() and out.max() <= 1


def test_sampler_names_are_checked(pair):
    _, _, net = pair
    with pytest.raises(ValueError, match="unknown continuous sampler 'heun'"):
        ContinuousDiffusion(net, image_size=16, sampler='heun')
