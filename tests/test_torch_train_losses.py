"""The three families' training losses against the JAX package's.

The same U-Net weights in both packages (drawn by the port's
``init_weights`` and carried into JAX by its converter), the same batch,
and the port's draw source replaying the JAX loss's keys
(``tests.test_torch_train.JaxDraws``), over seeds whose whole-batch
uniforms both drop and keep the condition and the class. float32, relative
bar 1e-5 on the loss; with the learned log-SNR schedule also the gradients,
the U-Net's within 1e-4 and the schedule's within 1e-2 of their largest
(``SCHEDULE_GRAD_RTOL``). Tiny sizes: dim 16, mults 1,2, 16 px, batch 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.checkpoint.torch_convert import convert_unet_state_dict
from srgd_tpu.diffusion.continuous import ContinuousDiffusion as JaxContinuous
from srgd_tpu.diffusion.elucidated import ElucidatedDiffusion as JaxElucidated
from srgd_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussian
from srgd_tpu.diffusion.schedules import EDMParams as JaxEDM
from srgd_tpu.diffusion.schedules import init_learned_log_snr
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch.checkpoint import split_schedule, state_dict_from_jax
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.diffusion.elucidated import ElucidatedDiffusion
from srgd_tpu_torch.diffusion.gaussian import GaussianDiffusion
from srgd_tpu_torch.diffusion.schedules import EDMParams, LearnedLogSNR
from srgd_tpu_torch.nn.unet import SRUnet
from tests.test_torch_train import ROLES, JaxDraws, assert_rel

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

LOSS_RTOL = 1e-5
# the learned-schedule loss's gradients, within these fractions of the
# largest gradient of the U-Net and of the schedule: the schedule's
# normalisation (f(t) - f(0)) / (f(1) - f(0)) cancels in float32, and its
# gradients differ from XLA's by up to about 2e-3 of their largest
SCHEDULE_GRAD_RTOL = {'net': 1e-4, 'log_snr': 1e-2}
DROP = 0.5   # both dropout probabilities


def _seeds(family):
    """The first seeds whose draws, at probability DROP, drop and keep the
    condition and drop and keep the class, each at least once."""
    seeds, seen = [], set()
    for s in range(64):
        keys = dict(zip(ROLES[family], jax.random.split(
            jax.random.PRNGKey(s), len(ROLES[family]))))
        new = {(role, bool(jax.random.uniform(keys[role], ()) < DROP))
               for role in ('drop_cond', 'drop_class')} - seen
        if new:
            seeds.append(s)
            seen |= new
        if len(seen) == 4:
            return seeds
    raise AssertionError(f'no seeds cover both dropout outcomes: {seen}')


def _net_pair(learned_sinusoidal_cond, seed):
    kw = dict(dim=16, dim_mults=(1, 2), full_attn=(False, True),
              learned_sinusoidal_cond=learned_sinusoidal_cond,
              learned_sinusoidal_dim=8, num_classes=3)
    net = SRUnet(**kw)
    net.init_weights(torch.Generator().manual_seed(seed))
    params, unmatched = convert_unet_state_dict(
        {k: v.detach().numpy() for k, v in net.state_dict().items()},
        num_stages=2)
    assert not unmatched
    return JaxUnet(**kw), {'params': params}, net


@pytest.fixture(scope='module')
def cont_pair():
    return _net_pair(True, 0)


@pytest.fixture(scope='module')
def gauss_pair():
    return _net_pair(False, 2)


@pytest.fixture(scope='module')
def batch():
    rng = np.random.default_rng(7)
    hr = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    return hr, cond, np.array([1, 2], np.int32)


def _losses(jwrap, pwrap, params, batch, family, param_tensors=()):
    """The two wrappers' losses over ``_seeds(family)`` at the relative bar;
    with ``param_tensors``, yields the JAX gradients after the port's
    backward of each seed."""
    hr, cond, label = batch

    def loss(p, rng):
        return jwrap.loss(p, rng, jnp.asarray(hr), jnp.asarray(cond),
                          jnp.asarray(label))

    fn = jax.jit(jax.value_and_grad(loss) if param_tensors
                 else lambda p, rng: (loss(p, rng), None))
    for s in _seeds(family):
        rng = jax.random.PRNGKey(s)
        want, jgrads = fn(params, rng)
        for p in param_tensors:
            p.grad = None
        got = pwrap.loss(torch.from_numpy(hr), torch.from_numpy(cond),
                         torch.from_numpy(label).long(),
                         draws=JaxDraws(rng, family))
        assert_rel(got, np.asarray(want), LOSS_RTOL, f'{family} loss {s}')
        if param_tensors:
            got.backward()
            yield jgrads


@pytest.mark.parametrize('case', ['l2', 'l1', 'smooth_l1', 'min_snr'])
def test_continuous_loss_matches_jax(cont_pair, batch, case):
    jnet, params, net = cont_pair
    kw = dict(cond_drop_prob=DROP, class_cond_drop_prob=DROP,
              loss_type='l2' if case == 'min_snr' else case,
              min_snr_loss_weight=case == 'min_snr', min_snr_gamma=5.0)
    jw = JaxContinuous(net=jnet, image_size=16, **kw)
    pw = ContinuousDiffusion(net, image_size=16, **kw)
    list(_losses(jw, pw, params, batch, 'continuous'))


@pytest.mark.parametrize('frac_gradient', [1.0, 0.5])
def test_continuous_learned_schedule_loss_and_gradients_match_jax(
        cont_pair, batch, frac_gradient):
    """The learned log-SNR net's gradients come back through the loss, and
    the U-Net's too (``LearnedLogSNR.forward`` keeps its graph)."""
    jnet, params, net = cont_pair
    full = dict(params)
    full['log_snr'] = init_learned_log_snr(jax.random.PRNGKey(9), 16)
    unet_sd, schedule_sd = split_schedule(state_dict_from_jax(full))
    log_snr = LearnedLogSNR(16)
    log_snr.load_state_dict(schedule_sd, strict=True)
    kw = dict(noise_schedule='learned', cond_drop_prob=DROP,
              class_cond_drop_prob=DROP,
              learned_noise_schedule_frac_gradient=frac_gradient)
    jw = JaxContinuous(net=jnet, image_size=16, **kw)
    pw = ContinuousDiffusion(net, image_size=16, log_snr=log_snr, **kw)
    tensors = [*net.parameters(), *log_snr.parameters()]
    for jgrads in _losses(jw, pw, full, batch, 'continuous', tensors):
        got = {k: p.grad for k, p in net.named_parameters()}
        got.update({f'log_snr.{k}': p.grad
                    for k, p in log_snr.named_parameters()})
        want = state_dict_from_jax(jgrads)
        assert sorted(got) == sorted(want)
        for part in ('net', 'log_snr'):
            names = [k for k in want if k.startswith('log_snr.') ==
                     (part == 'log_snr')]
            scale = max(float(want[k].abs().max()) for k in names)
            for k in names:
                err = float((got[k] - want[k]).abs().max())
                assert err <= SCHEDULE_GRAD_RTOL[part] * scale, (k, err, scale)


@pytest.mark.parametrize('case', ['pred_noise', 'pred_x0', 'pred_v',
                                  'pred_v_min_snr_offset'])
def test_gaussian_loss_matches_jax(gauss_pair, batch, case):
    jnet, params, net = gauss_pair
    objective = case[:6] if case.startswith('pred_v') else case
    extra = case.endswith('offset')
    kw = dict(timesteps=12, objective=objective, beta_schedule='sigmoid',
              cond_drop_prob=DROP, class_cond_drop_prob=DROP,
              min_snr_loss_weight=extra, offset_noise_strength=0.1 * extra,
              loss_type='smooth_l1' if extra else 'l2')
    jw = JaxGaussian(net=jnet, image_size=16, **kw)
    pw = GaussianDiffusion(net, image_size=16, **kw)
    list(_losses(jw, pw, params, batch, 'gaussian'))


@pytest.mark.parametrize('loss_type', ['l2', 'l1'])
def test_elucidated_loss_matches_jax(cont_pair, batch, loss_type):
    jnet, params, net = cont_pair
    kw = dict(cond_drop_prob=DROP, class_cond_drop_prob=DROP,
              loss_type=loss_type)
    jw = JaxElucidated(net=jnet, image_size=16,
                       edm=JaxEDM(P_mean=-1.0, P_std=1.4), **kw)
    pw = ElucidatedDiffusion(net, image_size=16,
                             edm=EDMParams(P_mean=-1.0, P_std=1.4), **kw)
    list(_losses(jw, pw, params, batch, 'elucidated'))


def test_loss_without_a_label_draws_no_class_dropout(cont_pair, batch):
    """An unconditional batch (no label) gives the JAX loss too, and the
    class-dropout draw is never asked for."""
    jnet, params, net = cont_pair
    hr, cond, _ = batch

    class NoClassDraws(JaxDraws):
        def uniform(self, name, shape):
            assert name != 'drop_class'
            return super().uniform(name, shape)

    kw = dict(cond_drop_prob=DROP, class_cond_drop_prob=DROP)
    jw = JaxContinuous(net=jnet, image_size=16, **kw)
    pw = ContinuousDiffusion(net, image_size=16, **kw)
    rng = jax.random.PRNGKey(4)
    want = jax.jit(lambda p: jw.loss(p, rng, jnp.asarray(hr),
                                     jnp.asarray(cond)))(params)
    got = pw.loss(torch.from_numpy(hr), torch.from_numpy(cond),
                  draws=NoClassDraws(rng, 'continuous'))
    assert_rel(got, np.asarray(want), LOSS_RTOL)
