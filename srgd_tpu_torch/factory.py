"""Model factory: Config -> (diffusion wrapper, net).

Counterpart of ``get_model`` in ``srgd_tpu/factory.py`` for the three
families (``continuous``, ``gaussian``, ``elucidated`` and their
``conditional_`` variants). With a checkpoint the net, and a learned log-SNR
schedule, load a reference-format ``.pth`` strictly; without one their
weights are drawn from a generator seeded with ``conf.seed``, the net's
first.
"""

from __future__ import annotations

import logging

import torch

from srgd_tpu_torch.checkpoint import load_reference_checkpoint, split_schedule
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.diffusion.elucidated import ElucidatedDiffusion
from srgd_tpu_torch.diffusion.gaussian import GaussianDiffusion
from srgd_tpu_torch.diffusion.schedules import EDMParams, LearnedLogSNR
from srgd_tpu_torch.nn.unet import build_unet_from_config

logger = logging.getLogger('srgd_tpu_torch')

CONTINUOUS_MODELS = ('continuous', 'conditional_continuous')
GAUSSIAN_MODELS = ('gaussian', 'conditional_gaussian')
ELUCIDATED_MODELS = ('elucidated', 'conditional_elucidated')


def build_wrapper(conf, net, log_snr=None):
    """The family wrapper ``conf.model`` names, around ``net``. ``log_snr``:
    the ``LearnedLogSNR`` module of a continuous model with
    ``noise_schedule: learned``. Sets ``conf.use_dpmpp_solver`` False for the
    continuous and gaussian families, as the reference does."""
    n_stages = len(conf.ddpm_unet_dim_mults.split(','))
    if conf.deep_cache_interval > 1 and not 1 <= conf.deep_cache_depth < n_stages:
        raise ValueError(
            f'deep_cache_depth must be in [1, {n_stages - 1}] for '
            f'{n_stages} U-Net stages, got {conf.deep_cache_depth}')
    cache = dict(deep_cache_interval=conf.deep_cache_interval,
                 deep_cache_depth=conf.deep_cache_depth,
                 deep_cache_schedule=conf.deep_cache_schedule)

    if conf.model in CONTINUOUS_MODELS:
        if not conf.learned_sinusoidal_cond:
            raise ValueError('the continuous family requires '
                             'learned_sinusoidal_cond')
        conf.use_dpmpp_solver = False
        return ContinuousDiffusion(
            net, image_size=conf.image_size,
            noise_schedule=conf.noise_schedule,
            num_sample_steps=conf.num_sample_steps,
            clip_sample_denoised=conf.clip_sample_denoised,
            sampler=conf.continuous_sampler, ddim_eta=conf.ddim_eta,
            log_snr=log_snr, **cache)
    if conf.model in GAUSSIAN_MODELS:
        if conf.learned_sinusoidal_cond:
            raise ValueError('the gaussian family requires '
                             'learned_sinusoidal_cond: false')
        conf.use_dpmpp_solver = False
        return GaussianDiffusion(
            net, image_size=conf.image_size, timesteps=conf.timesteps,
            sampling_timesteps=conf.sampling_timesteps,
            objective=conf.objective, beta_schedule=conf.beta_schedule,
            **cache)
    if conf.model in ELUCIDATED_MODELS:
        if not conf.learned_sinusoidal_cond:
            raise ValueError('the elucidated family requires '
                             'learned_sinusoidal_cond')
        return ElucidatedDiffusion(
            net, image_size=conf.image_size,
            num_sample_steps=conf.num_sample_steps,
            edm=EDMParams(
                sigma_min=conf.sigma_min, sigma_max=conf.sigma_max,
                sigma_data=conf.sigma_data, rho=conf.rho, S_churn=conf.S_churn,
                S_tmin=conf.S_tmin, S_tmax=conf.S_tmax, S_noise=conf.S_noise),
            use_dpmpp_solver=conf.use_dpmpp_solver, **cache)
    raise NotImplementedError(conf.model)


def get_model(conf, ckpt_path: str | None = None, *, device, dtype=None):
    """Build (wrapper, net) on ``device``; ``dtype`` overrides
    ``conf.compute_dtype``."""
    if conf.param_dtype != 'float32':
        raise NotImplementedError('srgd_tpu_torch keeps float32 parameters')
    net = build_unet_from_config(conf, dtype=dtype, device='meta')
    net = net.to_empty(device=device).eval()
    log_snr = None
    if conf.model in CONTINUOUS_MODELS and conf.noise_schedule == 'learned':
        log_snr = LearnedLogSNR(conf.learned_schedule_net_hidden_dim,
                                device=device).eval()
    ckpt_path = ckpt_path if ckpt_path is not None else conf.ckpt_path
    if ckpt_path:
        unet_sd, schedule_sd = split_schedule(
            load_reference_checkpoint(ckpt_path))
        net.load_state_dict(unet_sd, strict=True)
        if log_snr is not None:
            log_snr.load_state_dict(schedule_sd, strict=True)
        elif schedule_sd:
            raise KeyError('the checkpoint holds a learned log-SNR schedule '
                           f'but the config has noise_schedule '
                           f'{conf.noise_schedule!r}')
        logger.info('loaded reference ema_model weights from %s', ckpt_path)
    else:
        gen = torch.Generator().manual_seed(conf.seed)
        net.init_weights(gen)
        if log_snr is not None:
            log_snr.init_weights(gen)
        logger.info('random weights from seed %d (no ckpt_path)', conf.seed)
    return build_wrapper(conf, net, log_snr), net
