"""Model factory: Config -> (diffusion wrapper, net).

Counterpart of ``get_model`` in ``srgd_tpu/factory.py`` for the continuous
family (``continuous`` and ``conditional_continuous``). With a checkpoint the
net loads a reference-format ``.pth`` strictly; without one its weights are
drawn from a generator seeded with ``conf.seed``.
"""

from __future__ import annotations

import logging

import torch

from srgd_tpu_torch.checkpoint import load_reference_checkpoint
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.nn.unet import build_unet_from_config

logger = logging.getLogger('srgd_tpu_torch')

CONTINUOUS_MODELS = ('continuous', 'conditional_continuous')
GAUSSIAN_MODELS = ('gaussian', 'conditional_gaussian')
ELUCIDATED_MODELS = ('elucidated', 'conditional_elucidated')


def build_wrapper(conf, net) -> ContinuousDiffusion:
    if conf.model in CONTINUOUS_MODELS:
        if not conf.learned_sinusoidal_cond:
            raise ValueError('the continuous family requires '
                             'learned_sinusoidal_cond')
        return ContinuousDiffusion(
            net, image_size=conf.image_size,
            noise_schedule=conf.noise_schedule,
            num_sample_steps=conf.num_sample_steps,
            clip_sample_denoised=conf.clip_sample_denoised,
            sampler=conf.continuous_sampler, ddim_eta=conf.ddim_eta,
            deep_cache_interval=conf.deep_cache_interval)
    if conf.model in GAUSSIAN_MODELS + ELUCIDATED_MODELS:
        raise NotImplementedError(
            f'model {conf.model!r} is not ported to srgd_tpu_torch yet '
            '(ROADMAP.md Queue 1 item 11)')
    raise NotImplementedError(conf.model)


def get_model(conf, ckpt_path: str | None = None, *, device, dtype=None):
    """Build (wrapper, net) on ``device``; ``dtype`` overrides
    ``conf.compute_dtype``."""
    if conf.param_dtype != 'float32':
        raise NotImplementedError('srgd_tpu_torch keeps float32 parameters')
    net = build_unet_from_config(conf, dtype=dtype, device='meta')
    net = net.to_empty(device=device).eval()
    ckpt_path = ckpt_path if ckpt_path is not None else conf.ckpt_path
    if ckpt_path:
        net.load_state_dict(load_reference_checkpoint(ckpt_path), strict=True)
        logger.info('loaded reference ema_model weights from %s', ckpt_path)
    else:
        net.init_weights(torch.Generator().manual_seed(conf.seed))
        logger.info('random weights from seed %d (no ckpt_path)', conf.seed)
    return build_wrapper(conf, net), net
