"""Reference checkpoints and JAX params as the port's state dict.

The port's parameter names are the reference's torch keys, so a reference
``.pth`` needs no key conversion: ``load_reference_checkpoint`` reads its
``ema_model`` state dict, strips the diffusion wrapper's ``model.``/``net.``
prefix and drops the schedule buffers the samplers rebuild from the config.
``state_dict_from_jax`` turns the JAX package's U-Net params into the same
layout through ``flax_to_torch_unet_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

from srgd_tpu.checkpoint.torch_convert import (
    _BUFFER_KEYS, flax_to_torch_unet_state_dict, strip_wrapper_prefix,
)


def state_dict_from_jax(params, *, pixel_shuffle_upsample: bool = True):
    """JAX U-Net params (a nested dict of arrays) -> the port's state dict
    (float32 CPU tensors)."""
    sd = flax_to_torch_unet_state_dict(params,
                                       pixel_shuffle_upsample=pixel_shuffle_upsample)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def load_reference_checkpoint(path) -> dict:
    """The U-Net state dict of a reference-format ``.pth``: its
    ``ema_model`` entry (or the whole file when it has none), with the
    wrapper prefix stripped and the schedule buffers dropped. Raises
    NotImplementedError for a learned log-SNR schedule and KeyError for any
    other entry outside the U-Net."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt['ema_model'] if 'ema_model' in ckpt else ckpt
    unet_sd, extras = strip_wrapper_prefix(sd)
    extras = {k: v for k, v in extras.items() if not _BUFFER_KEYS.match(k)}
    if any(k.startswith('log_snr.') for k in extras):
        raise NotImplementedError(
            'checkpoints with a learned log-SNR schedule are not ported to '
            'srgd_tpu_torch yet (ROADMAP.md Queue 1 item 11)')
    if extras:
        raise KeyError(f'unexpected non-U-Net keys: {sorted(extras)[:10]}')
    return unet_sd
