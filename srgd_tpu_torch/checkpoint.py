"""Reference checkpoints and JAX params as the port's state dict.

The port's parameter names are the reference's torch keys, so a reference
``.pth`` needs no key conversion: ``load_reference_checkpoint`` reads its
``ema_model`` state dict, strips the diffusion wrapper's ``model.``/``net.``
prefix and drops the schedule buffers the samplers rebuild from the config.
A learned log-SNR schedule keeps its ``log_snr.*`` keys, which
``split_schedule`` separates for ``schedules.LearnedLogSNR``.
``state_dict_from_jax`` turns the JAX package's params (the U-Net's, or the
whole tree with a learned schedule) into the same layout. ``_BUFFER_KEYS``, ``strip_wrapper_prefix`` and
``flax_to_torch_unet_state_dict`` are the port's own copies of the functions
of those names in ``srgd_tpu/checkpoint/torch_convert.py``;
tests/test_torch_hygiene.py holds them to the originals.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_WRAPPER_PREFIXES = ('model.', 'net.')

# wrapper-level schedule buffers the reference registers; the samplers
# rebuild them from the config
_BUFFER_KEYS = re.compile(
    r'^(betas|alphas_cumprod|alphas_cumprod_prev|sqrt_alphas_cumprod|'
    r'sqrt_one_minus_alphas_cumprod|log_one_minus_alphas_cumprod|'
    r'sqrt_recip_alphas_cumprod|sqrt_recipm1_alphas_cumprod|'
    r'posterior_variance|posterior_log_variance_clipped|'
    r'posterior_mean_coef1|posterior_mean_coef2|loss_weight)$')


def strip_wrapper_prefix(state_dict):
    """Split a diffusion-wrapper state dict into (unet_sd, extras); extras
    keeps the entries outside the U-Net (schedule buffers, a learned
    log-SNR net)."""
    unet_sd, extras = {}, {}
    for key, val in state_dict.items():
        for pref in _WRAPPER_PREFIXES:
            if key.startswith(pref):
                unet_sd[key[len(pref):]] = val
                break
        else:
            extras[key] = val
    return unet_sd, extras


def _oihw(w):
    """Conv kernel HWIO -> OIHW."""
    return np.transpose(w, (3, 2, 0, 1))


def _linear(mod: dict, key: str, out: dict):
    out[f'{key}.weight'] = np.transpose(mod['kernel'], (1, 0))
    out[f'{key}.bias'] = mod['bias']


def _conv(mod: dict, key: str, out: dict):
    out[f'{key}.weight'] = _oihw(mod['kernel'])
    if 'bias' in mod:
        out[f'{key}.bias'] = mod['bias']


def _resnet(mod: dict, key: str, out: dict):
    _linear(mod['mlp'], f'{key}.mlp.1', out)
    for b in ('block1', 'block2'):
        _conv(mod[b]['proj'], f'{key}.{b}.proj', out)
        out[f'{key}.{b}.norm.weight'] = mod[b]['norm_scale']
        out[f'{key}.{b}.norm.bias'] = mod[b]['norm_bias']
    if 'res_conv' in mod:
        _conv(mod['res_conv'], f'{key}.res_conv', out)


def _attn(mod: dict, key: str, out: dict):
    out[f'{key}.norm.g'] = np.reshape(mod['norm']['g'], (1, -1, 1, 1))
    _conv(mod['to_qkv'], f'{key}.to_qkv', out)
    if 'out_norm' in mod:   # linear attention: to_out is (conv1x1, RMSNorm)
        _conv(mod['to_out'], f'{key}.to_out.0', out)
        out[f'{key}.to_out.1.g'] = np.reshape(mod['out_norm']['g'],
                                              (1, -1, 1, 1))
    else:
        _conv(mod['to_out'], f'{key}.to_out', out)


def flax_to_torch_unet_state_dict(params: dict, *,
                                  pixel_shuffle_upsample: bool = True,
                                  dtype=np.float32) -> dict:
    """JAX U-Net params -> the reference's U-Net-relative torch keys (numpy
    values; OIHW convs, (out, in) linears, (1, C, 1, 1) RMSNorm gains).

    The tree itself says what each stage holds: an ``out_norm`` marks linear
    attention, a top-level ``kernel`` the bare conv of a last stage; only the
    pixel-shuffle or nearest upsampler's Sequential index needs the flag."""
    out: dict = {}
    _conv(params['init_conv'], 'init_conv', out)
    tm = params['time_mlp']
    if 'pos_emb' in tm:       # learned sinusoidal (Sequential index 0)
        out['time_mlp.0.weights'] = tm['pos_emb']['weights']
    _linear(tm['fc1'], 'time_mlp.1', out)
    _linear(tm['fc2'], 'time_mlp.3', out)
    if 'class_mlp' in params:
        cm = params['class_mlp']
        out['class_mlp.0.weight'] = cm['emb']['embedding']
        _linear(cm['fc1'], 'class_mlp.1', out)
        _linear(cm['fc2'], 'class_mlp.3', out)

    n_stages = 1 + max(int(k.split('_')[1]) for k in params
                       if k.startswith('downs_'))
    for updown in ('downs', 'ups'):
        for i in range(n_stages):
            for j in (0, 1):
                _resnet(params[f'{updown}_{i}_{j}'], f'{updown}.{i}.{j}', out)
            _attn(params[f'{updown}_{i}_2'], f'{updown}.{i}.2', out)
            tail = params[f'{updown}_{i}_3']
            if 'kernel' in tail:                       # bare last-stage conv
                _conv(tail, f'{updown}.{i}.3', out)
            elif updown == 'ups' and pixel_shuffle_upsample:
                _conv(tail['conv'], f'{updown}.{i}.3.net.0', out)
            else:             # Downsample and NearestUpsample: Sequential 1
                _conv(tail['conv'], f'{updown}.{i}.3.1', out)
    _resnet(params['mid_block1'], 'mid_block1', out)
    _attn(params['mid_attn'], 'mid_attn', out)
    _resnet(params['mid_block2'], 'mid_block2', out)
    _resnet(params['final_res_block'], 'final_res_block', out)
    _conv(params['final_conv'], 'final_conv', out)
    return {k: np.asarray(v, dtype) for k, v in out.items()}


# the learned schedule's JAX layers and their reference keys (Sequential
# and Residual nesting of the MonotonicLinear stack)
_LOG_SNR_LAYERS = {'l1': 'net.1.net', 'l2': 'net.2.fn.0.net',
                   'l3': 'net.2.fn.2.net'}
_SCHEDULE_PREFIX = 'log_snr.'


def state_dict_from_jax(params, *, pixel_shuffle_upsample: bool = True):
    """JAX params -> the port's state dict (float32 CPU tensors). ``params``
    is the U-Net's param tree, or the whole tree ``{'params': unet[,
    'log_snr': schedule]}``, whose learned schedule becomes the reference's
    ``log_snr.*`` entries (kernels (in, out) transposed to (out, in))."""
    schedule = None
    if 'params' in params:
        params, schedule = params['params'], params.get('log_snr')
    sd = flax_to_torch_unet_state_dict(params,
                                       pixel_shuffle_upsample=pixel_shuffle_upsample)
    for layer, key in _LOG_SNR_LAYERS.items():
        if schedule:
            sd[f'{_SCHEDULE_PREFIX}{key}.weight'] = np.transpose(
                schedule[layer]['kernel'], (1, 0))
            sd[f'{_SCHEDULE_PREFIX}{key}.bias'] = schedule[layer]['bias']
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def split_schedule(state_dict) -> tuple[dict, dict]:
    """(U-Net entries, learned-schedule entries without their ``log_snr.``
    prefix) of a state dict; the second is empty without a learned
    schedule."""
    unet_sd, schedule_sd = {}, {}
    for key, val in state_dict.items():
        if key.startswith(_SCHEDULE_PREFIX):
            schedule_sd[key[len(_SCHEDULE_PREFIX):]] = val
        else:
            unet_sd[key] = val
    return unet_sd, schedule_sd


def load_reference_checkpoint(path) -> dict:
    """The state dict of a reference-format ``.pth``: its ``ema_model``
    entry (or the whole file when it has none), with the wrapper prefix
    stripped and the schedule buffers dropped; a learned log-SNR schedule's
    ``log_snr.*`` entries stay. Raises KeyError for any other entry outside
    the U-Net."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt['ema_model'] if 'ema_model' in ckpt else ckpt
    unet_sd, extras = strip_wrapper_prefix(sd)
    extras = {k: v for k, v in extras.items() if not _BUFFER_KEYS.match(k)}
    schedule = {k: v for k, v in extras.items()
                if k.startswith(_SCHEDULE_PREFIX)}
    unknown = sorted(set(extras) - set(schedule))
    if unknown:
        raise KeyError(f'unexpected non-U-Net keys: {unknown[:10]}')
    return {**unet_sd, **schedule}
