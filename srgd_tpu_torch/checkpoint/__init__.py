"""Reference checkpoints and JAX params as the port's state dict, and the
trainer's crash-safe checkpoints.

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

The trainer's state (``save_params``, ``copy_checkpoint``,
``checkpoint_exists``, ``restore_params``: the names and the swap
discipline of ``srgd_tpu/checkpoint/io.py``) is a directory holding one
file in ``torch.save``'s format, ``STATE_FILE``: {params, ema_params,
opt_state, step, best_score}, the parameter dicts keyed by the port's
state-dict names. A save never leaves the previous checkpoint destroyable:
the new state is written to a sibling ``<path>.new`` and swapped in with
directory renames, so at every instant a complete checkpoint exists under
``<path>``, ``<path>.new`` or ``<path>.old``, and ``restore_params`` falls
back in that order. ``load_trained_checkpoint`` reads such a directory's
EMA parameters for sampling, and those of a directory that ``convert``
(``python -m srgd_tpu_torch.checkpoint.convert``, the counterpart of
``srgd_tpu/checkpoint/convert.py``) wrote from a reference ``.pth``, which
holds ``{'ema_params': state dict}`` alone; ``convert --reverse`` writes a
directory back as a reference ``.pth``.
"""

from __future__ import annotations

import logging
import os
import re
import shutil

import numpy as np
import torch

logger = logging.getLogger('srgd_tpu_torch')

STATE_FILE = 'state.pt'

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


def jax_leaf(key: str) -> str:
    """The leaf name, in the JAX param tree, of the entry the port's
    state-dict entry ``key`` converts from, following
    ``flax_to_torch_unet_state_dict`` and the learned schedule's layers: an
    RMSNorm gain ``g``, the learned sinusoidal ``weights``, the class
    ``embedding``, GroupNorm's ``norm_scale`` / ``norm_bias``, and every
    other ``weight`` / ``bias`` a Dense or Conv ``kernel`` / ``bias``."""
    if key.endswith('.g'):
        return 'g'
    if key.endswith('.weights'):
        return 'weights'
    if key == 'class_mlp.0.weight':
        return 'embedding'
    if key.endswith('.norm.weight'):
        return 'norm_scale'
    if key.endswith('.norm.bias'):
        return 'norm_bias'
    if key.endswith('.weight'):
        return 'kernel'
    if key.endswith('.bias'):
        return 'bias'
    raise KeyError(f'no JAX leaf converts to {key!r}')


# the learned schedule's JAX layers and their reference keys (Sequential
# and Residual nesting of the MonotonicLinear stack)
_LOG_SNR_LAYERS = {'l1': 'net.1.net', 'l2': 'net.2.fn.0.net',
                   'l3': 'net.2.fn.2.net'}
_SCHEDULE_PREFIX = 'log_snr.'


# the calibration collections of the JAX variables (srgd_tpu/nn/quant.py):
# static activation stats, their per-time stacks, and the stacks' net times
STATS_TIMES = 'quant_stats_times'
_STATS_COLLECTIONS = {'quant_stats': '', 'quant_stats_t': '_t'}
_STAT_NAMES = ('act_scale', 'act_amax_ch')


def flax_path(module_name: str) -> str:
    """The JAX U-Net's '/'-joined path of the conv that is the port's module
    ``module_name``: ``downs.3.0.block1.proj`` -> ``downs_3_0/block1/proj``,
    ``ups.1.2.to_out.0`` -> ``ups_1_2/to_out``, an upsampler's or
    downsampler's conv (``ups.0.3.net.0``, ``downs.0.3.1``) -> ``.../conv``,
    a last stage's bare conv ``downs.3.3`` -> ``downs_3_3``."""
    parts = module_name.split('.')
    if parts[0] in ('downs', 'ups'):
        head, rest = '_'.join(parts[:3]), parts[3:]
    else:
        head, rest = parts[0], parts[1:]
    rest = {('to_out', '0'): ['to_out'], ('net', '0'): ['conv'],
            ('1',): ['conv']}.get(tuple(rest), rest)
    return '/'.join([head, *rest])


def module_name(path: str, *, pixel_shuffle_upsample: bool = True) -> str:
    """The inverse of ``flax_path`` for the quantized convs of the U-Net."""
    parts = path.split('/')
    stage = re.fullmatch(r'(downs|ups)_(\d+)_(\d+)', parts[0])
    head, rest = ('.'.join(stage.groups()) if stage else parts[0]), parts[1:]
    if rest == ['to_out']:                 # linear attention: (conv, RMSNorm)
        rest = ['to_out', '0']
    elif rest == ['conv']:
        shuffle = stage.group(1) == 'ups' and pixel_shuffle_upsample
        rest = ['net', '0'] if shuffle else ['1']
    return '.'.join([head, *rest])


def _flatten(tree: dict, prefix: str = '') -> dict:
    """A nested dict's leaves under '/'-joined keys."""
    out = {}
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            out.update(_flatten(v, key + '/'))
        else:
            out[key] = v
    return out


def state_dict_from_jax(params, *, pixel_shuffle_upsample: bool = True):
    """JAX params -> the port's state dict (float32 CPU tensors). ``params``
    is the U-Net's param tree, or the whole tree ``{'params': unet[,
    'log_snr': schedule][, 'quant_stats': ...]}``, whose learned schedule
    becomes the reference's ``log_snr.*`` entries (kernels (in, out)
    transposed to (out, in)), and whose calibration collections
    (``quant_stats``, ``quant_stats_t``, ``quant_stats_times``) become
    entries '<module>.act_scale', '<module>.act_amax_ch' (``_t`` for the
    per-time stacks) and ``quant_stats_times``: the quantized convs'
    buffers, which ``split_quant_stats`` separates for
    ``nn.quant.load_stats``."""
    schedule, stats = None, {}
    if 'params' in params:
        for col, suffix in _STATS_COLLECTIONS.items():
            for path, v in _flatten(params.get(col, {})).items():
                conv, _, stat = path.rpartition('/')
                name = module_name(
                    conv, pixel_shuffle_upsample=pixel_shuffle_upsample)
                stats[f'{name}.{stat}{suffix}'] = v
        if STATS_TIMES in params:
            stats[STATS_TIMES] = params[STATS_TIMES]
        params, schedule = params['params'], params.get('log_snr')
    sd = flax_to_torch_unet_state_dict(params,
                                       pixel_shuffle_upsample=pixel_shuffle_upsample)
    for layer, key in _LOG_SNR_LAYERS.items():
        if schedule:
            sd[f'{_SCHEDULE_PREFIX}{key}.weight'] = np.transpose(
                schedule[layer]['kernel'], (1, 0))
            sd[f'{_SCHEDULE_PREFIX}{key}.bias'] = schedule[layer]['bias']
    sd.update(stats)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def split_quant_stats(state_dict) -> tuple[dict, dict]:
    """(the parameters, the quantized convs' calibration stats) of a state
    dict from ``state_dict_from_jax``; the second is empty without
    calibration."""
    params, stats = {}, {}
    for key, val in state_dict.items():
        is_stat = (key == STATS_TIMES
                   or key.rpartition('.')[2].removesuffix('_t') in _STAT_NAMES)
        (stats if is_stat else params)[key] = val
    return params, stats


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
    ``log_snr.*`` entries stay. Any other entry outside the U-Net is logged
    and left out, never raised, as ``convert_checkpoint`` of the JAX
    package returns it among its extras; whether unknown U-Net keys raise
    is ``load_strict``'s, decided where the net loads them
    (``factory.get_model``)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt['ema_model'] if 'ema_model' in ckpt else ckpt
    unet_sd, extras = strip_wrapper_prefix(sd)
    extras = {k: v for k, v in extras.items() if not _BUFFER_KEYS.match(k)}
    schedule = {k: v for k, v in extras.items()
                if k.startswith(_SCHEDULE_PREFIX)}
    unknown = sorted(set(extras) - set(schedule))
    if unknown:
        logger.info('%s: %d entries outside the U-Net left out: %s', path,
                    len(unknown), unknown[:10])
    return {**unet_sd, **schedule}


# ---------------------------------------------------------------------------
# The trainer's checkpoints
# ---------------------------------------------------------------------------

class _TorchCheckpointer:
    """Writes and reads one checkpoint directory. A fresh save writes the
    file under a temporary name and renames it, so a crash never leaves a
    half file named ``STATE_FILE``."""

    def save(self, path: str, item) -> None:
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, STATE_FILE)
        tmp = f'{final}.{os.getpid()}.tmp'
        torch.save(item, tmp)
        os.replace(tmp, final)

    def restore(self, path: str):
        return torch.load(os.path.join(path, STATE_FILE), map_location='cpu',
                          weights_only=True)


def _checkpointer() -> _TorchCheckpointer:
    return _TorchCheckpointer()


def save_params(path: str, params) -> None:
    """Save ``params`` (a dict of tensors and numbers) as the checkpoint
    directory ``path``; the previous checkpoint stays intact until the new
    one is complete."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        tmp = path + '.new'
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        _checkpointer().save(tmp, params)
        os.rename(tmp, path)
        return
    tmp, old = path + '.new', path + '.old'
    for leftover in (tmp, old):        # debris from an earlier crash
        if os.path.exists(leftover):
            shutil.rmtree(leftover)
    _checkpointer().save(tmp, params)  # previous checkpoint still intact
    os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old)


def copy_checkpoint(src: str, dst: str) -> None:
    """Crash-safe file copy of a finished checkpoint directory, with the
    same swap discipline as ``save_params``."""
    src, dst = os.path.abspath(src), os.path.abspath(dst)
    if not os.path.isdir(src):
        raise FileNotFoundError(f'checkpoint {src} does not exist')
    tmp, old = dst + '.new', dst + '.old'
    for leftover in (tmp, old):
        if os.path.exists(leftover):
            shutil.rmtree(leftover)
    shutil.copytree(src, tmp)
    if not os.path.exists(dst):
        os.rename(tmp, dst)
        return
    os.rename(dst, old)
    os.rename(tmp, dst)
    shutil.rmtree(old)


def checkpoint_exists(path: str) -> bool:
    """True if ``restore_params(path)`` has something to restore (including
    the crash-recovery fallbacks)."""
    path = os.path.abspath(path)
    return any(os.path.isdir(path + s) for s in ('', '.new', '.old'))


def restore_params(path: str):
    """The dict ``save_params`` wrote under ``path``, or under ``<path>.new``
    or ``<path>.old`` when a crash mid-swap left only those."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        for suffix in ('.new', '.old'):
            if os.path.isdir(path + suffix):
                logger.warning('checkpoint %s missing; restoring from %s',
                               path, path + suffix)
                path = path + suffix
                break
    return _checkpointer().restore(path)


def load_trained_checkpoint(path) -> dict:
    """The EMA parameters of a checkpoint directory (the trainer's, or
    one ``convert`` wrote), as the port's state dict (a learned schedule's
    entries under ``log_snr.``)."""
    return dict(restore_params(path)['ema_params'])
