"""How far reduced-precision sampling moves the port's output: the
counterpart of ``tools/quality_probe.py``.

    python -m srgd_tpu_torch.tools.quality_probe

The same tiled sampling (the same noise, flagship-geometry weights) runs in
each requested mode and every mode's output is compared with the first
mode's: PSNR, max|d| and the PSNR after both are rounded to uint8, in the
JAX probe's line format, so one parser (``parse_lines``) reads both tools.

Env knobs, those of the JAX probe: QP_LR (128: LR size, the canvas is 4x),
QP_STEPS (50), QP_DIM (128), QP_MODES ('float32,bfloat16'; 'w8a8' = bf16
with W8A8 int8 convs on calibrated activation scales, 'w8a8dyn' the same
with dynamic scales, 'w8a8t' per-timestep calibrated scales; '@<alpha>'
adds SmoothQuant smoothing, e.g. 'w8a8dyn@0.5'; '%<cal_mode>' the
calibration estimator, e.g. 'w8a8%p99.9'; '+dcN[.D][@SCHED]' DeepCache at
interval N, depth D (2), refresh schedule SCHED, e.g. 'bfloat16+dc2.2'),
QP_QMIN (0: quantize the blocks at least this wide), QP_WSEED / QP_CSEED
(0 / 1: the random weights' and the condition's seeds), QP_CONF (a YAML in
place of the flagship config; QP_DIM is then ignored), QP_SAVE_DIR (save
each mode's canvas as .npy as it lands). Port additions: QP_DEVICE (cuda;
``cpu`` runs the kernels' plain versions) and QP_CKPT, which names a
checkpoint directory the port's trainer wrote (its EMA weights) or a
reference-format ``.pth``; an orbax directory of the JAX trainer cannot be
read without JAX. The sampler and the calibration run on 256-px tiles, as
the JAX probe's do.

Each mode samples with ``GeneratorNoise(71)``, seed 71 as the JAX probe's
key; bf16 modes store the weights in bf16 (``param_dtype``), as the JAX
probe casts its params. Random weights come from ``SRUnet.init_weights``
with QP_WSEED, the condition from a CPU generator seeded with QP_CSEED.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

import numpy as np
import torch

from srgd_tpu_torch.checkpoint import (
    load_reference_checkpoint, load_trained_checkpoint,
)
from srgd_tpu_torch.config import Config, load_config
from srgd_tpu_torch.diffusion.base import GeneratorNoise
from srgd_tpu_torch.factory import get_model
from srgd_tpu_torch.infer import resolve_device
from srgd_tpu_torch.nn.quant import calibrate_sampler

NOISE_SEED = 71
BATCH_SIZE = 8
TILE_SIZE = 256
# the two kinds of line both probes print
SAMPLED_RE = re.compile(r'^(?P<mode>\S+): sampled (?P<px>\d+)px, '
                        r'(?P<steps>\d+) steps in (?P<seconds>[\d.]+)s$')
PSNR_RE = re.compile(
    r'^(?P<mode>\S+) vs (?P<ref>\S+): PSNR (?P<psnr>-?[\d.]+) dB  '
    r'\(max\|d\| (?P<max_abs>[\d.]+), uint8-quantized PSNR '
    r'(?P<psnr_uint8>-?[\d.]+) dB\)$')


def flagship_conf(unet_dim: int = 128) -> Config:
    """The shipped flagship geometry (``__graft_entry__._flagship_conf``):
    conditional continuous, dim ``unet_dim``, mults 1,2,4,8, full attention
    at the last stage, learned sinusoidal time, 3 classes."""
    return Config(
        model='conditional_continuous', noise_schedule='linear',
        num_sample_steps=250, unet_dim=unet_dim,
        ddpm_unet_dim_mults='1,2,4,8', full_attn='False,False,False,True',
        learned_sinusoidal_cond=True, learned_sinusoidal_dim=32,
        num_classes=3, image_size=256)


def parse_mode(mode: str) -> tuple[dict, str]:
    """(the Config fields of ``mode``, its base: 'float32', 'bfloat16',
    'w8a8', 'w8a8dyn' or 'w8a8t')."""
    mode_q, _, dc_spec = mode.partition('+dc')
    fields = dict(deep_cache_interval=0, deep_cache_schedule='')
    if dc_spec:
        dc_spec, _, sched = dc_spec.partition('@')
        n, _, d = dc_spec.partition('.')
        fields.update(deep_cache_interval=int(n),
                      deep_cache_depth=int(d) if d else 2,
                      deep_cache_schedule=sched)
    base, _, alpha = mode_q.partition('@')
    quantized = base.startswith('w8a8')
    base, _, cal_mode = base.partition('%')
    dtype = 'bfloat16' if quantized else base
    fields.update(compute_dtype=dtype, param_dtype=dtype,
                  quantize='w8a8' if quantized else 'none',
                  quantize_smooth_alpha=float(alpha) if alpha else 0.0,
                  quantize_cal_mode=cal_mode or 'max')
    return fields, base


def random_weights(conf: Config, seed: int, device) -> dict:
    """Weights of ``conf``'s net (and learned schedule) drawn from
    ``seed``, as a state dict on ``device``."""
    wrapper, net = get_model(dataclasses.replace(
        conf, seed=seed, compute_dtype='float32', param_dtype='float32',
        quantize='none', deep_cache_interval=0), '', device=device)
    weights = dict(net.state_dict())
    log_snr = getattr(wrapper, 'log_snr', None)
    if log_snr is not None:
        weights.update({f'log_snr.{k}': v
                        for k, v in log_snr.state_dict().items()})
    return weights


def load_weights(path: str) -> dict:
    """A trainer checkpoint directory's EMA weights, or a reference
    ``.pth``'s, as a state dict."""
    if os.path.isdir(path):
        return load_trained_checkpoint(path)
    return load_reference_checkpoint(path)


def build_mode(conf: Config, mode: str, weights: dict, cond, device,
               qmin: int = 0):
    """The diffusion wrapper of one mode on ``weights``, calibrated on
    tiles of the condition ``cond`` (B, H, W, C in [0, 1]) for 'w8a8' and
    'w8a8t'."""
    fields, base = parse_mode(mode)
    conf = dataclasses.replace(conf, quantize_min_channels=qmin, **fields)
    wrapper, _ = get_model(conf, '', device=device, state_dict=weights)
    if base in ('w8a8', 'w8a8t'):
        calibrate_sampler(wrapper, generator=torch.Generator().manual_seed(7),
                          tile_size=TILE_SIZE, cond_sample=cond * 2.0 - 1.0,
                          per_time=base == 'w8a8t')
    return wrapper


def sample(wrapper, cond, label, *, steps: int, noise):
    """(the tiled sampler's output as float32 numpy, seconds)."""
    t0 = time.perf_counter()
    out = wrapper.tiled_sample(cond, label, batch_size=BATCH_SIZE,
                               tile_size=TILE_SIZE, num_sample_steps=steps,
                               noise=noise)
    out = out.float().cpu().numpy()
    return out, time.perf_counter() - t0


def sample_mode(conf: Config, mode: str, weights: dict, cond, label, *,
                steps: int, device, qmin: int = 0, noise=None):
    """One mode's tiled sampling of ``cond`` with ``label`` (None or (B,)):
    (float32 numpy output, seconds). ``noise``: the noise source, by
    default ``GeneratorNoise(71, device)``."""
    wrapper = build_mode(conf, mode, weights, cond, device, qmin)
    if noise is None:
        noise = GeneratorNoise(NOISE_SEED, device)
    return sample(wrapper, cond, label, steps=steps, noise=noise)


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    """PSNR of ``b`` against ``a``, their max|d|, and the PSNR of the two
    rounded to uint8 levels (what users see)."""
    mse = float(np.mean((a - b) ** 2))
    qa = np.round(a * 255) / 255
    qb = np.round(b * 255) / 255
    mse_q = float(np.mean((qa - qb) ** 2))
    return {'psnr': -10 * np.log10(max(mse, 1e-20)),
            'max_abs': float(np.abs(a - b).max()),
            'psnr_uint8': -10 * np.log10(max(mse_q, 1e-20))}


def psnr_line(mode: str, ref: str, a: np.ndarray, b: np.ndarray) -> str:
    c = compare(a, b)
    return (f'{mode} vs {ref}: PSNR {c["psnr"]:.2f} dB  '
            f'(max|d| {c["max_abs"]:.4f}, uint8-quantized PSNR '
            f'{c["psnr_uint8"]:.2f} dB)')


def parse_lines(text: str) -> dict:
    """The 'sampled' and 'vs' lines of either probe's output, by mode."""
    got = {'sampled': {}, 'psnr': {}}
    for line in text.splitlines():
        for key, pattern in (('sampled', SAMPLED_RE), ('psnr', PSNR_RE)):
            m = pattern.match(line.strip())
            if m:
                got[key][m['mode']] = {
                    k: (v if k in ('mode', 'ref') else float(v))
                    for k, v in m.groupdict().items()}
    return got


def run(conf: Config, modes: list, weights: dict, cond, label, *,
        steps: int, device, qmin: int = 0, save_dir: str = '',
        noise_for_seed=GeneratorNoise) -> tuple[dict, dict]:
    """Sample every mode and compare each with ``modes[0]`` as it lands,
    printing the probe's lines; ``noise_for_seed(71, device)`` makes each
    mode's noise source. Returns ({mode: output}, {mode: seconds})."""
    outs, seconds = {}, {}
    hr = cond.shape[1]
    ref = modes[0]
    for mode in modes:
        out, secs = sample_mode(conf, mode, weights, cond, label, steps=steps,
                                device=device, qmin=qmin,
                                noise=noise_for_seed(NOISE_SEED, device))
        print(f'{mode}: sampled {hr}px, {steps} steps in {secs:.1f}s',
              flush=True)
        outs[mode], seconds[mode] = out, secs
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            # schedule modes hold '/', which would name a subdirectory
            name = mode.replace('@', '_a').replace('/', '-')
            np.save(os.path.join(save_dir, f'{name}.npy'), out)
        if mode != ref and ref in outs:
            print(psnr_line(mode, ref, outs[ref], out), flush=True)
    return outs, seconds


def main():
    env = os.environ.get
    lr, steps = int(env('QP_LR', 128)), int(env('QP_STEPS', 50))
    device = resolve_device(env('QP_DEVICE', 'cuda'))
    conf = (load_config(env('QP_CONF')) if env('QP_CONF')
            else flagship_conf(int(env('QP_DIM', 128))))
    ckpt = env('QP_CKPT', '')
    weights = (load_weights(ckpt) if ckpt
               else random_weights(conf, int(env('QP_WSEED', 0)), device))
    hr = lr * 4
    cond = torch.rand((1, hr, hr, 3), generator=torch.Generator().manual_seed(
        int(env('QP_CSEED', 1)))).to(device)
    label = torch.zeros((1,), dtype=torch.long, device=device)
    return run(conf, env('QP_MODES', 'float32,bfloat16').split(','), weights,
               cond, label, steps=steps, device=device,
               qmin=int(env('QP_QMIN', 0)), save_dir=env('QP_SAVE_DIR', ''))


if __name__ == '__main__':
    main()
