"""W8A8 quantized convolution for int8 inference, its calibration and the
calibration cache.

Counterpart of ``srgd_tpu/nn/quant.py``. ``QuantConv`` is the port's
``Conv2d`` with the same ``weight`` and ``bias`` parameters, so a checkpoint
loads unchanged with quantization on or off; quantization happens at apply
time, in float32 whatever the net's dtype, in the JAX order:

- weights: symmetric per-output-channel scales s_w = amax / 127 + 1e-12,
  taken after smoothing, wq = round(w / s_w) (no clip);
- activations: a symmetric per-tensor scale s_x = amax / 127 + 1e-12,
  dynamic (computed each call) or the calibrated static value;
  xq = clamp(round(x / s_x), -127, 127);
- the int8 convolution and its epilogue acc * (s_x * s_w) + bias, cast to
  the net's dtype: ``kernels.int8_conv`` (the CUDA kernel on the card, its
  plain version on the CPU).

On the card the activation's amax and codes are the kernels of
``kernels.quant_act``, which read the activation once in its own dtype and
channels_last memory; on the CPU their plain versions, today's PyTorch
expressions. The weights' codes and scales (``wq``, ``s_w`` and, with
smoothing on recorded a_c, ``s_c``) are computed once and cached: the key is
the weight Parameter, its ``_version`` (in-place writes, ``load_state_dict``)
and its count of ``.data`` accesses (``weight.data.copy_`` bypasses the
version counter), and the recorded a_c tensor and its version where it
feeds them. ``select``, a new statistic and ``calibrating`` all miss the
cache; smoothing on dynamic a_c recomputes the weights every call, as the
JAX package does.

SmoothQuant (``smooth_alpha`` > 0): per-input-channel factors
s_c = a_c^alpha * w_c^(alpha - 1), where a_c and w_c are the activation's and
the weight's per-input-channel amax (1 where either is 0), fold into the
weight, and the activation divides by s_c * s_x over the channel dim of
NCHW.

Calibration state: the JAX ``quant_stats`` collection becomes non-persistent
buffers that exist only after calibration or loading: ``act_scale`` (s_x) or,
with smoothing, ``act_amax_ch`` (a_c); per calibration time, ``act_scale_t``
and ``act_amax_ch_t`` stacked over the times, whose net time inputs the
U-Net keeps in its ``quant_stats_times`` buffer. ``state_dict()`` is the same
with quantization on or off, as the flax param tree is. A QuantConv without
its stat runs dynamic scales. ``diffusion.base.select_time_stats`` picks the
per-time stats of the nearest calibration time before each forward.

The calibration cache is the JAX package's ``.npz`` format: keys
``quant_stats/<flax path>/<stat>``, ``quant_stats_t/...`` and
``quant_stats_times``, plus the JSON fingerprint under ``__meta__``, so a
cache written by either package loads in the other.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Iterable

import numpy as np
import torch
from torch import nn

from srgd_tpu_torch.checkpoint import STATS_TIMES, flax_path
from srgd_tpu_torch.kernels.int8_conv import int8_conv
from srgd_tpu_torch.kernels.quant_act import act_amax, quantize_act
from srgd_tpu_torch.nn.layers import Conv2d

logger = logging.getLogger('srgd_tpu_torch')

_STATS = ('act_scale', 'act_amax_ch')


def _cal_amax(xf, mode: str):
    """The per-call effective amax that calibration records under ``mode``:
    'max', the exact amax, or 'p<pct>', the |x| percentile with
    ``jnp.quantile``'s linear interpolation in float32 (two ``kthvalue``
    picks, not ``torch.quantile``, which refuses inputs over 2^24
    elements). Calibration-time only."""
    if mode == 'max':
        return torch.amax(torch.abs(xf))
    if mode.startswith('p'):
        pct = float(mode[1:])
        if not 0.0 < pct <= 100.0:
            raise ValueError(f'cal_mode percentile out of (0, 100]: {mode!r}')
        v = torch.abs(xf).reshape(-1)
        f32 = dict(dtype=torch.float32, device=v.device)
        n1 = torch.tensor(float(v.numel()), **f32) - 1
        q = torch.tensor(pct / 100.0, **f32) * n1
        low, high = torch.floor(q), torch.ceil(q)
        high_w = q - low
        low_w = 1 - high_w
        pick = [torch.kthvalue(v, int(min(max(float(i), 0.0), float(n1))) + 1)
                .values for i in (low, high)]
        return pick[0] * low_w + pick[1] * high_w
    raise ValueError(f"unknown cal_mode {mode!r}: expected 'max' or 'p<pct>'")


class WatchedParameter(nn.Parameter):
    """A Parameter that counts the accesses to its ``.data`` (``data_reads``):
    a write through ``weight.data`` (``copy_``, assignment) leaves
    ``_version`` as it was, so QuantConv's weight cache keys on this count
    too. Every other operation is a Parameter's."""

    data_reads = 0

    @property
    def data(self):
        self.data_reads += 1
        return torch.Tensor.data.__get__(self)

    @data.setter
    def data(self, value):
        self.data_reads += 1
        torch.Tensor.data.__set__(self, value)


class QuantConv(Conv2d):
    """``Conv2d`` executed as s8 x s8 -> s32 (``kernels.int8_conv``); the
    output is in the compute ``dtype``. Stride 1 and "same" padding, as every
    quantized conv of the U-Net. ``calibrating`` (set by ``calibrate_quant``)
    records running maxima of the activation statistics and uses each call's
    own; otherwise a recorded statistic is used where one exists."""

    def __init__(self, *args, smooth_alpha: float = 0.0, cal_mode: str = 'max',
                 **kw):
        super().__init__(*args, **kw)
        self.weight = WatchedParameter(self.weight.detach(),
                                       self.weight.requires_grad)
        self.smooth_alpha, self.cal_mode = smooth_alpha, cal_mode
        self.calibrating = False
        self._weight_cache = None   # (weight, a_c, key, derived tensors)
        for name in _STATS + tuple(f'{s}_t' for s in _STATS):
            self.register_buffer(name, None, persistent=False)

    def _weights(self, a_c=None):
        """(wq (Cout, kh, kw, Cin) int8, s_w, s_c or None) of the weight,
        smoothed by the recorded a_c when given, from the cache when the same
        weight and a_c tensors hold the same contents. The cache holds both
        tensors, so their identities cannot pass to new ones."""
        w = self.weight
        key = (w._version, getattr(w, 'data_reads', 0), self.smooth_alpha,
               None if a_c is None else a_c._version)
        c = self._weight_cache
        if c is None or c[0] is not w or c[1] is not a_c or c[2] != key:
            c = self._weight_cache = (w, a_c, key, self._quantize_weights(a_c))
        return c[3]

    def _quantize_weights(self, a_c):
        with torch.no_grad():
            wf = self.weight.float()
            s_c = None
            if a_c is not None:
                w_c = torch.amax(torch.abs(wf), dim=(0, 2, 3))
                ok = (a_c > 0.0) & (w_c > 0.0)
                alpha = self.smooth_alpha
                s_c = torch.where(ok, (a_c ** alpha) * (w_c ** (alpha - 1.0)),
                                  torch.ones_like(a_c))
                wf = wf * s_c[None, :, None, None]
            s_w = torch.amax(torch.abs(wf), dim=(1, 2, 3)) / 127.0 + 1e-12
            wq = torch.round(wf / s_w[:, None, None, None]).to(torch.int8)
            return wq.permute(0, 2, 3, 1).contiguous(), s_w, s_c

    def quantize(self, x):
        """(xq NHWC int8, wq (Cout, kh, kw, Cin) int8, scale = s_x * s_w
        float32 (Cout,)) of input ``x`` (NCHW)."""
        on_card = x.device.type == 'cuda'
        # the kernels read x in its own dtype and channels_last memory (a
        # no-op on the net's activations); the CPU route casts first, as
        # the JAX package does
        xa = (x.contiguous(memory_format=torch.channels_last) if on_card
              else x.float())
        xn = xa.permute(0, 2, 3, 1)
        if self.smooth_alpha > 0.0:
            if self.cal_mode != 'max':
                raise ValueError('quantize_cal_mode != max cannot be '
                                 'combined with quantize_smooth_alpha > 0')
            static = not self.calibrating and self.act_amax_ch is not None
            if static:
                a_c = self.act_amax_ch
                wq, s_w, s_c = self._weights(a_c)
            else:
                a_c = act_amax(xn, per_channel=True)
                if self.calibrating:
                    self.act_amax_ch = (
                        a_c if self.act_amax_ch is None
                        else torch.maximum(self.act_amax_ch, a_c))
                # the weights depend on this call's a_c
                wq, s_w, s_c = self._quantize_weights(a_c)
            s_x = torch.amax(a_c / s_c) / 127.0 + 1e-12
            x_div = (s_c * s_x)[None, :, None, None]
        else:
            if self.calibrating:
                dyn = _cal_amax(xa.float(), self.cal_mode) / 127.0 + 1e-12
                self.act_scale = (dyn if self.act_scale is None
                                  else torch.maximum(self.act_scale, dyn))
                s_x = dyn
            elif self.act_scale is not None:
                s_x = self.act_scale
            else:
                s_x = act_amax(xn) / 127.0 + 1e-12
            x_div = s_x
            wq, s_w, _ = self._weights()
        xq = self.quantize_activation(xa, x_div)
        return (xq.contiguous(memory_format=torch.channels_last)
                .permute(0, 2, 3, 1), wq, s_x * s_w)

    @staticmethod
    def quantize_activation(xf, x_div):
        """clamp(round(xf / x_div), -127, 127) as int8 (NCHW, channels_last
        memory on the card), rounding half to even as ``jnp.round`` does:
        ``kernels.quant_act.quantize_act`` on the NHWC view, ``x_div`` a
        scalar or (1, C, 1, 1)."""
        return quantize_act(xf.permute(0, 2, 3, 1),
                            x_div.reshape(-1) if x_div.dim() else x_div
                            ).permute(0, 3, 1, 2)

    def forward(self, x):
        xq, wq, scale = self.quantize(x)
        bias = None if self.bias is None else self.bias.float()
        y = int8_conv(xq, wq, scale.contiguous(), bias,
                      padding=self.padding[0], out_dtype=self.compute_dtype)
        return y.permute(0, 3, 1, 2)          # NCHW view, channels_last

    def select(self, idx) -> None:
        """Take the per-time stats of calibration time ``idx``."""
        for name in _STATS:
            stacked = getattr(self, f'{name}_t')
            if stacked is not None:
                setattr(self, name, stacked[idx])
        self._weight_cache = None


def conv(in_ch: int, out_ch: int, kernel_size: int, *, padding: int = 0,
         bias: bool = True, dtype=torch.float32, device=None,
         quant: str | None = None):
    """``Conv2d`` or its W8A8 twin, keyed on ``quant``: None (float) or
    'w8a8[:<alpha>[:<cal_mode>]]', alpha > 0 turning on SmoothQuant and
    cal_mode picking the calibration estimator ('max' or 'p<pct>')."""
    kw = dict(padding=padding, bias=bias, dtype=dtype, device=device)
    if quant is not None and quant.startswith('w8a8'):
        parts = quant.split(':')
        alpha = float(parts[1]) if len(parts) > 1 else 0.0
        cal_mode = parts[2] if len(parts) > 2 else 'max'
        return QuantConv(in_ch, out_ch, kernel_size, smooth_alpha=alpha,
                         cal_mode=cal_mode, **kw)
    return Conv2d(in_ch, out_ch, kernel_size, **kw)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def quant_convs(net) -> list[tuple[str, QuantConv]]:
    """(module name, module) of every QuantConv in ``net``."""
    return [(n, m) for n, m in net.named_modules() if isinstance(m, QuantConv)]


def clear_stats(net) -> None:
    """Drop every recorded statistic: dynamic scales again."""
    for _, m in quant_convs(net):
        for name in _STATS + tuple(f'{s}_t' for s in _STATS):
            setattr(m, name, None)
    if hasattr(net, 'quant_stats_times'):
        net.quant_stats_times = None


def has_calibration(net) -> bool:
    """Whether any QuantConv of ``net`` carries a recorded statistic."""
    return any(getattr(m, name) is not None for _, m in quant_convs(net)
               for name in _STATS + tuple(f'{s}_t' for s in _STATS))


@torch.no_grad()
def calibrate_quant(net, calls: Iterable) -> bool:
    """Record static activation scales for every QuantConv of ``net``: the
    running max over ``calls``, (args, kwargs) pairs of ``net(*args,
    **kwargs)``, continuing from the stats already recorded (none: zero).
    Returns False, a no-op, when ``net`` has no QuantConv."""
    convs = [m for _, m in quant_convs(net)]
    if not convs:
        return False
    for m in convs:
        m.calibrating = True
    try:
        for args, kwargs in calls:
            net(*args, **kwargs)
    finally:
        for m in convs:
            m.calibrating = False
    return True


@torch.no_grad()
def calibrate_sampler(wrapper, *, generator: torch.Generator | None = None,
                      tile_size: int = 256, batch: int = 4, channels: int = 3,
                      class_label=None, n_times: int = 6, cond_sample=None,
                      margin: float = 1.0, per_time: bool = False,
                      draws=None) -> bool:
    """Calibrate a diffusion wrapper's denoiser for (tiled) sampling, in
    place, starting from zero (recorded stats are dropped first).

    At each of the wrapper's ``calibration_times(n_times)`` the net runs on
    unit-normal latents with a real and a null (all-zero) condition and, for
    a class-conditional net, the class-null call (``class_mask`` 0), as
    ``srgd_tpu.nn.quant.calibrate_sampler`` does. ``draws``: (x, cond), both
    (batch, tile, tile, channels) NHWC, replacing the draws from
    ``generator`` (a CPU generator: x standard normal, then cond uniform in
    [-1, 1]); ``cond_sample``: a (B, H, W, C) condition canvas in [-1, 1]
    whose first image, tiled out if smaller, is the condition instead.
    ``margin`` scales the recorded stats. ``per_time`` records one stats set
    per calibration time (``*_t`` buffers, the times in the net's
    ``quant_stats_times``). Returns whether stats were recorded: False, a
    no-op, when the net has no QuantConv."""
    net = wrapper.net
    if not quant_convs(net):
        return False
    dev = net.init_conv.weight.device
    times = np.asarray(wrapper.calibration_times(n_times), np.float32)
    shape = (batch, tile_size, tile_size, channels)
    if draws is not None:
        x, cond = (torch.as_tensor(np.asarray(d), dtype=torch.float32)
                   for d in draws)
    else:
        x = torch.randn(shape, generator=generator)
        cond = torch.rand(shape, generator=generator) * 2 - 1
    if cond_sample is not None:
        cs = torch.as_tensor(cond_sample[:1]).float()
        if cs.shape[1] < tile_size or cs.shape[2] < tile_size:
            cs = cs.repeat(1, -(-tile_size // cs.shape[1]),
                           -(-tile_size // cs.shape[2]), 1)
        cond = cs[:, :tile_size, :tile_size, :].expand(shape)
    x = x.to(dev).permute(0, 3, 1, 2)
    cond = cond.to(dev).permute(0, 3, 1, 2)
    label = (torch.zeros((batch,), dtype=torch.long, device=dev)
             if class_label is None
             else torch.full((batch,), int(class_label), dtype=torch.long,
                             device=dev))
    has_classes = getattr(net, 'num_classes', None) is not None

    def calls_at(t):
        t_b = torch.full((batch,), float(t), dtype=torch.float32, device=dev)
        calls = []
        for c in (cond, torch.zeros_like(cond)):   # real + CFG-null condition
            kw = dict(cond=c)
            if has_classes:
                kw['class_label'] = label
            calls.append(((x, t_b), kw))
        if has_classes:
            calls.append(((x, t_b), dict(
                cond=cond, class_label=label,
                class_mask=torch.zeros((batch,), dtype=torch.float32,
                                       device=dev))))
        return calls

    clear_stats(net)
    if per_time:
        recorded = []
        for t in times:
            calibrate_quant(net, calls_at(t))
            recorded.append({n: {s: getattr(m, s) for s in _STATS}
                             for n, m in quant_convs(net)})
            clear_stats(net)
        for n, m in quant_convs(net):
            for s in _STATS:
                if recorded[0][n][s] is not None:
                    setattr(m, f'{s}_t', torch.stack(
                        [r[n][s] for r in recorded]) * margin)
        net.quant_stats_times = torch.from_numpy(times).to(dev)
        return True
    calibrate_quant(net, [c for t in times for c in calls_at(t)])
    for _, m in quant_convs(net):
        for s in _STATS:
            if getattr(m, s) is not None:
                setattr(m, s, getattr(m, s) * margin)
    return True


# ---------------------------------------------------------------------------
# The calibration cache
# ---------------------------------------------------------------------------

CAL_CACHE_VERSION = 1
_CAL_COLLECTIONS = ('quant_stats', 'quant_stats_t', STATS_TIMES)


def calibration_fingerprint(conf, *, ckpt_path='', tile_size=256,
                            per_time=False, seed=0, class_label=None,
                            n_times=6, batch=4) -> dict:
    """The meta dict whose exact equality makes a cache valid: the model
    geometry and quantization spec fix which convs carry stats, the sampling
    knobs their values, and the checkpoint's path, size and mtime the
    weights. Field for field ``srgd_tpu.nn.quant.calibration_fingerprint``,
    so the two packages read each other's caches."""
    fp = {
        'version': CAL_CACHE_VERSION,
        'model': conf.model,
        'unet_dim': conf.unet_dim,
        'dim_mults': conf.ddpm_unet_dim_mults,
        'quantize': conf.quantize,
        'quantize_min_channels': conf.quantize_min_channels,
        'quantize_smooth_alpha': float(conf.quantize_smooth_alpha),
        'quantize_cal_mode': getattr(conf, 'quantize_cal_mode', 'max'),
        'per_time': bool(per_time),
        'n_times': int(n_times),
        'batch': int(batch),
        'tile_size': int(tile_size),
        'seed': int(seed),
        'class_label': None if class_label is None else int(class_label),
        'ckpt': str(ckpt_path),
    }
    if ckpt_path and os.path.exists(ckpt_path):
        st = os.stat(ckpt_path)
        fp['ckpt_size'] = st.st_size
        fp['ckpt_mtime'] = int(st.st_mtime)
    return fp


def save_calibration(path, net, meta: dict) -> None:
    """Write the recorded stats of ``net`` to ``path`` (.npz) with the JSON
    fingerprint ``meta``. Raises if nothing was recorded (saving before
    calibrating is a bug, not a cache miss)."""
    per_time = getattr(net, 'quant_stats_times', None) is not None
    flat = {}
    for name, m in quant_convs(net):
        for s in _STATS:
            if per_time and getattr(m, f'{s}_t') is not None:
                flat[f'quant_stats_t/{flax_path(name)}/{s}'] = getattr(
                    m, f'{s}_t')
            elif not per_time and getattr(m, s) is not None:
                flat[f'quant_stats/{flax_path(name)}/{s}'] = getattr(m, s)
    if not flat:
        raise ValueError(
            'save_calibration: the net carries no quant_stats: run '
            'calibrate_sampler first (or the net has no QuantConv at this '
            'quantize_min_channels)')
    if per_time:
        flat['quant_stats_times'] = net.quant_stats_times
    flat = {k: v.detach().float().cpu().numpy() for k, v in flat.items()}
    meta_json = json.dumps(meta, sort_keys=True)
    np.savez(path, __meta__=np.frombuffer(meta_json.encode(), np.uint8),
             **flat)


def load_calibration(path, net, meta: dict):
    """Load a cache written by ``save_calibration`` of either package into
    ``net`` and return ``net`` when its fingerprint equals ``meta``; return
    None, with a warning naming the differing fields, on any mismatch, so the
    caller recalibrates. Raises on a file that is not a calibration cache or
    names a conv the net does not quantize."""
    names = {flax_path(n): n for n, _ in quant_convs(net)}
    with np.load(path) as z:
        if '__meta__' not in z:
            raise ValueError(f'{path}: not a calibration cache (no meta)')
        stored = json.loads(bytes(z['__meta__']).decode())
        if stored != meta:
            diff = sorted(k for k in set(stored) | set(meta)
                          if stored.get(k) != meta.get(k))
            logger.warning('calibration cache %s does not match the current '
                           'model/sampling setup (differs on: %s); '
                           'recalibrating', path, ', '.join(diff))
            return None
        entries = {k: z[k] for k in z.files if k != '__meta__'}
    stats = {}
    for key, value in entries.items():
        col, _, rest = key.partition('/')
        if col not in _CAL_COLLECTIONS:
            raise ValueError(f'{path}: unexpected entry {key!r}')
        if col == STATS_TIMES:
            stats[STATS_TIMES] = value
            continue
        conv_path, _, stat = rest.rpartition('/')
        if conv_path not in names:
            raise ValueError(f'{path}: {key!r} names no quantized conv of '
                             'this net')
        suffix = '_t' if col == 'quant_stats_t' else ''
        stats[f'{names[conv_path]}.{stat}{suffix}'] = value
    load_stats(net, stats)
    return net


def load_stats(net, stats: dict) -> None:
    """Replace the recorded stats of ``net`` with ``stats``: arrays keyed
    '<module name>.<buffer>' (``act_scale``, ``act_amax_ch`` and their
    per-time ``_t`` stacks) and ``quant_stats_times``, as
    ``checkpoint.split_quant_stats`` returns them."""
    dev = net.init_conv.weight.device
    updates = []
    for key, value in stats.items():
        tensor = torch.as_tensor(np.array(value, np.float32)).to(dev)
        if key == STATS_TIMES:
            updates.append((net, key, tensor))
            continue
        module, _, name = key.rpartition('.')
        m = net.get_submodule(module)
        if (not isinstance(m, QuantConv)
                or name.removesuffix('_t') not in _STATS):
            raise ValueError(f'{key!r} is no statistic of a quantized conv')
        updates.append((m, name, tensor))
    clear_stats(net)
    for module, name, tensor in updates:
        setattr(module, name, tensor)
