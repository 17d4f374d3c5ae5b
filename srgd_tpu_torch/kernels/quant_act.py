"""The activation quantize in front of every W8A8 convolution: the amax and
the int8 codes. CUDA kernels and their plain versions.

Replaces ``srgd_tpu/nn/quant.py:133`` and ``:153`` (QuantConv's activation
amax: ``jnp.max(jnp.abs(xf))`` over the whole tensor, or per channel for
SmoothQuant's a_c) and ``:160`` (``jnp.clip(jnp.round(xf / x_div), -127,
127).astype(int8)``), XLA ops in the JAX package, not Pallas kernels. The
CUDA source is ``srgd_tpu_torch/csrc/quant_act.cu``:

- ``act_amax``: a grid reduction of |x| (block partials, then one pass over
  them in block order; a max is exact in any order);
- ``quantize_act``: one pass that reads the activation in its NHWC memory
  (the net's channels_last) and writes contiguous NHWC int8 codes, the
  layout ``int8_conv`` reads: an IEEE division by the scalar or per-channel
  divisor, round half to even, clip to +-127.

Both are bound by bytes on the H100: 2 bytes read a bf16 value for the amax,
2 read and 1 written for the quantize, at 3.35 TB/s. The scale arithmetic
around them (``/ 127 + 1e-12``, SmoothQuant's powers) stays in PyTorch ops
on vectors of Cin values, in the JAX order.

The kernels compute exactly what the plain versions compute (the amax is
exact; the division, rounding and clip are the same IEEE float32
operations), so the two agree bit for bit. A CPU tensor takes the plain
version, a CUDA tensor the kernel, which raises rather than fall back or
copy. ``launches`` counts ``quantize_act``'s launches, ``launches_amax``
``act_amax``'s. Times: PERF.md.
"""

from __future__ import annotations

import torch

from srgd_tpu_torch.kernels import _build

launches = 0        # quantize_act launches
launches_amax = 0   # act_amax launches

_DTYPES = (torch.bfloat16, torch.float32)
BLOCKS_PER_SM = 8   # the grids: a full SM's threads of 256-thread blocks


def _check(x, name):
    if x.dtype not in _DTYPES:
        raise TypeError(f'{name} takes bfloat16 or float32, got {x.dtype}')
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f'{name} takes a non-empty (..., C) activation, got '
                         f'{tuple(x.shape)}')


def _divisor(div, c):
    """The divisor as a float32 vector: (1,) for a scalar, (C,) per
    channel."""
    if div.dtype != torch.float32 or div.numel() not in (1, c):
        raise ValueError(f'quantize_act: the divisor must be float32 with 1 '
                         f'or {c} values, got {div.dtype} '
                         f'{tuple(div.shape)}')
    return div.reshape(-1)


def act_amax_plain(x, per_channel: bool = False):
    """max |x| in float32: over every element (a 0-d tensor) or, with
    ``per_channel``, over all but the last dimension ((C,))."""
    a = torch.abs(x.float())
    if per_channel:
        return torch.amax(a, dim=tuple(range(x.dim() - 1)))
    return torch.amax(a)


def quantize_act_plain(x, div):
    """clamp(round(float(x) / div), -127, 127) as int8, ``div`` broadcast
    over the last dimension (a scalar or one value per channel), rounding
    half to even as ``jnp.round`` does."""
    return torch.clamp(torch.round(x.float() / div), -127.0, 127.0).to(
        torch.int8)


def _card_args(x, name):
    if x.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {x.device}')
    if not x.is_contiguous():
        raise ValueError(f'{name} kernel needs a contiguous (..., C) '
                         'activation (an NHWC view of channels_last memory); '
                         'it does not copy')
    c = x.shape[-1]
    rows = x.numel() // c
    if x.numel() >= 2 ** 31:
        raise ValueError(f'{name}: {x.numel()} elements are past the '
                         'kernel\'s int index range')
    vec = int(c % 8 == 0 and x.data_ptr() % 16 == 0)
    return rows, c, vec, int(x.dtype == torch.bfloat16)


def _blocks(x) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        x.device).multi_processor_count


def act_amax(x, per_channel: bool = False):
    """max |x| in float32 of an activation (..., C), bfloat16 or float32:
    over every element (0-d) or per channel ((C,)). CPU: the plain version;
    CUDA: the kernel, on a contiguous ``x``."""
    global launches_amax
    _check(x, 'act_amax')
    if x.device.type == 'cpu':
        return act_amax_plain(x, per_channel)
    rows, c, vec, is_bf16 = _card_args(x, 'act_amax')
    width = c if per_channel else 1
    # block partials: a few per SM, no more than the vectors need
    nparts = max(1, min(_blocks(x), -(-rows * c // (8 if vec else 1)) // 256))
    partials = torch.empty(nparts * width, dtype=torch.int32, device=x.device)
    out = torch.empty(width, dtype=torch.float32, device=x.device)
    fn = _build.entry('srgd_act_amax', 3, 6)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), partials.data_ptr(), out.data_ptr(), rows, c,
                 int(per_channel), is_bf16, vec, nparts, stream)
    _build.check(err, 'srgd_act_amax')
    launches_amax += 1
    return out if per_channel else out.reshape(())


def quantize_act(x, div):
    """int8 codes clamp(round(float(x) / div), -127, 127) of an activation
    (..., C), bfloat16 or float32, ``div`` a float32 scalar or (C,) divisor;
    the codes have ``x``'s shape, contiguous. CPU: the plain version; CUDA:
    the kernel, on a contiguous ``x`` and ``div`` on the same card."""
    global launches
    _check(x, 'quantize_act')
    if x.device.type == 'cpu':
        return quantize_act_plain(x, div)
    rows, c, vec, is_bf16 = _card_args(x, 'quantize_act')
    d = _divisor(div, c)
    if d.device != x.device or not d.is_contiguous():
        raise ValueError('quantize_act: the divisor must be a contiguous '
                         'tensor on the activation\'s device')
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    fn = _build.entry('srgd_quantize_act', 3, 6)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), d.data_ptr(), q.data_ptr(), rows, c,
                 int(d.numel() == c and c > 1), is_bf16, vec, _blocks(x),
                 stream)
    _build.check(err, 'srgd_quantize_act')
    launches += 1
    return q
