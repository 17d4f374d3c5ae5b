"""GroupNorm + optional FiLM + SiLU: a CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``srgd_tpu/kernels/groupnorm_silu.py``
(``fused_groupnorm_silu``). The CUDA source is
``srgd_tpu_torch/csrc/groupnorm_silu.cu``.

What bounds it on the H100: memory. There is no product: the function reads
x and writes an output of the same size, and the kernel reads x a second
time (statistics, then normalise). The chain it replaces in ``Block``
(float32 ``F.group_norm`` behind a cast and a layout copy, FiLM, SiLU, the
cast back) moves the activation through device memory many more times. What
the design does about it: 16-byte loads over consecutive channels of the
channels-last activation, per-block partial sums folded in a fixed order (no
atomics, so the result does not change from run to run), the GroupNorm affine
and the FiLM merged into one multiply-add per element, and no float32 copy of
the activation anywhere. Times at the flagship shapes: PERF.md.
"""

from __future__ import annotations

import torch

from srgd_tpu_torch.kernels import _build

launches = 0   # kernel launches through groupnorm_silu (never the plain version)

TARGET_BLOCKS = 1056   # statistics blocks to aim for: eight per SM of an H100
MIN_CHUNK_ROWS = 64    # a statistics block reads at least this many rows


def groupnorm_silu_plain(x, gamma, beta, film=None, *, groups: int = 8,
                         eps: float = 1e-5):
    """Plain PyTorch version with the kernel's arithmetic: per-channel sum
    and sum of squares in float32, group mean and ``E[x^2] - mean^2``, the
    affine and FiLM folded into one (scale, shift) per (batch, channel), then
    ``silu(x * scale + shift)`` cast to x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, c).float()
    rows, cg = xf.shape[1], c // groups
    count = float(rows * cg)
    gsum = xf.sum(dim=1).reshape(b, groups, cg).sum(dim=2)
    gsumsq = (xf * xf).sum(dim=1).reshape(b, groups, cg).sum(dim=2)
    mean = gsum / count
    var = gsumsq / count - mean * mean
    inv = torch.rsqrt(var + eps)
    scale = inv.repeat_interleave(cg, dim=1) * gamma.float()[None]
    shift = beta.float()[None] - mean.repeat_interleave(cg, dim=1) * scale
    if film is not None:
        fs = film[:, 0].float() + 1.0
        scale, shift = scale * fs, shift * fs + film[:, 1].float()
    y = xf * scale[:, None] + shift[:, None]
    return (y * torch.sigmoid(y)).to(x.dtype).reshape(x.shape)


def _chunks(b: int, rows: int) -> tuple[int, int]:
    """(rows_per_chunk, nchunk) of the statistics pass: about TARGET_BLOCKS
    blocks over b * nchunk, none shorter than MIN_CHUNK_ROWS."""
    nchunk = max(1, min(-(-rows // MIN_CHUNK_ROWS), -(-TARGET_BLOCKS // b)))
    per = -(-rows // nchunk)
    return per, -(-rows // per)


def _launch(x, gamma, beta, film, groups, eps):
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'groupnorm_silu kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    if x.dim() < 3:
        raise ValueError('groupnorm_silu takes x of shape (b, ..., c)')
    if not x.is_contiguous():
        raise ValueError(
            'groupnorm_silu kernel needs x contiguous with the channel last '
            '(the NHWC view of a channels_last activation); it does not copy')
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c) if b * c else 0
    if rows == 0:
        raise ValueError(f'groupnorm_silu: empty input {tuple(x.shape)}')
    if c % groups or c > 4096 or rows * c >= 2 ** 31:
        raise ValueError(f'groupnorm_silu kernel needs c divisible by groups, '
                         f'c <= 4096 and rows * c < 2**31; got c {c}, groups '
                         f'{groups}, rows {rows}')
    dev = x.device
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    for t in (gamma, beta):
        if t.device != dev or t.shape != (c,):
            raise ValueError('gamma and beta must be (c,) on the device of x')
    film_ptr = None
    if film is not None:
        film = film.float().contiguous()
        if film.device != dev or film.shape != (b, 2, c):
            raise ValueError('film must be (b, 2, c) on the device of x')
        film_ptr = film.data_ptr()

    per, nchunk = _chunks(b, rows)
    part = torch.empty((b, nchunk, 2, c), device=dev, dtype=torch.float32)
    ss = torch.empty((b, 2, c), device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    vec = 8 if x.dtype == torch.bfloat16 else 4
    vectorised = int(c % vec == 0 and x.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0)
    name = ('srgd_groupnorm_silu_bf16' if x.dtype == torch.bfloat16
            else 'srgd_groupnorm_silu_f32')
    fn = _build.entry(name, 7, 7, 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), film_ptr,
                 part.data_ptr(), ss.data_ptr(), out.data_ptr(), b, rows, c,
                 groups, per, nchunk, vectorised, eps, stream)
    _build.check(err, name)
    launches += 1
    return out


def groupnorm_silu(x, gamma, beta, film=None, *, groups: int = 8,
                   eps: float = 1e-5):
    """``silu(GroupNorm(x) * (fs + 1) + fb)``; signature of
    ``fused_groupnorm_silu``.

    x: (b, h, w, c) or (b, rows, c), contiguous with the channel last; gamma,
    beta: (c,); film: None or (b, 2, c) with ``[:, 0]`` the FiLM scale and
    ``[:, 1]`` the FiLM shift. Returns x's shape and dtype. A CPU tensor takes
    the plain version, a CUDA tensor the CUDA kernel (which raises rather
    than fall back or copy); anything else raises. Forward only: training is
    not ported."""
    if x.device.type == 'cpu':
        return groupnorm_silu_plain(x, gamma, beta, film, groups=groups,
                                    eps=eps)
    if x.device.type == 'cuda':
        return _launch(x, gamma, beta, film, groups, eps)
    raise RuntimeError(f'groupnorm_silu: no kernel for device {x.device}')
