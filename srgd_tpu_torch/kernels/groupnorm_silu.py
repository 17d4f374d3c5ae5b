"""GroupNorm + optional FiLM + SiLU: a CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``srgd_tpu/kernels/groupnorm_silu.py``
(``fused_groupnorm_silu``). The CUDA source is
``srgd_tpu_torch/csrc/groupnorm_silu.cu``.

What bounds it on the H100: memory. There is no product: the function reads
x and writes an output of the same size. The chain it replaces in ``Block``
(float32 ``F.group_norm`` behind a cast and a layout copy, FiLM, SiLU, the
cast back) moves the activation through device memory many more times. What
the design does about it: one launch of persistent blocks that take
statistics and apply tiles by ticket in one fixed order (``_item``), so a
sample's apply follows its own statistics while its x is still in the L2;
the fold into one (scale, shift) per (sample, channel) inside the kernel, by
the block that retires the sample's last statistics tile, adding the
partials in tile order (no float atomics, so the result does not change from
run to run); 16-byte loads over consecutive channels of the channels-last
activation; no float32 copy of the activation anywhere. The kernel's
counters live in a small buffer per device and stream (``_state``), zeroed
once and left zero by every call. Times at the flagship shapes: PERF.md.
"""

from __future__ import annotations

import torch

from srgd_tpu_torch.kernels import _build

launches = 0   # kernel launches through groupnorm_silu (never the plain version)

TILE_BYTES = 64 << 10  # bytes of x a work item reads, at most
MIN_TILE_ROWS = 16     # a work item covers at least this many rows (bytes allowing)
BLOCKS_PER_SM = 2      # persistent blocks of 256 threads on each SM
QUEUE = 2              # tickets a block holds: its item and the next
L2_BYTES = 40 << 20    # x the apply may trail the statistics by, at most
STATE_CAP = 64         # samples the counters of a stream hold at first

_SMS: dict = {}        # device index -> SM count
_STATE: dict = {}      # (device index, stream) -> [counters, generation, cap]


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


def _item(t: int, b: int, ntile: int, lead: int) -> tuple[int, int, int]:
    """(apply, sample, tile) of ticket t: the kernel's ``item_of``. The
    statistics tiles S_i and the apply tiles A_i are numbered over all
    samples (i = sample * ntile + tile); the order is S_0 .. S_{lead-1}, then
    A_0, S_lead, A_1, S_{lead+1}, ... in turns until the S_i run out, then
    the remaining A_i."""
    ns = b * ntile
    if t < lead:
        apply, i = 0, t
    else:
        j, m = t - lead, ns - lead
        if j < 2 * m:
            apply = 1 - j % 2
            i = j // 2 if apply else lead + j // 2
        else:
            apply, i = 1, j - m
    return apply, i // ntile, i % ntile


def _plan(b: int, rows: int, c: int, itemsize: int,
          sms: int) -> tuple[int, int, int, int]:
    """(tile_rows, ntile, lead, grid) of one call: tiles of at most
    TILE_BYTES, at least enough of them for every block of the grid
    (BLOCKS_PER_SM an SM), none shorter than MIN_TILE_ROWS where the bytes
    allow; the apply tiles trail the statistics tiles by ``lead``."""
    cap = sms * BLOCKS_PER_SM
    max_rows = max(1, TILE_BYTES // (c * itemsize))
    ntile = max(-(-rows // max_rows), -(-cap // b))
    ntile = min(ntile, -(-rows // min(MIN_TILE_ROWS, max_rows)))
    tile_rows = -(-rows // ntile)
    ntile = -(-rows // tile_rows)
    grid = min(2 * b * ntile, cap)
    # apply tiles trail the statistics by at least a sample (the order's
    # condition), by the tickets the grid holds and two rounds more where the
    # L2 allows, and never by more than all the statistics tiles
    in_flight = grid * (QUEUE + 2)
    in_l2 = L2_BYTES // (tile_rows * c * itemsize)
    lead = min(b * ntile, max(ntile, min(in_flight, in_l2)))
    return tile_rows, ntile, lead, grid


def _sms(dev) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _state(dev, stream: int, b: int):
    """(state, generation, cap): the kernel's counters for this device and
    stream, zeroed once (grown when b outgrows them) and left zero by every
    call, and this call's generation number, never the previous one's."""
    entry = _STATE.get((dev.index, stream))
    if entry is None or entry[2] < b:
        cap = max(b, STATE_CAP)
        entry = [torch.zeros(2 + 2 * cap, dtype=torch.int32, device=dev), 0,
                 cap]
        _STATE[(dev.index, stream)] = entry
    entry[1] = entry[1] % (2 ** 31 - 2) + 1
    return entry


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
    film_ptr, film_bf16 = None, 0
    if film is not None:
        if film.device != dev or film.shape != (b, 2, c):
            raise ValueError('film must be (b, 2, c) on the device of x')
        if film.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f'groupnorm_silu film takes float32 or bfloat16, '
                            f'got {film.dtype}')
        if not film.is_contiguous():
            raise ValueError('groupnorm_silu needs film contiguous; it does '
                             'not copy')
        film_ptr, film_bf16 = film.data_ptr(), int(film.dtype == torch.bfloat16)

    tile_rows, ntile, lead, grid = _plan(b, rows, c, x.element_size(),
                                         _sms(dev))
    if 2 * b * ntile >= 2 ** 31:
        raise ValueError(f'groupnorm_silu: batch {b} too large')
    part = torch.empty((b, ntile, 2, groups), device=dev, dtype=torch.float32)
    ss = torch.empty((b, 2, c), device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    vec = 8 if x.dtype == torch.bfloat16 else 4
    vectorised = int(c % vec == 0 and x.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0)
    name = ('srgd_groupnorm_silu_bf16' if x.dtype == torch.bfloat16
            else 'srgd_groupnorm_silu_f32')
    fn = _build.entry(name, 8, 12, 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        state, gen, cap = _state(dev, stream, b)
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), film_ptr,
                 part.data_ptr(), ss.data_ptr(), out.data_ptr(),
                 state.data_ptr(), b, rows, c, groups, tile_rows, ntile, lead,
                 grid, gen, cap, film_bf16, vectorised, eps, stream)
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
