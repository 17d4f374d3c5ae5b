"""Shared diffusion machinery: normalisation, fused classifier-free guidance,
the DeepCache refresh schedule, the tiled sampler's per-parity tile
batches and its chunk loop (split over a mesh's data ranks), the samplers'
debug frame stacks (``Capture``, ``crop_frames``), and the pieces the three
training losses share (draws, condition dropout, the elementwise loss).

Counterpart of ``srgd_tpu/diffusion/base.py``. Guidance runs the conditional
and the null branch as ONE doubled batch in ``[cond, null]`` order and merges
``null + (cond - null) * scale``. The reference's nulls are a zeros condition
image and omitting the class-embedding addition, expressed here as
``cond=0`` and ``class_mask=0`` inside that one batch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from srgd_tpu_torch.nn.quant import quant_convs
from srgd_tpu_torch.tiling import extract_tiles, zero_margin

GUIDANCE_NONE = 'none'
GUIDANCE_COND = 'cond'
GUIDANCE_CLASS = 'class'


def normalize_to_neg_one_to_one(img):
    return img * 2.0 - 1.0


def unnormalize_to_zero_to_one(t):
    return (t + 1.0) * 0.5


def resolve_guidance_mode(cond_scale: float, class_cond_scale: float) -> str:
    """The guidance mode, with the reference's guard against both scales."""
    if cond_scale != 1.0 and class_cond_scale != 1.0:
        raise NotImplementedError(
            'Currently, you cannot specify both cond_scale and class_cond_scale '
            'at the same time.')
    if cond_scale != 1.0:
        return GUIDANCE_COND
    if class_cond_scale != 1.0:
        return GUIDANCE_CLASS
    return GUIDANCE_NONE


def guidance_scale(i: int, mode: str, cond_scale: float,
                   guidance_start_steps: int, class_cond_scale: float,
                   class_guidance_start_steps: int) -> float:
    """Guidance warmup: scale 1 (the conditional output) before the start
    step of the active guidance mode."""
    if mode == GUIDANCE_COND:
        return 1.0 if i < guidance_start_steps else cond_scale
    if mode == GUIDANCE_CLASS:
        return 1.0 if i < class_guidance_start_steps else class_cond_scale
    return 1.0


def guided_denoise(net_apply: Callable, x, time_b, cond, class_label,
                   mode: str, scale: float, deep_cache=None,
                   return_cache: bool = False):
    """One denoiser call, doubled to ``[cond, null]`` under guidance.

    net_apply(x, time, cond, class_label, class_mask, **cache_kw) ->
    prediction. At ``scale == 1`` the merge gives the conditional output
    exactly, which is the guidance warmup's behaviour.

    DeepCache: ``return_cache=True`` returns (prediction, cache) from a full
    forward; ``deep_cache=<cache>`` runs the net's shallow half on it. The
    cache is sample-major: under guidance the doubled batch's cache is
    folded to (B, 2, C, h, w) on the way out and unfolded on the way in."""
    b = x.shape[0]
    kw = {}
    if deep_cache is not None or return_cache:
        kw = dict(deep_cache=deep_cache, return_cache=return_cache)
    if mode == GUIDANCE_NONE:
        return net_apply(x, time_b, cond, class_label, None, **kw)

    x2 = torch.cat([x, x])
    t2 = torch.cat([time_b, time_b])
    if mode == GUIDANCE_COND:
        cond2 = torch.cat([cond, torch.zeros_like(cond)])
        label2 = None if class_label is None else torch.cat([class_label,
                                                             class_label])
        mask2 = None
    else:  # GUIDANCE_CLASS
        cond2 = None if cond is None else torch.cat([cond, cond])
        label2 = torch.cat([class_label, class_label])
        ones = torch.ones(b, dtype=torch.float32, device=x.device)
        mask2 = torch.cat([ones, torch.zeros_like(ones)])
    if deep_cache is not None:
        # (B, 2, ...) sample-major -> (2B, ...) doubled-batch order
        kw['deep_cache'] = torch.cat([deep_cache[:, 0], deep_cache[:, 1]])
    out2 = net_apply(x2, t2, cond2, label2, mask2, **kw)
    if return_cache:
        out2, cache2 = out2
        cache = torch.stack([cache2[:b], cache2[b:]], dim=1)
    cond_out, null_out = out2[:b], out2[b:]
    merged = null_out + (cond_out - null_out) * scale
    return (merged, cache) if return_cache else merged


def cache_zeros(net, depth: int, batch: int, h: int, w: int, mode: str):
    """A DeepCache buffer that is written before it is read: sample-major,
    (batch, C, h', w') at U-Net stage ``depth`` of an h x w input, with a
    CFG pair axis (batch, 2, C, h', w') when guidance doubles the net batch.
    Each sample's (C, h', w') is channels-last in memory, the net's own
    layout, so a slice of it feeds the net without a copy."""
    hd, wd = h >> (depth - 1), w >> (depth - 1)
    c = net.dim * net.dim_mults[depth - 1]
    pair = () if mode == GUIDANCE_NONE else (2,)
    buf = torch.zeros((batch, *pair, hd, wd, c), dtype=net.dtype,
                      device=net.init_conv.weight.device)
    n = buf.dim()
    return buf.permute(*range(n - 3), n - 1, n - 3, n - 2)


def refresh_mask(schedule: str, interval: int, n: int) -> np.ndarray:
    """DeepCache refresh positions: a bool[n] mask over EXECUTED step
    counters j (untiled samplers: j = i - start; tiled: j = (i - start) // 2,
    the per-parity step counter).

    ``schedule == ''``: uniform, a refresh when j % interval == 0. Otherwise
    a list of ``COUNTxINTERVAL`` segments separated by ',' or '/', walked in
    sampling order (high noise to low noise). COUNT is a step count, or a
    fraction of n when it is at most 1; the last segment fills what is left
    of n whatever its COUNT. Each segment refreshes at its local
    j % INTERVAL == 0, so it opens with a refresh. j = 0 always refreshes:
    the first executed step has no cache to read."""
    if not schedule:
        return np.arange(n) % max(interval, 1) == 0
    mask = np.zeros(n, dtype=bool)
    pos = 0
    segments = [s.strip() for s in schedule.replace('/', ',').split(',')
                if s.strip()]
    for k, seg in enumerate(segments):
        cnt_s, _, int_s = seg.partition('x')
        iv = max(int(int_s), 1)
        cnt_f = float(cnt_s)
        cnt = int(round(cnt_f * n)) if cnt_f <= 1.0 else int(cnt_f)
        if k == len(segments) - 1:
            cnt = n - pos
        cnt = min(cnt, n - pos)
        mask[pos:pos + cnt] = np.arange(cnt) % iv == 0
        pos += cnt
        if pos >= n:
            break
    if n > 0:
        mask[0] = True
    return mask


class GeneratorNoise:
    """The default noise source: one ``torch.Generator`` seeded with ``seed``
    on ``device``, drawn in the samplers' documented order (the module
    docstrings of the three families). ``init(shape)``, ``step(i, shape)``
    and ``margin(i, shape)`` each return a float32 standard-normal tensor."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _draw(self, shape):
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.float32)

    def init(self, shape):
        return self._draw(shape)

    def step(self, i: int, shape):
        return self._draw(shape)

    def margin(self, i: int, shape):
        return self._draw(shape)


class GeneratorDraws:
    """The default draw source of the training losses: one
    ``torch.Generator`` on ``device``, seeded with ``seed``, drawn in the
    order the loss asks. Each draw has a name, which a test's replay source
    maps to the JAX loss's key of that role: ``t`` (continuous times,
    gaussian timesteps), ``sigma`` (elucidated), ``noise``, ``offset``
    (gaussian offset noise), ``drop_cond`` and ``drop_class`` (the
    whole-batch condition and class dropout uniforms)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, name: str, shape):
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device, dtype=torch.float32)

    def normal(self, name: str, shape):
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.float32)

    def randint(self, name: str, shape, high: int):
        return torch.randint(0, high, tuple(shape), generator=self.gen,
                             device=self.device)


def drop_conditions(draws, cond, class_label, cond_drop_prob: float,
                    class_cond_drop_prob: float):
    """Whole-batch condition and class dropout, one uniform each, as the
    reference draws them: (cond or zeros, class_mask or None). Decided on
    the device, with no host sync."""
    drop_cond = draws.uniform('drop_cond', ()) < cond_drop_prob
    cond = torch.where(drop_cond, torch.zeros_like(cond), cond)
    class_mask = None
    if class_label is not None:
        drop_class = draws.uniform('drop_class', ()) < class_cond_drop_prob
        class_mask = torch.where(drop_class, 0.0, 1.0) * torch.ones(
            cond.shape[0], device=cond.device)
    return cond, class_mask


def elementwise_loss(pred, target, loss_type: str):
    """``_elementwise_loss`` of the JAX package: l2, l1 or smooth_l1."""
    if loss_type == 'l2':
        return torch.square(pred - target)
    if loss_type == 'l1':
        return torch.abs(pred - target)
    if loss_type == 'smooth_l1':
        d = torch.abs(pred - target)
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    raise ValueError(f'invalid loss type {loss_type}')


def per_sample_mean(err):
    """(b, ...) -> (b,) means."""
    return torch.mean(err.reshape(err.shape[0], -1), dim=1)


class DeepCache:
    """One sampling run's DeepCache: the refresh mask over the step counter
    and the cache buffers, allocated once for the run (one per grid parity
    when tiled, each holding every padded tile's cache).

    ``step(fn, j, slot, rows)`` runs one denoiser step of step counter j on
    the buffer rows ``rows`` of ``slot``: on a refresh it calls
    ``fn(return_cache=True)``, whose result ends with the fresh cache, keeps
    that cache and returns the rest; otherwise it calls
    ``fn(deep_cache=<the kept rows>)``."""

    def __init__(self, mask: np.ndarray, buffers: list):
        self.mask, self.buffers = mask, buffers

    @classmethod
    def untiled(cls, net, depth: int, interval: int, schedule: str,
                n_steps: int, shape, mode: str) -> 'DeepCache':
        """``n_steps`` executed steps on (B, H, W, C) images."""
        b, h, w = shape[:3]
        return cls(refresh_mask(schedule, interval, n_steps),
                   [cache_zeros(net, depth, b, h, w, mode)])

    @classmethod
    def tiled(cls, net, depth: int, interval: int, schedule: str,
              n_steps: int, cond_tiles, mode: str) -> 'DeepCache':
        """``n_steps`` executed steps over both grid parities, whose padded
        (tiles, th, tw, C) condition batches are ``cond_tiles``: the mask
        covers the per-parity counter, (n_steps + 1) // 2 + 1 entries."""
        return cls(refresh_mask(schedule, interval, (n_steps + 1) // 2 + 1),
                   [cache_zeros(net, depth, *ct.shape[:3], mode)
                    for ct in cond_tiles])

    def step(self, fn: Callable, j: int, slot: int = 0,
             rows: slice = slice(None)):
        if self.mask[j]:
            *out, cache = fn(return_cache=True)
            self.buffers[slot][rows].copy_(cache)
            return tuple(out)
        return fn(deep_cache=self.buffers[slot][rows])


class NoCache:
    """The ``DeepCache`` interface of a run without DeepCache: every step
    runs the full net."""

    @staticmethod
    def step(fn: Callable, j: int, slot: int = 0, rows: slice = slice(None)):
        return fn()


def select_time_stats(net, time_scalar) -> None:
    """Per-time int8 calibration (``nn.quant.calibrate_sampler`` with
    ``per_time``): every quantized conv of ``net`` takes the stats of the
    calibration time nearest ``time_scalar``, the net's time input (argmin
    of |times - t|, the first index winning a tie, as
    ``srgd_tpu.diffusion.base.select_time_stats``). On the device: the pick
    is an index tensor, never read back. A no-op without per-time stats."""
    times = getattr(net, 'quant_stats_times', None)
    if times is None:
        return
    idx = torch.argmin(torch.abs(times - time_scalar))
    for _, m in quant_convs(net):
        m.select(idx)


def nhwc_net_apply(net, cache_depth: int):
    """The denoiser on (B, H, W, C) tensors: the net runs on NCHW views of
    the same memory (channels_last) and returns float32 (B, H, W, C). The
    DeepCache keywords pass through with ``cache_depth``; the cache stays in
    the net's NCHW layout. This is every family's ``net_apply`` boundary,
    where ``select_time_stats`` runs on ``time_b[0]``."""
    def apply(x, time_b, cond, class_label, class_mask, **cache_kw):
        def nchw(t):
            return None if t is None else t.permute(0, 3, 1, 2)
        select_time_stats(net, time_b[0])
        if cache_kw:
            cache_kw['cache_depth'] = cache_depth
        out = net(nchw(x), time_b, cond=nchw(cond), class_label=class_label,
                  class_mask=class_mask, **cache_kw)
        if cache_kw.get('return_cache'):
            return out[0].permute(0, 2, 3, 1), out[1]
        return out.permute(0, 2, 3, 1)
    return apply


def make_deep_cache(wrapper, n_steps: int, mode: str, *, shape=None,
                    cond_tiles=None, schedule=None):
    """A family wrapper's ``DeepCache`` for one run of ``n_steps`` executed
    steps (``NoCache`` at interval 0 or 1): untiled for (B, H, W, C) images
    of ``shape``, tiled for the parities' padded ``cond_tiles``.
    ``schedule`` overrides the wrapper's refresh schedule."""
    if wrapper.deep_cache_interval <= 1:
        return NoCache()
    if schedule is None:
        schedule = wrapper.deep_cache_schedule
    args = (wrapper.net, wrapper.deep_cache_depth, wrapper.deep_cache_interval,
            schedule, n_steps)
    if cond_tiles is not None:
        return DeepCache.tiled(*args, cond_tiles, mode)
    return DeepCache.untiled(*args, shape, mode)


def crop_frames(frames, crop):
    """Frames (..., H, W, C) cropped to the output region ``crop`` (left,
    top, right, bottom): a tiled capture crops every frame, frame 0 too, so
    its stack has one shape; the padding margin is re-noise bookkeeping,
    not image content (``srgd_tpu.diffusion.base.crop_frames``)."""
    left, top, right, bottom = crop
    return frames[..., top:bottom, left:right, :]


class Capture:
    """The samplers' debug captures, the reference's ``with_images`` and
    ``with_x0_images``: for each of the trajectory and the x0 estimate that
    is asked for, a float32 (1 + n_steps, B, H, W, C) stack in [-1, 1]
    whose frame 0 is the init canvas and frame k the state after the k-th
    executed step, each cropped to ``crop`` when one is given (tiled).
    Frames are copied into the stack as they come; with neither asked for
    nothing is kept and ``result`` returns the output alone."""

    def __init__(self, trajectory: bool, x0: bool, n_steps: int, init,
                 crop=None):
        self.crop, self.k, self.stacks = crop, 0, {}
        first = init if crop is None else crop_frames(init, crop)
        for name, wanted in (('trajectory', trajectory), ('x0', x0)):
            if wanted:
                stack = first.new_empty((n_steps + 1, *first.shape))
                stack[0] = first
                self.stacks[name] = stack

    @property
    def x0(self) -> bool:
        return 'x0' in self.stacks

    def add(self, img, x0=None) -> None:
        """The frames of the next executed step."""
        self.k += 1
        for name, frame in (('trajectory', img), ('x0', x0)):
            if name in self.stacks:
                self.stacks[name][self.k] = (
                    frame if self.crop is None
                    else crop_frames(frame, self.crop))

    def result(self, out):
        """``out``, or (out, trajectory), (out, x0) or (out, trajectory,
        x0), as the JAX samplers return them."""
        return (out, *self.stacks.values()) if self.stacks else out


def pick_chunk(n_tiles: int, batch_size: int) -> int:
    """Tile-chunk size for one grid parity: an exact divisor of n_tiles up to
    batch_size when one that is a multiple of 8 and at least batch_size/2
    exists, else batch_size with padding. Results do not depend on it: the
    noise is drawn at canvas level."""
    cap = max(1, min(batch_size, n_tiles))
    for d in range(cap, 7, -1):
        if n_tiles % d == 0 and d % 8 == 0 and 2 * d >= cap:
            return d
    return cap


def pad_tiles_to_multiple(tiles: torch.Tensor, chunk: int):
    """Pad the tile axis with zeros to a multiple of ``chunk``; returns
    (padded, n_orig)."""
    n = tiles.shape[0]
    n_pad = (-n) % chunk
    if n_pad == 0:
        return tiles, n
    pad = tiles.new_zeros((n_pad,) + tuple(tiles.shape[1:]))
    return torch.cat([tiles, pad]), n


def prepare_tile_context(cond_padded, geom, batch: int, batch_size: int,
                         class_label):
    """The tiled sampler's set-up: the zero-margined condition canvas split
    into per-parity padded tile batches, per-tile labels, and the interior
    mask.

    Returns (cond_tiles[2], label_tiles[2], n_chunks[2], chunks[2],
    interior_mask)."""
    cond_zeroed = zero_margin(cond_padded, geom)
    n_tiles = (geom.n_tiles_even * batch, geom.n_tiles_odd * batch)
    chunks = [pick_chunk(n, batch_size) for n in n_tiles]
    cond_tiles, label_tiles, n_chunks = [], [], []
    for parity in (0, 1):
        ct, _ = pad_tiles_to_multiple(
            extract_tiles(cond_zeroed, geom, parity), chunks[parity])
        cond_tiles.append(ct)
        n_chunks.append(ct.shape[0] // chunks[parity])
        if class_label is not None:
            if tuple(class_label.shape) != (batch,):
                raise ValueError(f'class_label must be one label per canvas: '
                                 f'{tuple(class_label.shape)} vs batch {batch}')
            lt = torch.repeat_interleave(class_label, n_tiles[parity] // batch)
            label_tiles.append(torch.cat(
                [lt, lt.new_zeros(ct.shape[0] - lt.shape[0])]))
        else:
            label_tiles.append(None)

    interior_mask = None
    if geom.has_margin:
        it, il, ib, ir = geom.interior
        interior_mask = torch.zeros((1, geom.padded_h, geom.padded_w, 1),
                                    dtype=torch.float32,
                                    device=cond_padded.device)
        interior_mask[:, it:ib, il:ir, :] = 1.0
    return cond_tiles, label_tiles, n_chunks, chunks, interior_mask


def run_tile_chunks(step: Callable, dc, j: int, parity: int, n_chunks: int,
                    chunk: int, n_orig: int, like: torch.Tensor,
                    n_out: int = 1, mesh=None) -> list:
    """One grid parity's chunk loop: ``step(sl, **cache_kw)`` denoises the
    padded tile rows ``sl`` (through ``dc.step`` with step counter ``j``)
    and returns a tuple whose first ``n_out`` entries are kept; returns
    those outputs over every tile, in tile order, cut to ``n_orig`` rows.

    With a ``parallel.mesh.Mesh`` data rank d runs the contiguous block
    [d * m, (d + 1) * m) of the chunks, m = ceil(n_chunks / data), and the
    blocks are all-gathered over the data axis. Every chunk keeps the
    batch it has at world 1, so every world gives world 1's bits. Before
    the gather the data ranks agree that each ran its block: when one
    raised, all raise ``MeshSampleError`` there, so no rank waits in a
    gather that another never joins. ``like``: a tensor of the outputs' row
    shape and dtype (for a rank with no chunk)."""
    split = mesh is not None and mesh.data_size > 1
    lo, hi, counts = 0, n_chunks, None
    if split:
        per = -(-n_chunks // mesh.data_size)
        blocks = [(min(d * per, n_chunks), min((d + 1) * per, n_chunks))
                  for d in range(mesh.data_size)]
        lo, hi = blocks[mesh.data_rank]
        counts = [(b - a) * chunk for a, b in blocks]
    outs, failure = [], None
    try:
        for k in range(lo, hi):
            sl = slice(k * chunk, (k + 1) * chunk)
            outs.append(dc.step(lambda **kw: step(sl, **kw), j, parity, sl))
    except Exception as e:
        if not split:
            raise
        failure = e
    if split and not mesh.all_ok(failure is None):
        from srgd_tpu_torch.parallel.mesh import MeshSampleError
        raise MeshSampleError('a data rank failed its tile chunks') \
            from failure
    result = []
    for i in range(n_out):
        local = (torch.cat([o[i] for o in outs]) if outs
                 else like.new_empty((0, *like.shape[1:])))
        if split:
            local = mesh.gather_data_rows(local, counts)
        result.append(local[:n_orig])
    return result
