"""Shared diffusion machinery: normalisation, fused classifier-free guidance
and the tiled sampler's per-parity tile batches.

Counterpart of ``srgd_tpu/diffusion/base.py``. Guidance runs the conditional
and the null branch as ONE doubled batch in ``[cond, null]`` order and merges
``null + (cond - null) * scale``. The reference's nulls are a zeros condition
image and omitting the class-embedding addition, expressed here as
``cond=0`` and ``class_mask=0`` inside that one batch.
"""

from __future__ import annotations

from typing import Callable

import torch

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


def guided_denoise(net_apply: Callable, x, time_b, cond, class_label,
                   mode: str, scale: float):
    """One denoiser call, doubled to ``[cond, null]`` under guidance.

    net_apply(x, time, cond, class_label, class_mask) -> prediction. At
    ``scale == 1`` the merge gives the conditional output exactly, which is
    the guidance warmup's behaviour."""
    b = x.shape[0]
    if mode == GUIDANCE_NONE:
        return net_apply(x, time_b, cond, class_label, None)

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
    out2 = net_apply(x2, t2, cond2, label2, mask2)
    cond_out, null_out = out2[:b], out2[b:]
    return null_out + (cond_out - null_out) * scale


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
