"""Tiling geometry and tile gather/scatter for the alternating-grid sampler.

Counterpart of ``srgd_tpu/tiling.py``. The integer geometry is a copy (the JAX
module imports ``jax.numpy``); gather and scatter are torch. Canvases are
(B, H, W, C) tensors, the JAX package's layout, so the two samplers compare
like with like; the net sees NCHW views of the tiles.

The canvas is padded to a multiple of ``tile_size`` plus one tile. Even steps
denoise the aligned grid; odd steps denoise the half-tile-shifted grid over
the interior, and the sampler re-noises the uncovered margin. With
``tile_stride < tile_size`` only the odd grid overlaps; its tiles are all read
from the step's input canvas and written back in row-major order, last write
wins.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def pad_geometry(height: int, width: int, tile_size: int = 256):
    """Padded canvas size as ``(coord, pad)``: coord = (left, top, right,
    bottom) of the original region inside the canvas, pad = (l, r, t, b)."""
    if height <= tile_size and width <= tile_size:
        new_height, new_width = tile_size, tile_size
    else:
        new_height = ((height - 1) // tile_size + 1) * tile_size + tile_size
        new_width = ((width - 1) // tile_size + 1) * tile_size + tile_size

    left = (new_width - width) // 2
    top = (new_height - height) // 2
    coord = (left, top, left + width, top + height)
    pad = (left, new_width - left - width, top, new_height - top - height)
    return coord, pad


def grid_coords(h: int, w: int, tile_size: int, tile_stride: int, diff: int = 0):
    """Tile coordinates [(hs, he, ws, we), ...], row-major, with a remainder
    tile pinned to the far edge when the stride does not divide."""
    hi_list = list(range(0, h - tile_size + 1, tile_stride))
    if (h - tile_size) % tile_stride != 0:
        hi_list.append(h - tile_size)
    wi_list = list(range(0, w - tile_size + 1, tile_stride))
    if (w - tile_size) % tile_stride != 0:
        wi_list.append(w - tile_size)
    return [(hi + diff, hi + tile_size + diff, wi + diff, wi + tile_size + diff)
            for hi in hi_list for wi in wi_list]


@dataclass(frozen=True)
class TileGeometry:
    """Static geometry for the alternating-grid tiled sampler."""

    height: int              # input canvas height (pre-pad)
    width: int
    padded_h: int
    padded_w: int
    tile_size: int
    crop: tuple              # (left, top, right, bottom) of original region
    pad: tuple               # (l, r, t, b) reflect-pad amounts
    interior: tuple          # (top, left, bottom, right) covered by the odd grid
    grid_even: tuple         # (gh, gw) tiles on even steps
    grid_odd: tuple          # (gh, gw) tiles on odd steps (interior grid)
    # overlapping odd grid (tile_stride < tile_size): row-major coordinates in
    # the canvas frame; None when the odd grid is the remainder-free grid
    coords_odd: tuple | None = None

    @property
    def n_tiles_even(self) -> int:
        return self.grid_even[0] * self.grid_even[1]

    @property
    def n_tiles_odd(self) -> int:
        if self.coords_odd is not None:
            return len(self.coords_odd)
        return self.grid_odd[0] * self.grid_odd[1]

    @property
    def has_margin(self) -> bool:
        it, il, ib, ir = self.interior
        return not (it == 0 and il == 0 and ib == self.padded_h
                    and ir == self.padded_w)


def make_geometry(height: int, width: int, tile_size: int = 256,
                  tile_stride: int | None = None) -> TileGeometry:
    """The full static geometry for an input of size (height, width).
    ``tile_stride`` strides only the shifted interior grid."""
    tile_stride = tile_size if tile_stride is None else tile_stride
    if not 0 < tile_stride <= tile_size:
        raise ValueError(
            f'tile_stride must be in [1, tile_size]; got {tile_stride} '
            f'(tile_size {tile_size})')

    coord, pad = pad_geometry(height, width, tile_size)
    padded_h = height + pad[2] + pad[3]
    padded_w = width + pad[0] + pad[1]
    gh, gw = padded_h // tile_size, padded_w // tile_size

    coords_odd = None
    if padded_h <= tile_size and padded_w <= tile_size:
        interior = (0, 0, padded_h, padded_w)   # one tile: both grids equal
        grid_odd = (gh, gw)
    else:
        half = tile_size // 2
        interior = (half, half, padded_h - half, padded_w - half)
        grid_odd = (gh - 1, gw - 1)
        if tile_stride != tile_size:
            coords_odd = tuple(grid_coords(
                padded_h - tile_size, padded_w - tile_size,
                tile_size, tile_stride, diff=half))

    return TileGeometry(
        height=height, width=width, padded_h=padded_h, padded_w=padded_w,
        tile_size=tile_size, crop=coord, pad=pad, interior=interior,
        grid_even=(gh, gw), grid_odd=grid_odd, coords_odd=coords_odd)


def space_to_tiles(x: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*gh*gw, ts, ts, C); H, W multiples of ts."""
    b, h, w, c = x.shape
    gh, gw = h // tile_size, w // tile_size
    x = x.reshape(b, gh, tile_size, gw, tile_size, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * gh * gw, tile_size, tile_size, c)


def tiles_to_space(tiles: torch.Tensor, batch: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``space_to_tiles``."""
    n, ts, _, c = tiles.shape
    gh, gw = h // ts, w // ts
    x = tiles.reshape(batch, gh, gw, ts, ts, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(batch, h, w, c)


def extract_tiles(x: torch.Tensor, geom: TileGeometry, parity: int) -> torch.Tensor:
    """The step's tile batch: parity 0 the aligned grid, 1 the shifted grid.
    Tiles are batch-major, then row-major over the grid."""
    if parity == 0:
        return space_to_tiles(x, geom.tile_size)
    if geom.coords_odd is not None:
        b, ts, c = x.shape[0], geom.tile_size, x.shape[-1]
        slabs = [x[:, hs:he, ws:we, :] for hs, he, ws, we in geom.coords_odd]
        return torch.stack(slabs, dim=1).reshape(b * len(slabs), ts, ts, c)
    it, il, ib, ir = geom.interior
    return space_to_tiles(x[:, it:ib, il:ir, :], geom.tile_size)


def scatter_tiles(canvas: torch.Tensor, tiles: torch.Tensor, geom: TileGeometry,
                  parity: int) -> torch.Tensor:
    """The canvas with the step's tiles written back (a new tensor; the
    shifted grid leaves the margin untouched; overlapping tiles are written
    in row-major order, last write wins)."""
    b = canvas.shape[0]
    if parity == 0:
        return tiles_to_space(tiles, b, geom.padded_h, geom.padded_w)
    canvas = canvas.clone()
    if geom.coords_odd is not None:
        ts, c = geom.tile_size, canvas.shape[-1]
        per_img = tiles.reshape(b, len(geom.coords_odd), ts, ts, c)
        for i, (hs, he, ws, we) in enumerate(geom.coords_odd):
            canvas[:, hs:he, ws:we, :] = per_img[:, i]
        return canvas
    it, il, ib, ir = geom.interior
    canvas[:, it:ib, il:ir, :] = tiles_to_space(tiles, b, ib - it, ir - il)
    return canvas


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source rows of a reflect pad of ``n`` rows by (before, after): the
    mirror without repeating the edge, folded again where a pad is longer
    than the input (period 2 (n - 1)), as ``jnp.pad(mode='reflect')``
    does; torch's F.pad refuses pads of n rows or more."""
    i = torch.arange(-before, n + after, device=device)
    period = max(2 * (n - 1), 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def reflect_pad(x: torch.Tensor, pad: tuple) -> torch.Tensor:
    """(B, H, W, C) reflect pad with (l, r, t, b): F.pad's reflect where the
    pads are shorter than the input, ``jnp.pad``'s repeated reflection
    beyond (a condition under half a tile)."""
    l, r, t, b = pad
    rows = _reflect_index(x.shape[1], t, b, x.device)
    cols = _reflect_index(x.shape[2], l, r, x.device)
    return x[:, rows][:, :, cols].contiguous()


def zero_margin(x: torch.Tensor, geom: TileGeometry) -> torch.Tensor:
    """Zero everything outside the interior region."""
    if not geom.has_margin:
        return x
    it, il, ib, ir = geom.interior
    mask = torch.zeros(x.shape[1:3], dtype=x.dtype, device=x.device)
    mask[it:ib, il:ir] = 1.0
    return x * mask[None, :, :, None]
