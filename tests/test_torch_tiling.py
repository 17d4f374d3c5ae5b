"""The port's host-side sampler pieces against the JAX package's: the
tiling geometry and tile gather/scatter (including the overlapping odd
grid's ordered last-write-wins scatter), the tile-batch set-up, and the
float64 log-SNR tables. All of them move or compute values without
rounding, so they must agree exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srgd_tpu import tiling as jt
from srgd_tpu.diffusion import base as jb
from srgd_tpu.diffusion.schedules import make_log_snr_table as jax_table
from srgd_tpu_torch import tiling as tt
from srgd_tpu_torch.diffusion import base as tb
from srgd_tpu_torch.diffusion.schedules import make_log_snr_table

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

# (height, width, tile_size, tile_stride)
GEOMETRIES = [(40, 40, 32, None), (64, 64, 32, None), (20, 30, 32, None),
              (70, 50, 32, 24), (96, 96, 32, 20), (512, 512, 256, None)]


@pytest.mark.parametrize('h, w, ts, stride', GEOMETRIES)
def test_geometry_matches_jax(h, w, ts, stride):
    mine = tt.make_geometry(h, w, ts, stride)
    want = jt.make_geometry(h, w, ts, stride)
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert (mine.n_tiles_even, mine.n_tiles_odd, mine.has_margin) == (
        want.n_tiles_even, want.n_tiles_odd, want.has_margin)


@pytest.mark.parametrize('h, w, ts, stride', GEOMETRIES[:5])
def test_extract_scatter_pad_match_jax(h, w, ts, stride):
    geom = tt.make_geometry(h, w, ts, stride)
    jgeom = jt.make_geometry(h, w, ts, stride)
    rng = np.random.default_rng(h * w)
    img = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    padded = tt.reflect_pad(torch.from_numpy(img), geom.pad)
    jpadded = jt.reflect_pad(jnp.asarray(img), jgeom.pad)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    np.testing.assert_array_equal(tt.zero_margin(padded, geom).numpy(),
                                  np.asarray(jt.zero_margin(jpadded, jgeom)))
    for parity in (0, 1):
        tiles = tt.extract_tiles(padded, geom, parity)
        np.testing.assert_array_equal(
            tiles.numpy(), np.asarray(jt.extract_tiles(jpadded, jgeom, parity)))
        # distinct values per tile make the overlap order visible
        new = rng.normal(size=tuple(tiles.shape)).astype(np.float32)
        got = tt.scatter_tiles(padded, torch.from_numpy(new), geom, parity)
        want = jt.scatter_tiles(jpadded, jnp.asarray(new), jgeom, parity)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('h, w, ts', [(16, 16, 256), (64, 64, 256),
                                      (10, 150, 256), (40, 40, 32)])
def test_reflect_pad_longer_than_the_input_matches_jax(h, w, ts):
    """A condition under half a tile pads by more than its own size; the
    reflection folds again, as ``jnp.pad`` does (F.pad refuses it)."""
    geom = tt.make_geometry(h, w, ts)
    img = np.random.default_rng(h + w).normal(size=(1, h, w, 3)).astype(
        np.float32)
    got = tt.reflect_pad(torch.from_numpy(img), geom.pad)
    assert got.shape == (1, geom.padded_h, geom.padded_w, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jt.reflect_pad(jnp.asarray(img), geom.pad)))


def test_pick_chunk_and_padding_match_jax():
    for n in range(1, 100):
        for bs in (1, 3, 4, 8, 16, 32):
            assert tb.pick_chunk(n, bs) == jb.pick_chunk(n, bs)
    tiles = np.arange(5 * 2 * 2 * 1, dtype=np.float32).reshape(5, 2, 2, 1)
    got, n = tb.pad_tiles_to_multiple(torch.from_numpy(tiles), 4)
    want, jn = jb.pad_tiles_to_multiple(jnp.asarray(tiles), 4)
    assert n == jn == 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('with_label', [False, True])
def test_prepare_tile_context_matches_jax(with_label):
    geom = tt.make_geometry(40, 40, 32)
    jgeom = jt.make_geometry(40, 40, 32)
    cond = np.random.default_rng(3).normal(
        size=(2, geom.padded_h, geom.padded_w, 3)).astype(np.float32)
    label = np.asarray([2, 1]) if with_label else None
    got = tb.prepare_tile_context(
        torch.from_numpy(cond), geom, 2, 4,
        None if label is None else torch.from_numpy(label))
    want = jb.prepare_tile_context(
        jnp.asarray(cond), jgeom, 2, 4,
        None if label is None else jnp.asarray(label))
    (ct, lt, nc, ch, mask), (jct, jlt, jnc, jch, jmask) = got, want
    assert list(nc) == list(jnc) and list(ch) == list(jch)
    for p in (0, 1):
        np.testing.assert_array_equal(ct[p].numpy(), np.asarray(jct[p]))
        if with_label:
            np.testing.assert_array_equal(lt[p].numpy(), np.asarray(jlt[p]))
        else:
            assert lt[p] is None and jlt[p] is None
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize('schedule', ['linear', 'cosine'])
def test_log_snr_table_matches_jax(schedule):
    times = np.linspace(1.0, 0.0, 251)
    np.testing.assert_array_equal(make_log_snr_table(schedule, times),
                                  jax_table(schedule, times))
