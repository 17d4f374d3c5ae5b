"""The port's kernels against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; it is checked against
the Pallas kernel (interpret mode per call, as tests/test_kernels.py runs it)
and, for the whole-block kernels, the kernel's XLA twin, in float32 (atol
1e-4) and bfloat16 (atol 2e-2, the rounding-order budget of one bf16 ulp at
the outputs' magnitude). The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srgd_tpu.kernels.attention import fused_attention
from srgd_tpu.kernels.attn_block import _xla_attn_block, fused_attn_block
from srgd_tpu.kernels.groupnorm_silu import fused_groupnorm_silu
from srgd_tpu.kernels.linattn_block import (_xla_linattn_block,
                                            fused_linattn_block)
from srgd_tpu.kernels.linear_attention import (fused_linear_attention,
                                               fused_linear_attention_qkv)
from srgd_tpu_torch.kernels import attention as at
from srgd_tpu_torch.kernels import attn_block as ab
from srgd_tpu_torch.kernels import groupnorm_silu as gs
from srgd_tpu_torch.kernels import linattn_block as lb
from srgd_tpu_torch.kernels import linear_attention as la

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

SHAPES = [(2, 256, 128), (1, 1024, 128), (2, 256, 256)]
ATOL = {'float32': 1e-4, 'bfloat16': 2e-2}
JDT = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
TDT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _inputs(kind, b, n, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    g1 = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    g2 = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    wout = (rng.normal(size=(128, c)) / np.sqrt(128)).astype(np.float32)
    bout = (0.1 * rng.normal(size=c)).astype(np.float32)
    if kind == 'linattn':
        ws = [(rng.normal(size=(c, 128)) / np.sqrt(c)).astype(np.float32)
              for _ in range(3)]
        # (x, g1, wq, wk, wv, wout, bout, g2); index 1, 6, 7 stay float32
        return [x, g1, *ws, wout, bout, g2], (1, 6, 7)
    wqkv = (rng.normal(size=(c, 384)) / np.sqrt(c)).astype(np.float32)
    return [x, g1, wqkv, wout, bout], (1, 4)


def _cast(arrays, f32_idx, dtype, to):
    return [to(a, 'float32' if i in f32_idx else dtype)
            for i, a in enumerate(arrays)]


def _jax(a, dt):
    return jnp.asarray(a).astype(JDT[dt])


def _torch(a, dt):
    return torch.from_numpy(a).to(TDT[dt])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('kind', ['linattn', 'attn'])
def test_plain_matches_jax_kernel(kind, shape, dtype):
    arrays, f32_idx = _inputs(kind, *shape)
    ja = _cast(arrays, f32_idx, dtype, _jax)
    ta = _cast(arrays, f32_idx, dtype, _torch)
    if kind == 'linattn':
        pallas = fused_linattn_block(*ja, dim_head=32, interpret=True)
        xla = _xla_linattn_block(*ja, dim_head=32)
        plain = lb.linattn_block_plain(*ta, dim_head=32)
        wrapped = lb.linattn_block(*ta, dim_head=32)
    else:
        pallas = fused_attn_block(*ja, heads=4, dim_head=32, interpret=True)
        xla = _xla_attn_block(*ja, heads=4, dim_head=32)
        plain = ab.attn_block_plain(*ta, heads=4, dim_head=32)
        wrapped = ab.attn_block(*ta, heads=4, dim_head=32)

    assert plain.dtype == TDT[dtype] and plain.shape == shape
    got = plain.float().numpy()
    for want in (pallas, xla):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=ATOL[dtype], rtol=0)
    # a CPU tensor takes the plain version, and never counts as a launch
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('groups', [4, 8])
@pytest.mark.parametrize('film', [False, True], ids=['plain', 'film'])
def test_groupnorm_silu_matches_jax_kernel(film, groups, dtype):
    """float32 atol 2e-5, the bar of tests/test_kernels.py; bfloat16 within
    one output ulp (2e-2 at outputs of a few units)."""
    rng = np.random.default_rng(2)
    b, hw, c = 2, 16, 32
    x = (rng.normal(size=(b, hw, hw, c)) * 1.5 + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    fm = (rng.normal(size=(b, 2, c)) * 0.2).astype(np.float32) if film else None
    want = fused_groupnorm_silu(
        _jax(x, dtype), jnp.asarray(gamma), jnp.asarray(beta),
        None if fm is None else jnp.asarray(fm), groups=groups, interpret=True)
    args = (_torch(x, dtype), torch.from_numpy(gamma), torch.from_numpy(beta),
            None if fm is None else torch.from_numpy(fm))
    plain = gs.groupnorm_silu_plain(*args, groups=groups)
    assert plain.dtype == TDT[dtype] and plain.shape == x.shape
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-5 if dtype == 'float32' else 2e-2,
                               rtol=0)
    assert torch.equal(gs.groupnorm_silu(*args, groups=groups), plain)
    # (b, rows, c) is the same function
    flat = gs.groupnorm_silu(args[0].reshape(b, hw * hw, c), *args[1:],
                             groups=groups)
    assert torch.equal(flat.reshape(x.shape), plain)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attention_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 4, 256, 32)).astype(np.float32)
               for _ in range(3))
    want = fused_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                           interpret=True)
    ta = [_torch(a, dtype) for a in (q, k, v)]
    plain = at.attention_plain(*ta)
    assert plain.dtype == TDT[dtype] and plain.shape == q.shape
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == 'float32' else dict(
        atol=0.02, rtol=0)
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    assert torch.equal(at.attention(*ta), plain)
    # the transposed views of one (b, n, 3, heads, d) projection
    qkv = torch.stack([t.transpose(1, 2) for t in ta], dim=2)
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    assert not views[0].is_contiguous()
    assert torch.equal(at.attention(*views), plain)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [256, 512])
@pytest.mark.parametrize('packed', [False, True], ids=['qkv3', 'packed'])
def test_linear_attention_matches_jax_kernel(packed, n, dtype):
    """float32 atol 1e-4; bfloat16 within 2e-2 * max|ref|."""
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2, n, 384)).astype(np.float32)
    qkv[..., 128:256] *= 2.0     # a k column max that moves between blocks
    if packed:
        want = fused_linear_attention_qkv(_jax(qkv, dtype), dim_head=32,
                                          interpret=True)
        args = (_torch(qkv, dtype),)
        plain_fn, fn = la.linear_attention_qkv_plain, la.linear_attention_qkv
    else:
        parts = [np.ascontiguousarray(qkv[..., i * 128:(i + 1) * 128])
                 for i in range(3)]
        want = fused_linear_attention(*(_jax(a, dtype) for a in parts),
                                      dim_head=32, interpret=True)
        args = tuple(_torch(a, dtype) for a in parts)
        plain_fn, fn = la.linear_attention_plain, la.linear_attention
    plain = plain_fn(*args, dim_head=32)
    assert plain.dtype == TDT[dtype] and plain.shape == (2, n, 128)
    want = np.asarray(want, np.float32)
    atol = 1e-4 if dtype == 'float32' else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(plain.float().numpy(), want, atol=atol, rtol=0)
    assert torch.equal(fn(*args, dim_head=32), plain)


def test_wrappers_route_by_device():
    before = (lb.launches, ab.launches, gs.launches, at.launches, la.launches,
              la.launches_qkv)
    arrays, f32_idx = _inputs('linattn', 1, 64, 128)
    meta = [torch.from_numpy(a).to('meta') for a in arrays]
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        lb.linattn_block(*meta)
    arrays, f32_idx = _inputs('attn', 1, 64, 128)
    meta = [torch.from_numpy(a).to('meta') for a in arrays]
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        ab.attn_block(*meta)
    m = torch.zeros(1, 64, 128, device='meta')
    ones = torch.ones(128, device='meta')
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        gs.groupnorm_silu(m, ones, ones)
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        at.attention(*[torch.zeros(1, 4, 64, 32, device='meta')] * 3)
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        la.linear_attention(m, m, m)
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        la.linear_attention_qkv(torch.zeros(1, 64, 384, device='meta'))
    assert (lb.launches, ab.launches, gs.launches, at.launches, la.launches,
            la.launches_qkv) == before


# (rows, c) of the flagship's Blocks (chip_smoke.GN_SHAPES) and ragged rows
GN_PLAN_SHAPES = ((65536, 128), (16384, 128), (16384, 256), (4096, 256),
                  (4096, 512), (1024, 512), (1024, 1024), (1000, 24),
                  (4136, 256), (63, 1024), (1, 32))


@pytest.mark.parametrize('b', [1, 8, 16])
@pytest.mark.parametrize('rows,c', GN_PLAN_SHAPES)
def test_groupnorm_plan_covers_every_row_and_cannot_deadlock(b, rows, c):
    """The kernel's work plan on an H100 (132 SMs), bf16: every row of every
    sample is covered once by a statistics tile and once by an apply tile;
    every apply ticket of a sample comes after all its statistics tickets;
    and a model of the persistent blocks (each holds its current item and
    the next tickets it drew, ``QUEUE`` in all; an apply item finishes only
    once its sample's statistics are all done) runs every item to the end."""
    tile_rows, ntile, lead, grid = gs._plan(b, rows, c, 2, 132)
    assert (ntile - 1) * tile_rows < rows <= ntile * tile_rows
    assert tile_rows * c * 2 <= gs.TILE_BYTES
    assert ntile <= lead <= b * ntile and 1 <= grid <= 2 * b * ntile
    items = [gs._item(t, b, ntile, lead) for t in range(2 * b * ntile)]
    assert sorted(items) == [(k, s, t) for k in (0, 1) for s in range(b)
                             for t in range(ntile)]
    last_stats = {s: max(i for i, (k, s2, _) in enumerate(items)
                         if k == 0 and s2 == s) for s in range(b)}
    first_apply = {s: min(i for i, (k, s2, _) in enumerate(items)
                          if k == 1 and s2 == s) for s in range(b)}
    assert all(last_stats[s] < first_apply[s] for s in range(b))
    # persistent blocks: a statistics item finishes in a step, an apply item
    # only once its sample's statistics have all finished
    total, nxt = len(items), 0
    held = []
    for _ in range(grid):
        held.append(list(range(nxt, nxt + gs.QUEUE)))
        nxt += gs.QUEUE
    stats_left = [ntile] * b
    done = 0
    while held:
        progressed = False
        for block in list(held):
            cur = block[0]
            if cur >= total:
                held.remove(block)
                progressed = True
                continue
            kind, s, _ = items[cur]
            if kind == 1 and stats_left[s]:
                continue
            if kind == 0:
                stats_left[s] -= 1
            done += 1
            block[:] = block[1:] + [nxt]
            nxt += 1
            progressed = True
        assert progressed, 'the blocks wait on each other'
    assert done == total


@pytest.mark.parametrize('b,n', [
    (16, 65536), (8, 4096), (1, 1000), (2, 31), (3, 33), (1, 65536),
    (8, 65536), (8, 4096 + 40), (16, 4096 + 40), (1, 63), (8, 65), (16, 129),
    (300, 1000)])
def test_linattn_split_covers_every_row(b, n):
    """Splits of whole 64-row tiles (which the float32 kernel's 32-row tiles
    divide) that cover every row once, and never more blocks than aimed for
    unless the batch alone exceeds them."""
    rows, nsplit = lb._split(b, n)
    assert lb.TILE_ROWS == 64 and rows % lb.TILE_ROWS == 0
    assert (nsplit - 1) * rows < n <= nsplit * rows
    assert nsplit == 1 or b * nsplit <= lb.TARGET_BLOCKS


BF16_RTOL = 2e-2    # chip_smoke.py's bound: max|err| <= 2e-2 * max|ref|


def _attention_model(q, k, v, tile_k=at.TILE_K):
    """The bfloat16 kernel's arithmetic in plain PyTorch: the product of the
    unscaled bf16 operands in float32, scale and log2(e) applied to the score
    in one multiply, an online softmax over tiles of ``tile_k`` keys with
    ``exp2``, p rounded to bfloat16 before P V (its row sum taken in
    float32), the division by the sum last."""
    n, d = q.shape[-2:]
    sl = d ** -0.5 * 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, n, tile_k):
        s = (qf @ kf[..., k0:k0 + tile_k, :].transpose(-1, -2)) * sl
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        al = torch.exp2(m - mn)
        p = torch.exp2(s - mn)
        l = l * al + p.sum(dim=-1, keepdim=True)
        acc = acc * al + p.to(torch.bfloat16).float() @ vf[..., k0:k0 + tile_k, :]
        m = mn
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize('n', [64, 40, 200])
def test_attention_rounding_model_fits_the_bf16_tolerance(n):
    """The bfloat16 CUDA kernel scales the float score (not q) and rounds p
    to bfloat16 before P V; ``_attention_model`` repeats that arithmetic with
    the kernel's 64-key tiles and online rescaling. It stays inside the
    card's tolerance of the plain version and of the Pallas kernel, at a
    whole tile, a ragged one and several tiles."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 4, n, 32)).astype(np.float32)
               for _ in range(3))
    ta = [_torch(a, 'bfloat16') for a in (q, k, v)]
    model = _attention_model(*ta)
    assert model.dtype == torch.bfloat16 and model.shape == q.shape
    plain = at.attention_plain(*ta).float()
    pallas = torch.from_numpy(np.asarray(fused_attention(
        *(_jax(a, 'bfloat16') for a in (q, k, v)), interpret=True),
        np.float32))
    for want in (plain, pallas):
        err = (model.float() - want).abs().max().item()
        assert err <= BF16_RTOL * want.abs().max().item()
    # the model is not the plain version under another name
    assert at.TILE_K == 64 and not torch.equal(model.float(), plain)
    # one tile over all keys is the same softmax without the rescaling
    whole = _attention_model(*ta, tile_k=n)
    assert (whole.float() - model.float()).abs().max().item() <= \
        BF16_RTOL * plain.abs().max().item()


@pytest.mark.parametrize('hidden', [128, 64, 32])
@pytest.mark.parametrize('c', [32, 192])
def test_linattn_weight_packing_round_trips(c, hidden):
    """``pack_weights`` lays wk | wv side by side and zero-pads to 128
    hidden columns (wq and wout pass through at the full width); slicing
    returns the four weights, and the block computed from the slices equals
    the original."""
    rng = np.random.default_rng(7)
    ws = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
          for s in ((c, hidden), (c, hidden), (c, hidden), (hidden, c))]
    wq_p, wkv_p, wout_p = lb.pack_weights(*ws)
    assert wq_p.shape == (c, 128) and wkv_p.shape == (c, 256)
    assert wout_p.shape == (128, c) and wkv_p.dtype == torch.bfloat16
    back = (wq_p[:, :hidden], wkv_p[:, :hidden],
            wkv_p[:, 128:128 + hidden], wout_p[:hidden])
    assert (wq_p is ws[0]) == (hidden == 128)
    assert all(torch.equal(a, b) for a, b in zip(back, ws))
    # everything outside the four weights is zero
    total = sum(w.float().abs().sum() for w in ws)
    packed = sum(w.float().abs().sum() for w in (wq_p, wkv_p, wout_p))
    assert torch.isclose(total, packed, rtol=1e-6)
    x = torch.from_numpy(rng.normal(size=(1, 24, c)).astype(np.float32)).bfloat16()
    g = torch.ones(c)
    assert torch.equal(
        lb.linattn_block_plain(x, g, *back, g, g, dim_head=32),
        lb.linattn_block_plain(x, g, *ws, g, g, dim_head=32))
