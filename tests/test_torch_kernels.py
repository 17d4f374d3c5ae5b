"""The port's fused attention blocks against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; it is checked against
the Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and the
kernel's XLA twin, in float32 (atol 1e-4) and bfloat16 (atol 2e-2, the
rounding-order budget of one bf16 ulp at the outputs' magnitude). The CUDA
kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srgd_tpu.kernels.attn_block import _xla_attn_block, fused_attn_block
from srgd_tpu.kernels.linattn_block import (_xla_linattn_block,
                                            fused_linattn_block)
from srgd_tpu_torch.kernels import attn_block as ab
from srgd_tpu_torch.kernels import linattn_block as lb

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


def test_wrappers_route_by_device():
    before = (lb.launches, ab.launches)
    arrays, f32_idx = _inputs('linattn', 1, 64, 128)
    meta = [torch.from_numpy(a).to('meta') for a in arrays]
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        lb.linattn_block(*meta)
    arrays, f32_idx = _inputs('attn', 1, 64, 128)
    meta = [torch.from_numpy(a).to('meta') for a in arrays]
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        ab.attn_block(*meta)
    assert (lb.launches, ab.launches) == before


def test_linattn_split_covers_every_row():
    for b, n in ((16, 65536), (8, 4096), (1, 1000), (2, 31), (3, 33)):
        rows, nsplit = lb._split(b, n)
        assert rows % lb.TILE_ROWS == 0
        assert (nsplit - 1) * rows < n <= nsplit * rows

