"""Softmax attention ``softmax(q k^T d^-0.5) v``: a CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``srgd_tpu/kernels/attention.py``
(``fused_attention``, kernel body ``_flash_kernel``). The CUDA source is
``srgd_tpu_torch/csrc/attention.cu``.

What bounds it on the H100: operations. At the flagship's bottleneck
(b = 8, 4 heads, n = 1024, d = 32, bf16) q, k, v and the output are 8.4 MB
together while the two products are 4.3 GFLOP (both from the shapes). The
plain version also writes and reads the (b, heads, n, n) float scores and
probabilities through device memory, 134 MB each. What the design does about
it: an online softmax over 64-key tiles, so no score reaches device memory,
with q, k and v taken by their strides, so the transposed views of one qkv
projection are read in place. In bfloat16 both products run on the tensor
cores in the shape of FlashAttention-2: each warp keeps 16 query rows as
``mma.sync`` fragments in registers, K and V tiles arrive as bf16 through a
three-stage ``cp.async`` ring, the probabilities are rounded to bf16 in
registers and reused as the operand of P V, and the scale is folded into
the multiply-add ahead of ``ex2``. With d = 32 there is one exponential for every
64 multiply-adds, so the softmax sets the pace. In float32, the exact path,
the products are float FMAs on the CUDA cores. Times: PERF.md.

The bfloat16 kernel rounds at two points where the TPU kernel does not: q is
not scaled before the product (the scale is applied to the float score) and
p is rounded to bf16 before P V. ``tests/test_torch_kernels.py`` repeats that
arithmetic in plain PyTorch and holds it to the tolerance on the CPU.
"""

from __future__ import annotations

import torch

from srgd_tpu_torch.kernels import _build
from srgd_tpu_torch.kernels._autograd import forward_only

launches = 0   # kernel launches through attention (never the plain version)

TILE_K = 64    # csrc TK: keys per tile


def attention_plain(q, k, v):
    """Plain PyTorch version with the kernel's rounding points: q, k, v
    widened to float32, q scaled before the product, float32 softmax and
    products, the result cast to q's dtype."""
    scale = q.shape[-1] ** -0.5
    sim = (q.float() * scale) @ k.float().transpose(-1, -2)
    return (torch.softmax(sim, dim=-1) @ v.float()).to(q.dtype)


def _strides(t):
    sb, sh, sn, sd = t.stride()
    if sd != 1 or max(sb, sh, sn) >= 2 ** 31 or min(sb, sh, sn) < 0:
        raise ValueError(f'attention kernel needs a unit channel stride and '
                         f'strides under 2**31; got {t.stride()}')
    return sb, sh, sn


def _launch(q, k, v):
    global launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'attention takes q, k, v of one shape (b, heads, n, '
                         f'd); got {tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    b, heads, n, d = q.shape
    if d != 32:
        raise ValueError(f'attention kernel needs d = 32, got {d}')
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'attention kernel takes float32 or bfloat16, '
                        f'got {q.dtype}')
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError('q, k and v must share dtype and device')
    if b == 0 or n == 0 or b * heads > 65535:
        raise ValueError(f'attention kernel needs 0 < b * heads <= 65535 and '
                         f'n > 0; got b {b}, heads {heads}, n {n}')
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
                    for t in (q, k, v)):
        raise ValueError('the bfloat16 attention kernel copies 16 bytes at a '
                         'time: q, k and v need 16-byte aligned storage and '
                         'strides that are multiples of 8 elements; got '
                         f'{q.stride()}, {k.stride()}, {v.stride()}')
    # written as (b, n, heads, d), so that the caller's merge of the heads
    # into (b, n, heads * d) is a view
    out = torch.empty((b, n, heads, d), device=q.device,
                      dtype=q.dtype).permute(0, 2, 1, 3)
    strides = [s for t in (q, k, v, out) for s in _strides(t)]
    name = 'srgd_attention_bf16' if bf16 else 'srgd_attention_f32'
    fn = _build.entry(name, 4, 15)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, heads, n, *strides, stream)
    _build.check(err, name)
    launches += 1
    return out


def attention(q, k, v):
    """Signature of ``fused_attention``: q, k, v (b, heads, n, d) ->
    (b, heads, n, d) in q's dtype, ``softmax(q k^T * d^-0.5) v`` with float32
    accumulation. The operands may be strided views with a unit channel
    stride; on the card the result is laid out (b, n, heads, d) in memory.
    A CPU tensor takes the plain version, a CUDA tensor the CUDA kernel
    (which raises rather than fall back); anything else raises. Forward
    only, as in the JAX package: a backward through it raises
    (``_autograd.forward_only``)."""
    return forward_only('attention', _route, q, k, v)


def _route(q, k, v):
    if q.device.type == 'cpu':
        return attention_plain(q, k, v)
    if q.device.type == 'cuda':
        return _launch(q, k, v)
    raise RuntimeError(f'attention: no kernel for device {q.device}')
