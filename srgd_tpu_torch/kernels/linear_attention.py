"""The linear-attention core from separate or packed q, k, v: a CUDA kernel
with two entries, and their plain versions.

Replaces the Pallas TPU kernels of ``srgd_tpu/kernels/linear_attention.py``:
``fused_linear_attention`` (``linear_attention`` here) and
``fused_linear_attention_qkv`` (``linear_attention_qkv``). The CUDA source is
``srgd_tpu_torch/csrc/linear_attention.cu``: one device implementation that
addresses q, k and v by three base pointers and a row stride, so the packed
(b, n, 3C) projection is read in place and the two entries agree bit for bit.

What bounds it on the H100: bytes. Per call the function reads q, k, v and
writes the output once, 4 b n C elements (0.54 GB at b = 8, n = 65536,
C = 128 in bf16), against 16 flops a byte in the head-diagonal products, far
under the card's ridge. The plain version materialises the float32
exponentials of q and k and the (b, n, C) quotients in device memory.

What the design does about it: k and v stream once, split over the sequence
into per-block partials that a merge kernel combines in a fixed order; q
streams once through a pass that owns whole rows; only the head-diagonal
32 x 32 blocks of the context are computed. In bfloat16 both passes copy
16-byte pieces through ``cp.async`` rings (three stages in pass A, two in
pass C), take the softmax statistics with every thread of a block, and run
the products as ``mma.sync`` on the tensor cores. That path rounds three
intermediates to bfloat16 that the TPU kernel keeps in float: exp(k - m)
(before its division by the column sum), the normalised context and the
normalised q (``tests/test_torch_rounding.py`` repeats that arithmetic in
plain PyTorch). The plain versions keep the TPU kernel's all-float math. In
float32 the products are float FMAs on the CUDA cores. Times: PERF.md.
"""

from __future__ import annotations

import torch

from srgd_tpu_torch.kernels import _build
from srgd_tpu_torch.kernels._autograd import forward_only
from srgd_tpu_torch.kernels.linattn_block import _head_mask, _split

launches = 0       # kernel launches through linear_attention (separate q, k, v)
launches_qkv = 0   # kernel launches through linear_attention_qkv (packed)


def linear_attention_plain(q, k, v, *, dim_head: int = 32):
    """Plain PyTorch version with the kernel's rounding points: operands
    widened to float32 and every intermediate float32 (the stabilised
    exponentials, the full (C, C) context, its division by the column sums,
    head mask and ``dim_head^-0.5``, the q softmax by the row max over all
    heads); only the result is cast to q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    mask = _head_mask(q.shape[-1], dim_head, q.device)
    ek = torch.exp(kf - torch.amax(kf, dim=1, keepdim=True))
    s = ek.sum(dim=1)                                     # (b, C)
    ctx = ek.transpose(1, 2) @ vf                         # (b, C, C)
    cn = ctx / s[:, :, None] * mask * (dim_head ** -0.5)
    eq = torch.exp(qf - torch.amax(qf, dim=-1, keepdim=True))
    return ((eq / (eq @ mask)) @ cn).to(q.dtype)


def linear_attention_qkv_plain(qkv, *, dim_head: int = 32):
    """Plain PyTorch version of the packed entry: qkv (b, n, 3C) = [q|k|v]."""
    q, k, v = qkv.chunk(3, dim=-1)
    return linear_attention_plain(q, k, v, dim_head=dim_head)


def _launch(q, k, v, b, n, c, ld, dim_head):
    """q, k, v: tensors whose data pointers are the bases of (b, n, c)
    operands with row stride ld and batch stride n * ld."""
    if dim_head != 32 or c % 32 or not 0 < c <= 128:
        raise ValueError(f'linear_attention kernel needs dim_head 32 and C a '
                         f'multiple of 32 up to 128; got dim_head {dim_head}, '
                         f'C {c}')
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'linear_attention kernel takes float32 or bfloat16, '
                        f'got {q.dtype}')
    if b == 0 or n == 0 or b > 65535:
        raise ValueError(f'linear_attention kernel needs 0 < b <= 65535 and '
                         f'n > 0; got b {b}, n {n}')
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError('the bfloat16 linear_attention kernel copies 16 '
                         'bytes at a time: q, k and v need 16-byte aligned '
                         'storage')
    dev = q.device
    rows, nsplit = _split(b, n)
    f32 = dict(device=dev, dtype=torch.float32)
    part_m = torch.empty((b, nsplit, c), **f32)
    part_z = torch.empty((b, nsplit, c), **f32)
    part_ctx = torch.empty((b, nsplit, c, 32), **f32)
    cn = torch.empty((b, c, 32), **f32)
    out = torch.empty((b, n, c), device=dev, dtype=q.dtype)
    name = ('srgd_linear_attention_bf16' if q.dtype == torch.bfloat16
            else 'srgd_linear_attention_f32')
    fn = _build.entry(name, 8, 6)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 part_m.data_ptr(), part_z.data_ptr(), part_ctx.data_ptr(),
                 cn.data_ptr(), b, n, ld, c, rows, nsplit, stream)
    _build.check(err, name)
    return out


def linear_attention(q, k, v, *, dim_head: int = 32):
    """Signature of ``fused_linear_attention``: q, k, v (b, n, C) with the
    heads packed as c = head * dim_head + d. Returns (b, n, C) in q's dtype:

        out[n, e] = sum_d softmax_d(q)[n, d] * dim_head^-0.5 * ctx[d, e]
        ctx[d, e] = sum_n softmax_n(k)[n, d] * v[n, e]      (within a head)

    A CPU tensor takes the plain version, a CUDA tensor the CUDA kernel, which
    needs contiguous operands and raises rather than fall back or copy;
    anything else raises. Forward only, as in the JAX package: a backward
    through it raises (``_autograd.forward_only``)."""
    return forward_only('linear_attention',
                        lambda *t: _separate(*t, dim_head), q, k, v)


def _separate(q, k, v, dim_head):
    global launches
    if q.device.type == 'cpu':
        return linear_attention_plain(q, k, v, dim_head=dim_head)
    if q.device.type != 'cuda':
        raise RuntimeError(f'linear_attention: no kernel for device {q.device}')
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError('linear_attention takes q, k, v of one shape (b, n, C)')
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError('q, k and v must share dtype and device')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('linear_attention kernel needs contiguous q, k, v; '
                         'for slices of one projection use linear_attention_qkv')
    b, n, c = q.shape
    out = _launch(q, k, v, b, n, c, c, dim_head)
    launches += 1
    return out


def linear_attention_qkv(qkv, *, dim_head: int = 32):
    """Signature of ``fused_linear_attention_qkv``: qkv (b, n, 3C) packed
    [q|k|v], exactly the to_qkv projection's output, so no slice is ever
    materialised. Returns (b, n, C); see ``linear_attention``."""
    return forward_only('linear_attention_qkv',
                        lambda t: _packed(t, dim_head), qkv)


def _packed(qkv, dim_head):
    global launches_qkv
    if qkv.device.type == 'cpu':
        return linear_attention_qkv_plain(qkv, dim_head=dim_head)
    if qkv.device.type != 'cuda':
        raise RuntimeError(
            f'linear_attention_qkv: no kernel for device {qkv.device}')
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError('linear_attention_qkv takes qkv of shape (b, n, 3C)')
    if not qkv.is_contiguous():
        raise ValueError('linear_attention_qkv kernel needs a contiguous qkv; '
                         'it does not copy')
    b, n, c3 = qkv.shape
    c = c3 // 3
    out = _launch(qkv, qkv[:, :, c:], qkv[:, :, 2 * c:], b, n, c, c3, dim_head)
    launches_qkv += 1
    return out
