"""Fused whole-block full attention: a CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``srgd_tpu/kernels/attn_block.py``
(``fused_attn_block``, kernel body ``_kernel``). The CUDA source is
``srgd_tpu_torch/csrc/attn_block.cu``; its attention core is
``csrc/flash.cuh``, the loop of the ``attention`` kernel.

What bounds it on the H100: operations. At (8, 1024, 1024) in bf16 the
block does 12.9 GFLOP (the qkv and output projections 6.4 and 2.1, the
attention products 4.3) against 34.6 MB of x, output and weights (computed
from the shapes), and within the attention core d = 32 gives one
exponential for every 64 multiply-adds, so the exponentials set the pace
there. The plain version also writes and reads its (b, 4, n, n) float score
and probability tensors through device memory.

What the design does about it, in bfloat16: three launches on the tensor
cores. RMSNorm + qkv projection (``wgmma``, one 64-row tile and one
128-column group of the 384 a block, the weight streamed through a
``cp.async`` ring) writes qkv (b, n, 384) once as bf16 scratch, which stays
in the L2; the attention runs ``flash.cuh``'s ``mma.sync`` loop on strided
views of it, so no score leaves the SM; to_out + bias is the same tile
product on the attention output. The rounding points are
``_xla_attn_block``'s, except that the probabilities are rounded to bf16
before their division by the row sum (the online softmax divides last). In
float32, the exact path, the products are float FMAs on the CUDA cores.
Times: PERF.md.

The wrapper packs wqkv for the bfloat16 kernel when hidden < 128
(``pack_qkv``): q, k and v each zero-padded to 128 columns, so the kernel
always reads a (c, 384) weight.
"""

from __future__ import annotations

import math

import torch

from srgd_tpu_torch.kernels import _build

launches = 0   # kernel launches through attn_block (never the plain version)

MAX_HIDDEN = 128   # csrc MAXH: 4 heads x 32


def attn_block_plain(x, g1, wqkv, wout, bout, *, heads: int, dim_head: int):
    """Plain PyTorch version of the same block; mirrors ``_xla_attn_block``
    (operands rounded to the compute dtype, float32 accumulation)."""
    b, n, c = x.shape
    hidden = heads * dim_head
    cd = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32

    def rnd(t):
        return t.to(cd).float()

    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    y = rnd(xf / torch.clamp_min(norm, 1e-12) * (g1.float() * math.sqrt(c)))
    qkv = rnd(y @ rnd(wqkv))
    q, k, v = (qkv[..., i * hidden:(i + 1) * hidden]
               .reshape(b, n, heads, dim_head).transpose(1, 2)
               for i in range(3))
    sim = (q @ k.transpose(-1, -2)) * (dim_head ** -0.5)
    attn = rnd(torch.softmax(sim, dim=-1))
    o = rnd(attn @ v).transpose(1, 2).reshape(b, n, hidden)
    out = o @ rnd(wout) + bout.float()
    return out.to(x.dtype)



def pack_qkv(wqkv, hidden: int):
    """The bfloat16 kernel's qkv weight: (c, 3 * hidden) -> (c, 384) with q,
    k and v at columns 0, 128 and 256, each zero past ``hidden``; at the full
    width it is passed through."""
    if hidden == MAX_HIDDEN:
        return wqkv
    c = wqkv.shape[0]
    packed = wqkv.new_zeros((c, 3 * MAX_HIDDEN))
    for i in range(3):
        packed[:, i * MAX_HIDDEN:i * MAX_HIDDEN + hidden] = \
            wqkv[:, i * hidden:(i + 1) * hidden]
    return packed


def _launch(x, g1, wqkv, wout, bout, heads, dim_head):
    global launches
    b, n, c = x.shape
    hidden = heads * dim_head
    if dim_head != 32 or hidden > MAX_HIDDEN:
        raise ValueError(f'attn_block kernel needs dim_head 32 and at most 4 '
                         f'heads; got heads {heads}, dim_head {dim_head}')
    if c > 1024:
        raise ValueError(f'attn_block kernel takes c <= 1024, got {c}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'attn_block kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    dev, dt = x.device, x.dtype
    bf16 = dt == torch.bfloat16
    if bf16 and c % 16:
        raise ValueError(f'the bfloat16 attn_block kernel multiplies in '
                         f'steps of 16 channels: c must be a multiple of 16, '
                         f'got {c}')
    if b == 0 or n == 0 or b * heads > 65535 or -(-n // 64) > 65535:
        raise ValueError(f'attn_block kernel needs 0 < b * heads <= 65535 and '
                         f'0 < n <= 64 * 65535; got b {b}, heads {heads}, '
                         f'n {n}')
    x = x.contiguous()
    if bf16 and x.data_ptr() % 16:
        raise ValueError('the bfloat16 attn_block kernel needs 16-byte '
                         'aligned x')
    wqkv = wqkv.to(device=dev, dtype=dt).contiguous()
    wout = wout.to(device=dev, dtype=dt).contiguous()
    g1s = (g1.float() * math.sqrt(c)).contiguous()
    bout = bout.float().contiguous()
    if g1s.device != dev or g1s.shape != (c,) or bout.device != dev or \
            bout.shape != (c,):
        raise ValueError('g1 and bout must be (c,) on the device of x')
    if wqkv.shape != (c, 3 * hidden) or wout.shape != (hidden, c):
        raise ValueError('weights must be (c, 3*hidden) and (hidden, c)')

    out = torch.empty_like(x)
    if bf16:
        name = 'srgd_attn_block_bf16'
        wqkv = pack_qkv(wqkv, hidden)
        qkv = torch.empty((b, n, 3 * MAX_HIDDEN), device=dev, dtype=dt)
        o = torch.empty((b, n, hidden), device=dev, dtype=dt)
        scratch = (qkv, o)
    else:
        name = 'srgd_attn_block_f32'
        scratch = (torch.empty((b, n, 3 * hidden), device=dev, dtype=dt),)
    fn = _build.entry(name, 6 + len(scratch), 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), g1s.data_ptr(), wqkv.data_ptr(),
                 wout.data_ptr(), bout.data_ptr(),
                 *(t.data_ptr() for t in scratch), out.data_ptr(),
                 b, n, c, hidden, stream)
    _build.check(err, name)
    launches += 1
    return out


def attn_block(x, g1, wqkv, wout, bout, *, heads: int = 4,
               dim_head: int = 32):
    """The whole Attention block; signature of ``fused_attn_block``.

    x: (b, n, c); g1: (c,) RMSNorm gain; wqkv: (c, 3*heads*dim_head); wout:
    (hidden, c); bout: (c,). Returns (b, n, c) = to_out(SDPA(qkv(RMSNorm(x))))
    in x's dtype; the residual add stays with the caller. A CPU tensor takes
    the plain version, a CUDA tensor the CUDA kernel (which raises rather than
    fall back); anything else raises. Forward only."""
    if x.device.type == 'cpu':
        return attn_block_plain(x, g1, wqkv, wout, bout, heads=heads,
                                dim_head=dim_head)
    if x.device.type == 'cuda':
        return _launch(x, g1, wqkv, wout, bout, heads, dim_head)
    raise RuntimeError(f'attn_block: no kernel for device {x.device}')
