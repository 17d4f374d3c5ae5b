"""Fused whole-block full attention: a CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``srgd_tpu/kernels/attn_block.py``
(``fused_attn_block``, kernel body ``_kernel``). The CUDA source is
``srgd_tpu_torch/csrc/attn_block.cu``.

What bounds it on the H100: memory. At the 32x32 bottleneck (n = 1024,
c = 512 or 1024) the block itself moves little (x in, qkv out and back, the
output), but the plain version writes and reads its (b, 4, 1024, 1024) float
score and probability tensors through device memory, 134 MB each at b = 8
(computed from the shapes). What the design does about it: scores never
leave the block. Launch 1 writes qkv (b, n, 384) once in the compute dtype;
launch 2 runs each 32-row query tile over 64-key tiles with an online
softmax in shared memory, then P.V and to_out + bias. Products use float
FMAs on the CUDA cores in this first version, so at c = 1024 it is slower
than the plain version, whose projections go to cuBLAS: 1.44 ms against
1.10 ms at b = 8 in bf16 (chip_smoke.py on an NVIDIA H100 80GB HBM3 at a
700 W power limit; PERF.md). Tensor cores are the next step.
"""

from __future__ import annotations

import math

import torch

from srgd_tpu_torch.kernels import _build

launches = 0   # kernel launches through attn_block (never the plain version)


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


def _launch(x, g1, wqkv, wout, bout, heads, dim_head):
    global launches
    b, n, c = x.shape
    hidden = heads * dim_head
    if dim_head != 32 or hidden > 128:
        raise ValueError(f'attn_block kernel needs dim_head 32 and at most 4 '
                         f'heads; got heads {heads}, dim_head {dim_head}')
    if c > 1024:
        raise ValueError(f'attn_block kernel takes c <= 1024, got {c}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'attn_block kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    dev, dt = x.device, x.dtype
    x = x.contiguous()
    wqkv = wqkv.to(device=dev, dtype=dt).contiguous()
    wout = wout.to(device=dev, dtype=dt).contiguous()
    g1s = (g1.float() * math.sqrt(c)).contiguous()
    bout = bout.float().contiguous()
    if g1s.device != dev or g1s.shape != (c,) or bout.device != dev or \
            bout.shape != (c,):
        raise ValueError('g1 and bout must be (c,) on the device of x')
    if wqkv.shape != (c, 3 * hidden) or wout.shape != (hidden, c):
        raise ValueError('weights must be (c, 3*hidden) and (hidden, c)')

    qkv = torch.empty((b, n, 3 * hidden), device=dev, dtype=dt)
    out = torch.empty_like(x)
    name = ('srgd_attn_block_bf16' if dt == torch.bfloat16
            else 'srgd_attn_block_f32')
    fn = _build.entry(name, 7, 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), g1s.data_ptr(), wqkv.data_ptr(),
                 wout.data_ptr(), bout.data_ptr(), qkv.data_ptr(),
                 out.data_ptr(), b, n, c, hidden, stream)
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
