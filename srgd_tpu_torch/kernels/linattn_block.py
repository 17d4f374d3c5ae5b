"""Fused whole-block linear attention: a CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``srgd_tpu/kernels/linattn_block.py``
(``fused_linattn_block``, kernel body ``_kernel``). The CUDA source is
``srgd_tpu_torch/csrc/linattn_block.cu``.

What bounds it on the H100: memory, once the products run on tensor cores.
At the flagship's stage 0 under CFG (b = 16, n = 65536, c = 128, bf16) the
block's only unavoidable traffic is x read twice (phase A and phase B) and
the output written once: about 0.8 GB per call, computed from the shapes,
against about 160 GFLOP of small projections. The plain version
materialises q, k, v, their softmaxes and the context products as float
tensors of (b, n, 128) each, many times that traffic.

What the design does about it: x crosses device memory once per phase and the
output once; everything between (the normalised rows, q/k/v, both softmaxes,
the attention output) lives in shared memory and registers. Phase A streams
each split of the sequence with the online-max update and leaves only per-split
partials (m, z and the head-diagonal context blocks, 16 KB per split); a merge
normalises the context once; phase B recomputes q per row tile and writes the
output. In bfloat16 the projections and the context product are ``wgmma``
on the tensor cores over 64-row bf16 tiles: the weights stay resident in
shared memory for c <= 256 (they stream through a ``cp.async`` ring at
c = 512), blocks walk many row tiles, the next tile's 16-byte loads are in
flight under this tile's products, k and v are computed transposed so that
the k-softmax statistics stay inside a quad and exp(k - m) feeds the context
product from registers, and the q-softmax is taken on the accumulator. In float32, the exact path, the products are float FMAs on the
CUDA cores. Times: PERF.md.

The wrapper packs the weights for the bfloat16 kernel on every call
(``pack_weights``): wk | wv side by side as one (c, 256) operand, and all
zero-padded to 128 hidden columns, so the kernel needs no case for a
narrower hidden width.
"""

from __future__ import annotations

import math

import torch

from srgd_tpu_torch.kernels import _build
from srgd_tpu_torch.kernels._autograd import recompute_backward

launches = 0   # kernel launches through linattn_block (never the plain version)

TILE_ROWS = 64        # csrc TMR: rows per tile of the bfloat16 kernel (the
                      # float32 kernel's 32-row tiles divide it)
TARGET_BLOCKS = 264   # phase A blocks to aim for: two per SM of an H100
MAX_HIDDEN = 128      # csrc MAXH: 4 heads x 32


def _head_mask(hidden: int, dim_head: int, device) -> torch.Tensor:
    idx = torch.arange(hidden, device=device) // dim_head
    return (idx[:, None] == idx[None, :]).float()


def linattn_core_plain(q, k, v, dim_head: int, cd):
    """The linear-attention core on float32 q, k, v (b, n, hidden), v already
    rounded to the compute dtype ``cd``: the per-head q softmax (scaled), the
    k softmax over n and the head-masked context are rounded to ``cd``, the
    products accumulate in float32. Returns float32 (b, n, hidden)."""
    mask = _head_mask(q.shape[-1], dim_head, q.device)

    def rnd(t):
        return t.to(cd).float()

    eq = torch.exp(q - torch.amax(q, dim=-1, keepdim=True))
    qn = rnd(eq / (eq @ mask) * (dim_head ** -0.5))
    ek = torch.exp(k - torch.amax(k, dim=1, keepdim=True))   # softmax over n
    kn = rnd(ek / torch.sum(ek, dim=1, keepdim=True))
    ctx = rnd((kn.transpose(1, 2) @ v) * mask)
    return qn @ ctx


def linattn_block_plain(x, g1, wq, wk, wv, wout, bout, g2, *, dim_head: int):
    """Plain PyTorch version of the same block; mirrors ``_xla_linattn_block``.

    x: (b, n, c); g1, g2, bout: (c,); wq, wk, wv: (c, hidden); wout:
    (hidden, c). Products take operands rounded to the compute dtype and
    accumulate in float32, which is what ``preferred_element_type=float32``
    gives in JAX."""
    b, n, c = x.shape
    cd = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32

    def rnd(t):
        return t.to(cd).float()

    def rms(t, g):
        tf = t.float()
        norm = torch.sqrt(torch.sum(tf * tf, dim=-1, keepdim=True))
        return tf / torch.clamp_min(norm, 1e-12) * (g.float() * math.sqrt(c))

    y = rnd(rms(x, g1))
    attn = linattn_core_plain(y @ rnd(wq), y @ rnd(wk), rnd(y @ rnd(wv)),
                              dim_head, cd)
    out = rnd(attn) @ rnd(wout) + bout.float()
    return rms(out, g2).to(x.dtype)


def _split(b: int, n: int) -> tuple[int, int]:
    """(rows_per_split, nsplit) for phase A: at most TARGET_BLOCKS blocks over
    b * nsplit (a few blocks more would run as a wave of their own), each
    split a whole number of row tiles."""
    tiles = -(-n // TILE_ROWS)
    nsplit = max(1, min(tiles, TARGET_BLOCKS // b))
    rows = -(-tiles // nsplit) * TILE_ROWS
    return rows, -(-n // rows)


def pack_weights(wq, wk, wv, wout):
    """The bfloat16 kernel's operands: wq (c, 128), wk | wv (c, 256) with wv
    from column 128, wout (128, c), each zero past ``hidden``. At the full
    hidden width wq and wout are passed through and only wk | wv is copied."""
    c, hidden = wq.shape
    if hidden == MAX_HIDDEN:
        return wq, torch.cat((wk, wv), dim=1), wout
    wq_p = wq.new_zeros((c, MAX_HIDDEN))
    wkv_p = wq.new_zeros((c, 2 * MAX_HIDDEN))
    wout_p = wq.new_zeros((MAX_HIDDEN, c))
    wq_p[:, :hidden] = wq
    wkv_p[:, :hidden] = wk
    wkv_p[:, MAX_HIDDEN:MAX_HIDDEN + hidden] = wv
    wout_p[:hidden] = wout
    return wq_p, wkv_p, wout_p


def _launch(x, g1, wq, wk, wv, wout, bout, g2, dim_head):
    global launches
    b, n, c = x.shape
    hidden = wq.shape[1]
    if dim_head != 32 or hidden % 32 or hidden > 128:
        raise ValueError(f'linattn_block kernel needs dim_head 32 and hidden '
                         f'a multiple of 32 up to 128; got dim_head '
                         f'{dim_head}, hidden {hidden}')
    if c > 512:
        raise ValueError(f'linattn_block kernel takes c <= 512, got {c}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'linattn_block kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    dev, dt = x.device, x.dtype
    bf16 = dt == torch.bfloat16
    if bf16 and c % 16:
        raise ValueError(f'the bfloat16 linattn_block kernel multiplies in '
                         f'steps of 16 channels: c must be a multiple of 16, '
                         f'got {c}')
    x = x.contiguous()
    if bf16 and x.data_ptr() % 16:
        raise ValueError('the bfloat16 linattn_block kernel needs 16-byte '
                         'aligned x')
    wq, wk, wv, wout = (w.to(device=dev, dtype=dt).contiguous()
                        for w in (wq, wk, wv, wout))
    g1s = (g1.float() * math.sqrt(c)).contiguous()
    g2s = (g2.float() * math.sqrt(c)).contiguous()
    bout = bout.float().contiguous()
    for t in (g1s, g2s, bout):
        if t.device != dev or t.shape != (c,):
            raise ValueError('g1, g2 and bout must be (c,) on the device of x')
    if wq.shape != (c, hidden) or wk.shape != (c, hidden) or \
            wv.shape != (c, hidden) or wout.shape != (hidden, c):
        raise ValueError('weights must be (c, hidden) x3 and (hidden, c)')

    rows, nsplit = _split(b, n)
    f32 = dict(device=dev, dtype=torch.float32)
    part_m = torch.empty((b, nsplit, hidden), **f32)
    part_z = torch.empty((b, nsplit, hidden), **f32)
    part_ctx = torch.empty((b, nsplit, hidden, 32), **f32)
    ctxn = torch.empty((b, hidden, 32), **f32)
    out = torch.empty_like(x)

    if bf16:
        name = 'srgd_linattn_block_bf16'
        weights = pack_weights(wq, wk, wv, wout)
    else:
        name = 'srgd_linattn_block_f32'
        weights = (wq, wk, wv, wout)
    fn = _build.entry(name, 9 + len(weights), 6)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), g1s.data_ptr(), *(w.data_ptr() for w in weights),
                 bout.data_ptr(),
                 g2s.data_ptr(), out.data_ptr(), part_m.data_ptr(),
                 part_z.data_ptr(), part_ctx.data_ptr(), ctxn.data_ptr(),
                 b, n, c, hidden, rows, nsplit, stream)
    _build.check(err, name)
    launches += 1
    return out


class _LinattnBlock(torch.autograd.Function):
    """``fused_linattn_block``'s ``custom_vjp``: the forward is the kernel
    (the plain version on the CPU) and saves only the primal inputs; the
    backward recomputes ``linattn_block_plain`` from them and takes its VJP,
    as ``_fused_linattn_block_bwd`` takes that of ``_xla_linattn_block``."""

    @staticmethod
    def forward(ctx, x, g1, wq, wk, wv, wout, bout, g2, dim_head):
        ctx.save_for_backward(x, g1, wq, wk, wv, wout, bout, g2)
        ctx.dim_head = dim_head
        if x.device.type == 'cpu':
            return linattn_block_plain(x, g1, wq, wk, wv, wout, bout, g2,
                                       dim_head=dim_head)
        if x.device.type == 'cuda':
            return _launch(x, g1, wq, wk, wv, wout, bout, g2, dim_head)
        raise RuntimeError(f'linattn_block: no kernel for device {x.device}')

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_backward('linattn_block', linattn_block_plain,
                                   ctx.saved_tensors,
                                   ctx.needs_input_grad[:8], grad_out,
                                   dim_head=ctx.dim_head)
        return (*grads, None)


def linattn_block(x, g1, wq, wk, wv, wout, bout, g2, *, dim_head: int = 32):
    """The whole LinearAttention block; signature of ``fused_linattn_block``.

    x: (b, n, c). g1/g2: (c,) RMSNorm gains. wq/wk/wv: (c, hidden). wout:
    (hidden, c), bout: (c,). Returns (b, n, c) in x's dtype; the residual add
    stays with the caller. A CPU tensor takes the plain version, a CUDA tensor
    the CUDA kernel (which raises rather than fall back); anything else
    raises. Differentiable in every input: the backward recomputes the plain
    version (``_LinattnBlock``) and launches no kernel."""
    return _LinattnBlock.apply(x, g1, wq, wk, wv, wout, bout, g2, dim_head)
