"""U-Net building blocks (PyTorch, NCHW run in ``channels_last`` memory).

Counterpart of ``srgd_tpu/nn/layers.py``. Parameter names are the reference
checkpoint's torch keys (the keys ``flax_to_torch_unet_state_dict`` emits and
``tests/torch_ref.py`` reads), so a reference state dict loads with
``load_state_dict(strict=True)``.

Precision follows the JAX modules with explicit casts at the same points:
parameters are stored in float32, or in bfloat16 under ``param_dtype:
bfloat16``; convolutions take their input, weight and bias in the net's
compute dtype; norm statistics, FiLM and the time/class MLPs are float32.
No autocast: its rounding points differ.

Channel-order contracts that checkpoint parity depends on (NCHW gives them
for free, the JAX package reproduces them by hand in NHWC):
- pixel-shuffle: ``F.pixel_shuffle(2)`` reads channel o = c*4 + dy*2 + dx
- space-to-depth: ``F.pixel_unshuffle(2)`` writes channel o = c*4 + p1*2 + p2,
  the reference's Rearrange 'b c (h p1) (w p2) -> b (c p1 p2) h w'
- multi-head qkv: heads packed head-major in the channel dim, h*dim_head + d

By default the attention blocks run the whole block through the fused
kernels (``srgd_tpu_torch.kernels``) in every precision: on a CUDA tensor the
CUDA kernel, on a CPU tensor its plain version. An NCHW ``channels_last``
tensor viewed as (b, h*w, c) is the kernels' input with no copy.

``Block`` runs GroupNorm -> FiLM -> SiLU as one ``block_norm_silu`` call
whenever autograd records nothing (sampling), and in float32 PyTorch ops,
which have a backward, when it does (training).

``use_pallas`` (the JAX modules' name for the flag, kept) selects the other
kernel set, as ``srgd_tpu/nn/layers.py`` routes it: ``Block`` norms through
``groupnorm_silu``, ``LinearAttention`` runs RMSNorm -> to_qkv ->
``linear_attention_qkv`` -> to_out -> RMSNorm, and ``Attention`` runs
RMSNorm -> to_qkv -> ``attention`` -> to_out.

``quant`` ('w8a8[:alpha[:cal_mode]]', ``nn.quant.conv``) makes the convs of
``Block``, ``ResnetBlock``'s residual, ``LinearAttention`` and the resamplers
``QuantConv``s, at the JAX package's sites. A quantized ``LinearAttention``
leaves ``linattn_block`` for RMSNorm -> quantized to_qkv ->
``linear_attention_qkv`` -> quantized to_out -> RMSNorm, the JAX module's
submodule path; with ``use_pallas`` as well its to_out runs in float where
the JAX module's Pallas branch (n % 256 == 0) declares a float conv.
``Attention`` accepts ``quant`` and ignores it, as the JAX module does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from srgd_tpu_torch.kernels.attention import attention
from srgd_tpu_torch.kernels.attn_block import attn_block
from srgd_tpu_torch.kernels.groupnorm_silu import (block_norm_silu,
                                                   groupnorm_silu)
from srgd_tpu_torch.kernels.linattn_block import linattn_block
from srgd_tpu_torch.kernels.linear_attention import linear_attention_qkv


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype``: input, weight and bias are cast
    to it, as flax ``nn.Conv(dtype=...)`` casts them (the output stays in
    ``dtype``). The weight goes to channels_last with the cast, matching the
    activations' memory format."""

    def __init__(self, *args, dtype=torch.float32, device=None, **kw):
        super().__init__(*args, device=device, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        weight = self.weight.to(dtype=dt, memory_format=torch.channels_last)
        return F.conv2d(x.to(dt), weight, bias, padding=self.padding)


class Linear(nn.Linear):
    """``nn.Linear`` computing in float32 whatever its parameters' storage
    dtype, as flax ``nn.Dense`` promotes bfloat16 parameters against a
    float32 input."""

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


def _conv(in_ch, out_ch, kernel_size, *, quant=None, **kw):
    """``Conv2d``, or its W8A8 twin when ``quant`` is set (``nn.quant.conv``;
    imported here because ``nn.quant`` builds on ``Conv2d``)."""
    from srgd_tpu_torch.nn.quant import conv
    return conv(in_ch, out_ch, kernel_size, quant=quant, **kw)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """Channel RMS norm: x / max(||x||_2, 1e-12) * g * sqrt(C), statistics in
    float32, output in ``dtype``. Parameter ``g`` is (1, C, 1, 1) as in the
    reference."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1, device=device))
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
        out = xf / torch.clamp_min(norm, 1e-12) * self.g * math.sqrt(x.shape[1])
        return out.to(self.dtype)


def group_norm(x, weight, bias, num_groups: int = 8, eps: float = 1e-5):
    """GroupNorm in float32 (torch ``nn.GroupNorm`` semantics)."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(),
                        eps=eps)


# ---------------------------------------------------------------------------
# Time / class embeddings
# ---------------------------------------------------------------------------

class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        half = self.dim // 2
        scale = math.log(10000) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=x.device) * -scale)
        arg = x.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


class LearnedSinusoidalPosEmb(nn.Module):
    """[x, sin(2 pi x w), cos(2 pi x w)]: output dim + 1. Parameter ``weights``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(dim // 2, device=device))

    def forward(self, x):
        x = x.float()[:, None]
        freqs = x * self.weights[None, :] * (2 * math.pi)
        return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class TimeMLP(nn.Sequential):
    """pos_emb -> Linear -> GELU (exact) -> Linear, in float32 (keys 0, 1, 3)."""

    def __init__(self, dim: int, time_dim: int, learned_sinusoidal: bool,
                 learned_sinusoidal_dim: int, device=None):
        if learned_sinusoidal:
            emb = LearnedSinusoidalPosEmb(learned_sinusoidal_dim, device=device)
            fourier = learned_sinusoidal_dim + 1
        else:
            emb = SinusoidalPosEmb(dim)
            fourier = dim
        super().__init__(emb, Linear(fourier, time_dim, device=device),
                         nn.GELU(), Linear(time_dim, time_dim, device=device))


class ClassMLP(nn.Sequential):
    """Embedding -> Linear -> GELU (exact) -> Linear, float32 (keys 0, 1, 3)."""

    def __init__(self, num_classes: int, dim: int, time_dim: int, device=None):
        super().__init__(nn.Embedding(num_classes, dim, device=device),
                         Linear(dim, time_dim, device=device), nn.GELU(),
                         Linear(time_dim, time_dim, device=device))


# ---------------------------------------------------------------------------
# Conv blocks
# ---------------------------------------------------------------------------

def _film(scale, shift):
    """FiLM's scale and shift, each (b, c, 1, 1), as one (b, 2, c) tensor
    with the scale first: a view where they are the two halves of one row,
    as ``ResnetBlock`` chunks them from the time MLP's output, else
    stacked."""
    scale, shift = scale.flatten(1), shift.flatten(1)
    b, c = scale.shape
    if (scale.stride() == (2 * c, 1) and shift.stride() == scale.stride()
            and shift.dtype == scale.dtype
            and shift.untyped_storage().data_ptr()
            == scale.untyped_storage().data_ptr()
            and shift.data_ptr() == scale.data_ptr()
            + c * scale.element_size()):
        return scale.as_strided((b, 2, c), (2 * c, c, 1))
    return torch.stack([scale, shift], dim=1)


class Block(nn.Module):
    """conv3x3 -> GroupNorm(8) -> optional FiLM x*(scale+1)+shift -> SiLU.
    Norm, FiLM and SiLU in float32; output in ``dtype``. Everything after
    the conv is one kernel call on the conv's output in ``dtype``, with no
    float32 copy of the activation: with ``use_pallas`` ``groupnorm_silu``
    (the JAX Pallas kernel's folded arithmetic), else, whenever autograd
    records nothing, ``block_norm_silu`` (the default chain's arithmetic).
    With autograd recording, the default Block runs the chain in PyTorch
    ops, which have a backward."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8,
                 dtype=torch.float32, device=None, use_pallas: bool = False,
                 quant: str | None = None):
        super().__init__()
        self.proj = _conv(dim, dim_out, 3, padding=1, dtype=dtype,
                          device=device, quant=quant)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5, device=device)
        self.dtype = dtype
        self.use_pallas = use_pallas

    def forward(self, x, scale_shift=None):
        x = self.proj(x)
        if self.use_pallas or not torch.is_grad_enabled():
            kernel = groupnorm_silu if self.use_pallas else block_norm_silu
            film = None if scale_shift is None else _film(*scale_shift)
            # the NHWC view of the conv's channels_last output: no copy
            out = kernel(x.permute(0, 2, 3, 1), self.norm.weight,
                         self.norm.bias, film, groups=self.norm.num_groups,
                         eps=self.norm.eps)
            return out.permute(0, 3, 1, 2).to(self.dtype)
        x = group_norm(x, self.norm.weight, self.norm.bias,
                       self.norm.num_groups, self.norm.eps)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x).to(self.dtype)


class ResnetBlock(nn.Module):
    """Two FiLM'd blocks + 1x1 residual conv. The FiLM MLP is SiLU -> Linear
    (key ``mlp.1``) in float32; scale first, then shift."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int | None = None,
                 groups: int = 8, dtype=torch.float32, device=None,
                 use_pallas: bool = False, quant: str | None = None):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out * 2,
                                                    device=device))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups, dtype, device, use_pallas,
                            quant)
        self.block2 = Block(dim_out, dim_out, groups, dtype, device,
                            use_pallas, quant)
        self.res_conv = (_conv(dim, dim_out, 1, dtype=dtype, device=device,
                               quant=quant)
                         if dim != dim_out else None)

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            t = self.mlp(time_emb.float())[:, :, None, None]
            scale_shift = t.chunk(2, dim=1)
        h = self.block1(x, scale_shift=scale_shift)
        h = self.block2(h)
        return h + (self.res_conv(x) if self.res_conv is not None else x)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _as_rows(x):
    """NCHW -> (b, h*w, c); a view when x is channels_last."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _from_rows(y, h: int, w: int):
    """(b, h*w, c) -> NCHW in channels_last memory (a view)."""
    b, _, c = y.shape
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class LinearAttention(nn.Module):
    """Linear attention: q softmax over each head's channels, k softmax over
    the sequence, RMSNorm in and out. The whole block is one call of
    ``linattn_block``; with ``use_pallas`` it is RMSNorm -> to_qkv ->
    ``linear_attention_qkv`` on the packed projection -> to_out -> RMSNorm,
    at any n: the kernel masks a ragged tail, so the JAX module's
    n % 256 gate (its kernel's block size) has no counterpart here."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32, device=None, use_pallas: bool = False,
                 quant: str | None = None):
        super().__init__()
        hidden = heads * dim_head
        self.dim_head = dim_head
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.quant = quant
        self.norm = RMSNorm(dim, dtype, device)
        self.to_qkv = _conv(dim, hidden * 3, 1, bias=False, dtype=dtype,
                            device=device, quant=quant)
        self.to_out = nn.Sequential(
            _conv(hidden, dim, 1, dtype=dtype, device=device, quant=quant),
            RMSNorm(dim, dtype, device))

    def forward(self, x):
        b, c, h, w = x.shape
        if self.use_pallas or self.quant is not None:
            return self._unfused(x)
        wq, wk, wv = self.to_qkv.weight[:, :, 0, 0].t().chunk(3, dim=1)
        out = linattn_block(
            _as_rows(x.to(self.dtype)), self.norm.g.reshape(c), wq, wk, wv,
            self.to_out[0].weight[:, :, 0, 0].t(), self.to_out[0].bias,
            self.to_out[1].g.reshape(c), dim_head=self.dim_head)
        return _from_rows(out, h, w)

    def _unfused(self, x):
        h, w = x.shape[2:]
        qkv = _as_rows(self.to_qkv(self.norm(x)))       # (b, n, 3*hidden)
        out = linear_attention_qkv(qkv, dim_head=self.dim_head)
        out = _from_rows(out.to(self.dtype), h, w)
        if self.quant is not None and self.use_pallas and (h * w) % 256 == 0:
            # the JAX module's Pallas branch declares to_out a float nn.Conv
            out = Conv2d.forward(self.to_out[0], out)
            return self.to_out[1](out)
        return self.to_out(out)


class Attention(nn.Module):
    """Full softmax attention over the flattened grid (scale dim_head^-0.5,
    softmax in float32). The whole block is one call of ``attn_block``.

    ``use_pallas`` routes as the JAX module does: in bfloat16 with ``fused``
    (and n <= 2048, n % 8 == 0, hidden % 128 == 0) the whole-block kernel
    keeps the block; otherwise the block is RMSNorm -> to_qkv -> ``attention``
    on the (b, heads, n, d) views of the projection -> to_out."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32, device=None, use_pallas: bool = False,
                 fused: bool = True, quant: str | None = None):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.use_pallas, self.fused = use_pallas, fused
        self.norm = RMSNorm(dim, dtype, device)
        self.to_qkv = Conv2d(dim, heads * dim_head * 3, 1, bias=False,
                             dtype=dtype, device=device)
        self.to_out = Conv2d(heads * dim_head, dim, 1, dtype=dtype,
                             device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        n, hidden = h * w, self.heads * self.dim_head
        fused_ok = (self.fused and self.dtype == torch.bfloat16 and n <= 2048
                    and n % 8 == 0 and hidden % 128 == 0)
        if self.use_pallas and not fused_ok:
            return self._unfused(x)
        out = attn_block(
            _as_rows(x.to(self.dtype)), self.norm.g.reshape(c),
            self.to_qkv.weight[:, :, 0, 0].t(),
            self.to_out.weight[:, :, 0, 0].t(), self.to_out.bias,
            heads=self.heads, dim_head=self.dim_head)
        return _from_rows(out, h, w)

    def _unfused(self, x):
        b, _, h, w = x.shape
        n = h * w
        qkv = _as_rows(self.to_qkv(self.norm(x))).reshape(
            b, n, 3, self.heads, self.dim_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = attention(q, k, v)                        # (b, heads, n, d)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(_from_rows(out.to(self.dtype), h, w))


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------

class PixelShuffleUpsample(nn.Module):
    """conv1x1 (dim -> 4*dim_out) -> SiLU -> pixel shuffle(2) (key ``net.0``).

    ``init_weights`` draws the reference's checkerboard-free init: one
    kaiming-uniform (dim_out, dim) kernel repeated for the 4 sub-pixels of
    each output channel."""

    def __init__(self, dim: int, dim_out: int, dtype=torch.float32,
                 device=None, quant: str | None = None):
        super().__init__()
        self.net = nn.Sequential(
            _conv(dim, dim_out * 4, 1, dtype=dtype, device=device,
                  quant=quant),
            nn.SiLU(), nn.PixelShuffle(2))

    def init_weights(self, gen: torch.Generator):
        conv = self.net[0]
        o, i = conv.weight.shape[:2]
        bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / i)
        base = (torch.rand((o // 4, i, 1, 1), generator=gen) * 2 - 1) * bound
        with torch.no_grad():
            conv.weight.copy_(base.repeat_interleave(4, dim=0))
            conv.bias.zero_()

    def forward(self, x):
        return self.net(x)


class NearestUpsample(nn.Sequential):
    """nearest x2 -> conv3x3 (key ``1``)."""

    def __init__(self, dim: int, dim_out: int, dtype=torch.float32,
                 device=None, quant: str | None = None):
        super().__init__(nn.Upsample(scale_factor=2, mode='nearest'),
                         _conv(dim, dim_out, 3, padding=1, dtype=dtype,
                               device=device, quant=quant))


class Downsample(nn.Sequential):
    """space-to-depth(2) -> conv1x1 (key ``1``)."""

    def __init__(self, dim: int, dim_out: int, dtype=torch.float32,
                 device=None, quant: str | None = None):
        super().__init__(nn.PixelUnshuffle(2),
                         _conv(dim * 4, dim_out, 1, dtype=dtype,
                               device=device, quant=quant))
