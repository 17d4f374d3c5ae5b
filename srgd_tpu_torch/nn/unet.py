"""The SR denoiser U-Net (PyTorch, NCHW in ``channels_last`` memory).

Counterpart of ``srgd_tpu/nn/unet.py`` (``SRUnet``, ``build_unet_from_config``).
Module names are the reference's torch Sequential indices (``downs.{i}.{j}``,
``ups.{i}.{j}``, ``mid_block1``, ...), so a reference state dict loads with
``load_state_dict(strict=True)``.

The classifier-free-guidance nulls are the JAX package's: the LR-condition
null is an all-zeros condition image (``cond=None``) and the class null is a
per-sample ``class_mask`` that zeroes the class-embedding addition, so both
nulls fit in one doubled-batch forward.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from srgd_tpu_torch.nn.layers import (
    Attention, ClassMLP, Conv2d, Downsample, LearnedSinusoidalPosEmb,
    LinearAttention, NearestUpsample, PixelShuffleUpsample, ResnetBlock,
    RMSNorm, TimeMLP,
)
from srgd_tpu_torch.nn.quant import conv

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class SRUnet(nn.Module):
    """4-stage conv + attention U-Net denoiser with LR-image channel-concat
    conditioning and optional degradation-class conditioning.

    Input channels = 2 * channels (noisy image concat condition image); H and
    W must be divisible by 2 ** (len(dim_mults) - 1). ``dtype`` is the
    compute dtype; parameters are float32. Build on ``device='meta'`` to
    count parameters without allocating them.

    The kernel flags carry the JAX net's names. ``use_pallas``: every
    ``Block`` norms through ``groupnorm_silu`` and every ``LinearAttention``
    runs ``linear_attention_qkv``. ``use_pallas_attention``: the full
    attention blocks run ``attention`` wherever the whole-block kernel does
    not keep them, which ``fused_linattn=False`` makes everywhere. With all
    three at their defaults the attention blocks are ``linattn_block`` and
    ``attn_block``.

    ``remat``: while gradients are recorded, every ``ResnetBlock`` and
    attention block runs under ``torch.utils.checkpoint`` and recomputes its
    activations in the backward instead of keeping them, as the JAX net
    wraps those modules in ``nn.remat``. Parameter names do not change.

    ``quant`` ('w8a8[:alpha[:cal_mode]]', ``_quant_spec``) quantizes the
    convs of every block, resampler and linear attention at least
    ``quant_min_channels`` wide (int8 inference, ``nn.quant``), at the JAX
    net's widths: a ResnetBlock at min(d_in, d_out), a stage's
    downsampler at d_in, its upsampler at d_out; ``init_conv`` and
    ``final_conv`` stay float. The per-time calibration stats' net times
    are the buffer ``quant_stats_times`` (non-persistent, None until
    calibrated)."""

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 3, resnet_block_groups: int = 8,
                 learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False,
                 learned_sinusoidal_dim: int = 16, attn_dim_head: int = 32,
                 attn_heads: int = 4,
                 full_attn: Sequence[bool] = (False, False, False, True),
                 pixel_shuffle_upsample: bool = True,
                 num_classes: int | None = None, dtype=torch.float32,
                 device=None, use_pallas: bool = False,
                 use_pallas_attention: bool = False,
                 fused_linattn: bool = True, remat: bool = False,
                 quant: str | None = None, quant_min_channels: int = 0):
        super().__init__()
        self.remat = remat
        self.quant, self.quant_min_channels = quant, quant_min_channels
        self.register_buffer('quant_stats_times', None, persistent=False)
        self.dim, self.dim_mults, self.channels = dim, tuple(dim_mults), channels
        self.num_classes, self.dtype = num_classes, dtype
        self.downsample_factor = 2 ** (len(dim_mults) - 1)
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_stages = len(in_out)
        time_dim = dim * 4
        kw = dict(dtype=dtype, device=device)

        q = self._quant

        def block(d_in, d_out):
            return ResnetBlock(d_in, d_out, time_emb_dim=time_dim,
                               groups=resnet_block_groups,
                               use_pallas=use_pallas,
                               quant=q(min(d_in, d_out)), **kw)

        def attn(d, is_full):
            if is_full:
                return Attention(d, heads=attn_heads, dim_head=attn_dim_head,
                                 use_pallas=use_pallas_attention,
                                 fused=fused_linattn, quant=q(d), **kw)
            return LinearAttention(d, heads=attn_heads, dim_head=attn_dim_head,
                                   use_pallas=use_pallas, quant=q(d), **kw)

        self.init_conv = Conv2d(channels * 2, dim, 7, padding=3, **kw)
        self.time_mlp = TimeMLP(dim, time_dim, learned_sinusoidal_cond,
                                learned_sinusoidal_dim, device=device)
        self.class_mlp = (ClassMLP(num_classes, dim, time_dim, device=device)
                          if num_classes is not None else None)

        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == n_stages - 1
            self.downs.append(nn.ModuleList([
                block(d_in, d_in), block(d_in, d_in), attn(d_in, full_attn[i]),
                Downsample(d_in, d_out, quant=q(d_in), **kw) if not last
                else conv(d_in, d_out, 3, padding=1, quant=q(d_in), **kw)]))

        mid = dims[-1]
        self.mid_block1 = block(mid, mid)
        self.mid_attn = attn(mid, True)
        self.mid_block2 = block(mid, mid)

        self.ups = nn.ModuleList()
        rev = list(zip(reversed(in_out), reversed(list(full_attn))))
        for i, ((d_in, d_out), is_full) in enumerate(rev):
            last = i == n_stages - 1
            up = PixelShuffleUpsample if pixel_shuffle_upsample else NearestUpsample
            self.ups.append(nn.ModuleList([
                block(d_out + d_in, d_out), block(d_out + d_in, d_out),
                attn(d_out, is_full),
                up(d_out, d_in, quant=q(d_out), **kw) if not last
                else conv(d_out, d_in, 3, padding=1, quant=q(d_out), **kw)]))

        self.final_res_block = block(dim * 2, dim)
        out_dim = channels * (2 if learned_variance else 1)
        self.final_conv = Conv2d(dim, out_dim, 1, **kw)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """Random weights from ``gen``, a CPU generator: drawn on the CPU in
        module order and copied to the net's device. Convolutions and linears
        U(+-1/sqrt(fan_in)) (torch's default bound), norm gains one and norm
        biases zero, embeddings N(0, 1), and the pixel-shuffle upsamplers'
        repeated-kaiming init."""
        def draw(p, fn):
            p.copy_(fn(p.shape))

        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    if p is not None:
                        draw(p, lambda s: (torch.rand(s, generator=gen) * 2 - 1)
                             * bound)
            elif isinstance(m, (nn.GroupNorm, RMSNorm)):
                for name, p in m.named_parameters():
                    draw(p, torch.zeros if name == 'bias' else torch.ones)
            elif isinstance(m, (nn.Embedding, LearnedSinusoidalPosEmb)):
                for p in m.parameters():
                    draw(p, lambda s: torch.randn(s, generator=gen))
        # after the loop, which visits a module before its children and so
        # would overwrite the upsamplers' convs with the generic draw
        for m in self.modules():
            if isinstance(m, PixelShuffleUpsample):
                m.init_weights(gen)

    def forward(self, x, time, cond=None, class_label=None, class_mask=None,
                deep_cache=None, cache_depth: int = 0,
                return_cache: bool = False):
        """x: (B, C, H, W) noisy image in [-1, 1]; time: (B,) float; cond:
        (B, C, H, W) LR condition or None (zeros: the CFG null); class_label:
        (B,) int or None; class_mask: (B,) float gating the class-embedding
        addition per sample (None: all ones). Returns float32 (B, C, H, W).

        DeepCache (arXiv 2312.09608) splits the net at stage
        ``cache_depth = d``, 1 <= d < len(dim_mults). A full forward with
        ``return_cache=True`` also returns the decoder feature that enters
        stage d, (B, dim * dim_mults[d - 1], H / 2^(d-1), W / 2^(d-1)) in the
        net's compute dtype. A cached forward (``deep_cache=<that feature>``)
        skips encoder stages >= d, stage d-1's downsample, the mid block and
        decoder stages >= d. Fed the cache of the same (x, time), it returns
        the full forward's bits: the stages it runs see the same inputs."""
        f = self.downsample_factor
        if x.shape[2] % f or x.shape[3] % f:
            raise ValueError(f'input spatial dims {tuple(x.shape[2:])} must be '
                             f'divisible by {f}')
        n_stages = len(self.downs)
        if deep_cache is not None or return_cache:
            if not 1 <= cache_depth < n_stages:
                raise ValueError(f'cache_depth must be in [1, {n_stages - 1}], '
                                 f'got {cache_depth}')
        if deep_cache is not None and return_cache:
            raise ValueError('a cached forward cannot also produce a fresh '
                             'cache')
        skip_deep = deep_cache is not None
        if cond is None:
            cond = torch.zeros_like(x)
        x = torch.cat([x, cond.to(x.dtype)], dim=1).to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.init_conv(x)
        r = x

        t = self.time_mlp(time)
        if self.class_mlp is not None and class_label is not None:
            c = self.class_mlp(class_label)
            if class_mask is not None:
                c = c * class_mask[:, None].to(c.dtype)
            t = t + c

        hs = []
        for i, (block1, block2, attn, down) in enumerate(self.downs):
            if skip_deep and i >= cache_depth:
                break
            x = self._run(block1, x, t)
            hs.append(x)
            x = self._run(block2, x, t)
            x = self._run(attn, x) + x
            hs.append(x)
            if skip_deep and i == cache_depth - 1:
                break    # this downsample only feeds the skipped deep half
            x = down(x)

        if skip_deep:
            x = deep_cache.to(self.dtype).contiguous(
                memory_format=torch.channels_last)
        else:
            x = self._run(self.mid_block1, x, t)
            x = self._run(self.mid_attn, x) + x
            x = self._run(self.mid_block2, x, t)

        cache = None
        for i, (block1, block2, attn, up) in enumerate(self.ups):
            stage = n_stages - 1 - i
            if skip_deep and stage >= cache_depth:
                continue
            x = self._run(block1, torch.cat([x, hs.pop()], dim=1), t)
            x = self._run(block2, torch.cat([x, hs.pop()], dim=1), t)
            x = self._run(attn, x) + x
            x = up(x)
            if return_cache and stage == cache_depth:
                # a cached forward enters here from a channels-last cache; a
                # pixel shuffle may return another layout, which would change
                # the concatenation's layout and so the convolution's
                # algorithm
                x = cache = x.contiguous(memory_format=torch.channels_last)

        x = self._run(self.final_res_block, torch.cat([x, r], dim=1), t)
        out = self.final_conv(x).float()
        return (out, cache) if return_cache else out

    def _quant(self, width: int) -> str | None:
        return self.quant if width >= self.quant_min_channels else None

    def _run(self, module, *args):
        """``module(*args)``, under ``checkpoint`` with ``remat`` while
        gradients are recorded."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)


def _quant_spec(conf) -> str | None:
    """Config -> the conv quant spec 'w8a8[:<alpha>[:<cal_mode>]]', or None.
    Rejects an unknown ``quantize`` (calibration is a runtime step on top of
    'w8a8', not a config value), a smoothing alpha outside [0, 1], and a
    percentile calibration combined with smoothing."""
    if conf.quantize == 'none':
        return None
    if conf.quantize != 'w8a8':
        raise ValueError(f"unknown quantize {conf.quantize!r}: expected "
                         "'none' or 'w8a8'")
    alpha = getattr(conf, 'quantize_smooth_alpha', 0.0)
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f'quantize_smooth_alpha must be in [0, 1], '
                         f'got {alpha}')
    cal_mode = getattr(conf, 'quantize_cal_mode', 'max')
    if cal_mode != 'max':
        if alpha > 0.0:
            raise ValueError('quantize_cal_mode != max cannot be combined '
                             'with quantize_smooth_alpha > 0 (the static-'
                             'scale mechanisms compound)')
        return f'w8a8:0:{cal_mode}'
    if alpha > 0.0:
        return f'w8a8:{alpha:g}'
    return conf.quantize


def build_unet_from_config(conf, dtype=None, device=None) -> SRUnet:
    """``Config`` -> ``SRUnet``, as the JAX factory builds it; ``quantize:
    w8a8`` quantizes the convs at least ``quantize_min_channels`` wide."""
    dim_mults = tuple(int(e) for e in conf.ddpm_unet_dim_mults.split(','))
    full_attn = tuple(e.strip() == 'True' for e in conf.full_attn.split(','))
    if dtype is None:
        dtype = _DTYPES[conf.compute_dtype]
    return SRUnet(
        dim=conf.unet_dim, dim_mults=dim_mults, full_attn=full_attn,
        learned_variance=conf.learned_variance,
        learned_sinusoidal_cond=conf.learned_sinusoidal_cond,
        learned_sinusoidal_dim=conf.learned_sinusoidal_dim,
        pixel_shuffle_upsample=conf.pixel_shuffle_upsample,
        num_classes=conf.num_classes if 'conditional' in conf.model else None,
        dtype=dtype, device=device, use_pallas=conf.use_pallas_kernels,
        use_pallas_attention=conf.flash_attn,
        fused_linattn=conf.fused_linattn, remat=conf.remat_unet,
        quant=_quant_spec(conf), quant_min_channels=conf.quantize_min_channels)
