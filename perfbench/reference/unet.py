"""The plain reference of the Real-SRGD denoiser U-Net: float32 PyTorch ops.

Written from the published architecture (yahoojapan/srgd, after lucidrains'
denoising-diffusion U-Net) and kept apart from the program under test: it
imports nothing of it. Weights are a flat dict name -> tensor, with the
published checkpoint's names (``param_shapes``), so the benchmark hands the
same dict to both sides.

    x = init_conv7x7(cat(x, cond));  r = x
    t = time_mlp(log-SNR) [+ class_mlp(label) * class_mask]
    per encoder stage: h1 = Res(x, t); h2 = Res(h1, t); h2 = Attn(h2) + h2;
                       x = Down(h2)                  (skips h1, h2 kept)
    mid: Res, full Attn + residual, Res
    per decoder stage: Res(cat(x, skip)), Res(cat(x, skip)), Attn + residual,
                       Up
    out = final_conv1x1(Res(cat(x, r), t))

    Res(x, t):  Block(x, FiLM(t)) -> Block -> + res_conv1x1(x) (or x)
    Block:      conv3x3 -> GroupNorm(8) -> x * (scale + 1) + shift -> SiLU
    LinAttn:    RMSNorm -> q, k, v (4 heads x 32) -> softmax_d(q) * 32^-0.5,
                softmax_n(k), ctx = k^T v, out = q ctx -> conv1x1 -> RMSNorm
    Attn:       RMSNorm -> q, k, v -> softmax(q k^T / sqrt(32)) v -> conv1x1
    Down:       pixel_unshuffle(2) -> conv1x1; the last stage conv3x3
    Up:         conv1x1 -> SiLU -> pixel_shuffle(2); the last stage conv3x3
    RMSNorm:    x / max(||x||_2 over channels, 1e-12) * g * sqrt(C)

``Precision`` rounds the operands of every convolution and product: float32
(the reference), or the controls of a lower precision (fp8, int4). W8A8
(``quant_min_channels``): the convolutions the configuration quantizes take
per-output-channel int8 weights (amax / 127) and per-tensor int8
activations (amax over the whole batch / 127, round half to even, clamped to
+-127), worked out here from the float weights.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

HEADS, DIM_HEAD, GROUPS = 4, 32, 8


def stage_dims(cfg):
    dim = cfg['unet_dim']
    mults = [int(m) for m in str(cfg['ddpm_unet_dim_mults']).split(',')]
    dims = [dim] + [dim * m for m in mults]
    full = [s.strip() == 'True' for s in
            cfg.get('full_attn', 'False,False,False,True').split(',')]
    return dim, list(zip(dims[:-1], dims[1:])), full


def param_shapes(cfg) -> OrderedDict:
    """name -> (shape, init): init 'fan_in' (U(+-1/sqrt(fan_in))), 'one',
    'zero', 'normal' (N(0, 1)) or 'shuffle' (a pixel-shuffle conv: one
    kaiming-uniform kernel repeated for the four sub-pixels)."""
    dim, in_out, full = stage_dims(cfg)
    time_dim, hidden = dim * 4, HEADS * DIM_HEAD
    fourier = cfg['learned_sinusoidal_dim'] + 1
    p = OrderedDict()

    def conv(name, cout, cin, k, bias=True, init='fan_in'):
        p[f'{name}.weight'] = ((cout, cin, k, k), init)
        if bias:
            p[f'{name}.bias'] = ((cout,), 'fan_in' if init == 'fan_in'
                                 else 'zero')

    def linear(name, cout, cin):
        p[f'{name}.weight'] = ((cout, cin), 'fan_in')
        p[f'{name}.bias'] = ((cout,), 'fan_in')

    def res(name, d_in, d_out):
        linear(f'{name}.mlp.1', d_out * 2, time_dim)
        for blk, ci in (('block1', d_in), ('block2', d_out)):
            conv(f'{name}.{blk}.proj', d_out, ci, 3)
            p[f'{name}.{blk}.norm.weight'] = ((d_out,), 'one')
            p[f'{name}.{blk}.norm.bias'] = ((d_out,), 'zero')
        if d_in != d_out:
            conv(f'{name}.res_conv', d_out, d_in, 1)

    def attn(name, d, is_full):
        p[f'{name}.norm.g'] = ((1, d, 1, 1), 'one')
        conv(f'{name}.to_qkv', hidden * 3, d, 1, bias=False)
        if is_full:
            conv(f'{name}.to_out', d, hidden, 1)
        else:
            conv(f'{name}.to_out.0', d, hidden, 1)
            p[f'{name}.to_out.1.g'] = ((1, d, 1, 1), 'one')

    conv('init_conv', dim, cfg['channels'] * 2, 7)
    p['time_mlp.0.weights'] = ((cfg['learned_sinusoidal_dim'] // 2,),
                               'normal')
    linear('time_mlp.1', time_dim, fourier)
    linear('time_mlp.3', time_dim, time_dim)
    p['class_mlp.0.weight'] = ((cfg['num_classes'], dim), 'normal')
    linear('class_mlp.1', time_dim, dim)
    linear('class_mlp.3', time_dim, time_dim)
    n = len(in_out)
    for i, (d_in, d_out) in enumerate(in_out):
        res(f'downs.{i}.0', d_in, d_in)
        res(f'downs.{i}.1', d_in, d_in)
        attn(f'downs.{i}.2', d_in, full[i])
        if i < n - 1:
            conv(f'downs.{i}.3.1', d_out, d_in * 4, 1)
        else:
            conv(f'downs.{i}.3', d_out, d_in, 3)
    mid = in_out[-1][1]
    res('mid_block1', mid, mid)
    attn('mid_attn', mid, True)
    res('mid_block2', mid, mid)
    for i, ((d_in, d_out), is_full) in enumerate(
            zip(reversed(in_out), reversed(full))):
        res(f'ups.{i}.0', d_out + d_in, d_out)
        res(f'ups.{i}.1', d_out + d_in, d_out)
        attn(f'ups.{i}.2', d_out, is_full)
        if i < n - 1:
            conv(f'ups.{i}.3.net.0', d_in * 4, d_out, 1, init='shuffle')
        else:
            conv(f'ups.{i}.3', d_in, d_out, 3)
    res('final_res_block', dim * 2, dim)
    conv('final_conv', cfg['channels'], dim, 1)
    return p


def quant_sites(cfg) -> set:
    """Names of the convolutions W8A8 quantizes: those of every ResnetBlock
    at least ``quant_min_channels`` wide (by min(d_in, d_out)), every linear
    attention and resampler at that width (a downsampler by its input, an
    upsampler by its output); never init_conv, final_conv or a full
    attention block."""
    thr = cfg.get('quant_min_channels')
    if thr is None:
        return set()
    dim, in_out, full = stage_dims(cfg)
    n = len(in_out)
    sites = set()

    def res(name, d_in, d_out):
        if min(d_in, d_out) >= thr:
            sites.update({f'{name}.block1.proj', f'{name}.block2.proj'})
            if d_in != d_out:
                sites.add(f'{name}.res_conv')

    for i, (d_in, d_out) in enumerate(in_out):
        res(f'downs.{i}.0', d_in, d_in)
        res(f'downs.{i}.1', d_in, d_in)
        if not full[i] and d_in >= thr:
            sites.update({f'downs.{i}.2.to_qkv', f'downs.{i}.2.to_out.0'})
        if d_in >= thr:
            sites.add(f'downs.{i}.3.1' if i < n - 1 else f'downs.{i}.3')
    mid = in_out[-1][1]
    res('mid_block1', mid, mid)
    res('mid_block2', mid, mid)
    for i, ((d_in, d_out), is_full) in enumerate(
            zip(reversed(in_out), reversed(full))):
        res(f'ups.{i}.0', d_out + d_in, d_out)
        res(f'ups.{i}.1', d_out + d_in, d_out)
        if not is_full and d_out >= thr:
            sites.update({f'ups.{i}.2.to_qkv', f'ups.{i}.2.to_out.0'})
        if d_out >= thr:
            sites.add(f'ups.{i}.3.net.0' if i < n - 1 else f'ups.{i}.3')
    return sites


def _fp8(t, dtype):
    """``t`` scaled per tensor to ``dtype``'s largest value and rounded to
    it, in float32."""
    top = torch.finfo(dtype).max
    s = torch.amax(torch.abs(t)).clamp_min(1e-30) / top
    return (t / s).to(dtype).float() * s


class _Fp8Operand(torch.autograd.Function):
    """An fp8 training operand: e4m3 forward, its gradient rounded to e5m2
    on the way back (the usual fp8 training recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """Rounding of the operands of convolutions and products.

    ``float32``: none (the reference). ``fp8``: each operand is scaled per
    tensor to e4m3's largest value and rounded to e4m3, the usual fp8
    recipe; products accumulate in float32; under autograd the operand's
    gradient is rounded to e5m2. ``quant_levels``: the integer levels of the
    quantized convolutions, 127 (int8) or 7 (int4)."""

    def __init__(self, kind: str = 'float32', quant_levels: int = 127):
        if kind not in ('float32', 'fp8'):
            raise ValueError(f'unknown precision {kind!r}')
        self.kind, self.quant_levels = kind, quant_levels

    def __call__(self, t):
        if self.kind == 'float32':
            return t
        if t.requires_grad:
            return _Fp8Operand.apply(t)
        return _fp8(t, torch.float8_e4m3fn)


class RefUNet:
    """The reference denoiser: ``forward(x, log_snr, cond, label,
    class_mask)`` on float32 NCHW tensors, returning the noise estimate."""

    def __init__(self, cfg, params: dict, precision: Precision | None = None):
        self.cfg = cfg
        self.p = {k: v.float() for k, v in params.items()}
        self.prec = precision or Precision()
        self.sites = quant_sites(cfg)
        self._wq = {}

    # -- operands ---------------------------------------------------------
    def conv(self, name, x, padding=0):
        w, b = self.p[f'{name}.weight'], self.p.get(f'{name}.bias')
        if name in self.sites:
            return self.qconv(name, x, w, b, padding)
        return F.conv2d(self.prec(x), self.prec(w), b, padding=padding)

    def qconv(self, name, x, w, b, padding):
        lv = float(self.prec.quant_levels)
        if name not in self._wq:
            s_w = torch.amax(torch.abs(w), dim=(1, 2, 3)) / lv + 1e-12
            self._wq[name] = (torch.round(w / s_w[:, None, None, None]), s_w)
        wq, s_w = self._wq[name]
        s_x = torch.amax(torch.abs(x)) / lv + 1e-12
        xq = torch.clamp(torch.round(x / s_x), -lv, lv)
        y = F.conv2d(xq, wq, padding=padding) * (s_x * s_w)[None, :, None,
                                                              None]
        return y if b is None else y + b[None, :, None, None]

    def linear(self, name, x):
        return F.linear(self.prec(x), self.prec(self.p[f'{name}.weight']),
                        self.p[f'{name}.bias'])

    def mm(self, a, b):
        return self.prec(a) @ self.prec(b)

    # -- blocks -------------------------------------------------------------
    @staticmethod
    def rms(x, g):
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        return x / torch.clamp_min(norm, 1e-12) * g * math.sqrt(x.shape[1])

    def block(self, name, x, scale_shift=None):
        x = self.conv(f'{name}.proj', x, padding=1)
        x = F.group_norm(x, GROUPS, self.p[f'{name}.norm.weight'],
                         self.p[f'{name}.norm.bias'], eps=1e-5)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)

    def res(self, name, x, t):
        ss = self.linear(f'{name}.mlp.1', F.silu(t))[:, :, None, None]
        h = self.block(f'{name}.block1', x, ss.chunk(2, dim=1))
        h = self.block(f'{name}.block2', h)
        skip = (self.conv(f'{name}.res_conv', x)
                if f'{name}.res_conv.weight' in self.p else x)
        return h + skip

    def heads(self, t):
        b, c, h, w = t.shape                    # (b, heads*d, h, w)
        return t.reshape(b, HEADS, DIM_HEAD, h * w)

    def linattn(self, name, x):
        b, c, h, w = x.shape
        y = self.rms(x, self.p[f'{name}.norm.g'])
        q, k, v = map(self.heads,
                      self.conv(f'{name}.to_qkv', y).chunk(3, dim=1))
        q = torch.softmax(q, dim=2) * DIM_HEAD ** -0.5
        k = torch.softmax(k, dim=3)
        ctx = self.mm(k, v.transpose(2, 3))     # (b, heads, d, e)
        out = self.mm(ctx.transpose(2, 3), q)   # (b, heads, e, n)
        out = self.conv(f'{name}.to_out.0', out.reshape(b, -1, h, w))
        return self.rms(out, self.p[f'{name}.to_out.1.g'])

    def attn(self, name, x):
        b, c, h, w = x.shape
        y = self.rms(x, self.p[f'{name}.norm.g'])
        q, k, v = map(self.heads,
                      self.conv(f'{name}.to_qkv', y).chunk(3, dim=1))
        sim = self.mm(q.transpose(2, 3), k) * DIM_HEAD ** -0.5   # (n, n)
        out = self.mm(torch.softmax(sim, dim=-1), v.transpose(2, 3))
        out = out.transpose(2, 3).reshape(b, -1, h, w)
        return self.conv(f'{name}.to_out', out)

    def attention(self, name, x):
        if f'{name}.to_out.weight' in self.p:
            return self.attn(name, x)
        return self.linattn(name, x)

    def time_embed(self, log_snr, label, class_mask):
        x = log_snr.float()[:, None]
        freqs = x * self.p['time_mlp.0.weights'][None, :] * (2 * math.pi)
        t = torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)
        t = self.linear('time_mlp.3',
                        F.gelu(self.linear('time_mlp.1', t)))
        if label is not None:
            c = self.p['class_mlp.0.weight'][label]
            c = self.linear('class_mlp.3',
                            F.gelu(self.linear('class_mlp.1', c)))
            if class_mask is not None:
                c = c * class_mask[:, None]
            t = t + c
        return t

    # -- forward ------------------------------------------------------------
    def forward(self, x, log_snr, cond, label=None, class_mask=None):
        _, in_out, _ = stage_dims(self.cfg)
        n = len(in_out)
        t = self.time_embed(log_snr, label, class_mask)
        x = self.conv('init_conv', torch.cat([x, cond], dim=1), padding=3)
        r, hs = x, []
        for i in range(n):
            x = self.res(f'downs.{i}.0', x, t)
            hs.append(x)
            x = self.res(f'downs.{i}.1', x, t)
            x = self.attention(f'downs.{i}.2', x) + x
            hs.append(x)
            if i < n - 1:
                x = self.conv(f'downs.{i}.3.1', F.pixel_unshuffle(x, 2))
            else:
                x = self.conv(f'downs.{i}.3', x, padding=1)
        x = self.res('mid_block1', x, t)
        x = self.attention('mid_attn', x) + x
        x = self.res('mid_block2', x, t)
        for i in range(n):
            x = self.res(f'ups.{i}.0', torch.cat([x, hs.pop()], dim=1), t)
            x = self.res(f'ups.{i}.1', torch.cat([x, hs.pop()], dim=1), t)
            x = self.attention(f'ups.{i}.2', x) + x
            if i < n - 1:
                x = F.pixel_shuffle(F.silu(self.conv(f'ups.{i}.3.net.0', x)),
                                    2)
            else:
                x = self.conv(f'ups.{i}.3', x, padding=1)
        x = self.res('final_res_block', torch.cat([x, r], dim=1), t)
        return self.conv('final_conv', x)

    __call__ = forward
