"""Seeded weights for both sides: one dict name -> float32 tensor, made on
the device by one generator in two large draws (a uniform and a normal
buffer), then cut and scaled per tensor. The distributions are the
published net's initialisation: convolutions and linears U(+-1/sqrt(fan
in)), norm gains one and biases zero, embeddings N(0, 1), the pixel-shuffle
convs one kaiming-uniform kernel repeated over the four sub-pixels with a
zero bias."""

from __future__ import annotations

import math

import torch

from perfbench.reference.unet import param_shapes


def make_weights(cfg, seed: int, device) -> dict:
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_uni = sum(math.prod(s) for s, init in shapes.values()
                if init in ('fan_in', 'shuffle'))
    n_norm = sum(math.prod(s) for s, init in shapes.values()
                 if init == 'normal')
    uni = torch.rand(n_uni, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(n_norm, generator=gen, device=device)
    out, iu, ineg = {}, 0, 0
    fan = {}
    for name, (shape, init) in shapes.items():
        numel = math.prod(shape)
        if name.endswith('.weight') and len(shape) >= 2:
            fan[name[:-len('.weight')]] = math.prod(shape[1:])
        if init == 'fan_in':
            base = name.rsplit('.', 1)[0]
            bound = 1 / math.sqrt(fan[base])
            t = uni[iu:iu + numel].reshape(shape) * bound
            iu += numel
        elif init == 'shuffle':
            o, i = shape[:2]
            bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / i)
            k = numel // 4
            t = (uni[iu:iu + k].reshape(o // 4, *shape[1:]) * bound
                 ).repeat_interleave(4, dim=0)
            iu += numel
        elif init == 'normal':
            t = nrm[ineg:ineg + numel].reshape(shape)
            ineg += numel
        elif init == 'one':
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t.contiguous()
    return out
