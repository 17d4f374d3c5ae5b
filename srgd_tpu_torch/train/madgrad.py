"""MADGRAD as a ``torch.optim.Optimizer``.

Counterpart of ``srgd_tpu/train/madgrad.py`` (an optax transform), with its
update order: the published algorithm (Defazio & Jelassi, "Adaptivity
without Compromise", 2021), per step k counted from 0 before the increment:

    lamb_k = lr_k * sqrt(k + 1)
    decoupled decay:  p <- p * (1 - lr_k * wd)   (AdamW-style, pre-step)
    coupled decay:    g <- g + wd * p            (classic L2)
    nu  <- nu + lamb_k * g^2
    s   <- s  + lamb_k * g
    z   =  x0 - s / (cbrt(nu) + eps)
    p   <- momentum * p + (1 - momentum) * z

The learning rate enters the accumulators, so the group's ``lr`` must be
set to the schedule's value before each step (the trainer does);
x0 is the initial parameter snapshot. All statistics are float32, and the
step is applied as the optax update ``p + (p_new - p)``.
"""

from __future__ import annotations

import numpy as np
import torch

from srgd_tpu_torch.train.trainer import Transform


def cbrt(x):
    """Real cube root, taken in float64 and rounded back to x's dtype."""
    return (torch.sign(x) * x.abs().double().pow(1.0 / 3.0)).to(x.dtype)


class Madgrad(Transform):
    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, decoupled_decay: bool = True,
                 eps: float = 1e-6, plateau=None):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      decoupled_decay=decoupled_decay,
                                      eps=eps), plateau)

    def update(self, p, g, state, group):
        if not state:
            state['count'] = 0
            state['s'] = torch.zeros_like(p, dtype=torch.float32)
            state['nu'] = torch.zeros_like(p, dtype=torch.float32)
            state['x0'] = p.detach().float().clone()
        k = state['count']
        lr_k = np.float32(group['lr'])
        lamb = float(lr_k * np.sqrt(np.float32(k) + np.float32(1.0)))
        momentum, wd = group['momentum'], group['weight_decay']
        g = g.float()
        pf = p.float()
        if wd:
            if group['decoupled_decay']:
                pf = pf * float(np.float32(1.0) - lr_k * np.float32(wd))
            else:
                g = g + wd * pf
        state['nu'] = state['nu'] + lamb * g * g
        state['s'] = state['s'] + lamb * g
        z = state['x0'] - state['s'] / (cbrt(state['nu']) + group['eps'])
        p_new = momentum * pf + (1.0 - momentum) * z
        state['count'] = k + 1
        return (p_new - p.float()).to(p.dtype)
