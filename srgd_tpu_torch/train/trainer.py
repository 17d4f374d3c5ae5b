"""Training loop pieces: optimizers, LR schedules, train state, the step.

Counterpart of ``srgd_tpu/train/trainer.py``, where each optimizer is an
optax chain. Here each is a ``torch.optim.Optimizer`` (``Transform``) that
computes the same update in the chain's order, in float32:

- adamw:  u = mu_hat / (sqrt(nu_hat) + eps) [amsgrad: over the running max
  of the bias-corrected nu_hat, ``optax.scale_by_amsgrad``], u += wd * p,
  u *= -lr;
- adam:   the same without the decay term (``optax.adam``/``amsgrad``);
- sgd:    trace t = g + momentum * t, u = t (nesterov: g + momentum * t),
  u *= -lr;
- madgrad (``train/madgrad.py``);
- ReduceLROnPlateau (``optax.contrib.reduce_on_plateau``): u *= scale, the
  scale updated from the step's training loss first;
- p += u.

The learning rate is a plain function of the step count with optax's
formulas in float32 (``make_lr_schedule``, ``_maybe_epoch_quantize``); the
train step writes it into every group's ``lr`` before the optimizer steps.
``torch.optim.lr_scheduler`` is not used: its stepping and warmup differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from srgd_tpu_torch.diffusion.base import GeneratorDraws
from srgd_tpu_torch.train.ema import ema_update

SCHEDULERS = ('cosine', 'CosineAnnealingLR', 'WarmupLinear',
              'ReduceLROnPlateau', 'constant')

_f32 = np.float32


# ---------------------------------------------------------------------------
# Schedules: optax's formulas, float32
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int):
    """``optax.linear_schedule``."""
    if steps <= 0:
        return lambda count: _f32(init)

    def sched(count):
        frac = _f32(1) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return _f32(init - end) * frac + _f32(end)
    return sched


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError('The cosine_decay_schedule requires positive '
                         f'decay_steps, got decay_steps={decay_steps}.')

    def sched(count):
        c = _f32(min(count, decay_steps))
        decay = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c
                                              / _f32(decay_steps)))
        return _f32(init) * (_f32(1 - alpha) * decay + _f32(alpha))
    return sched


def _join(schedules, boundaries):
    """``optax.join_schedules``."""
    def sched(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out
    return sched


def make_lr_schedule(conf, steps_per_epoch: int):
    """The reference's scheduler surface (config.py:152): timm-style cosine
    with linear warmup, torch CosineAnnealingLR (no warmup), WarmupLinear,
    ReduceLROnPlateau (the reduction is the optimizer's; here the constant
    base lr), plus 'constant'. Returns step -> float32 lr."""
    warmup = conf.warmup_epochs * steps_per_epoch
    total = conf.epochs * steps_per_epoch
    if conf.scheduler == 'cosine':
        w, d = max(warmup, 1), max(total, 2)
        peak = conf.lr
        alpha = 0.0 if peak == 0.0 else conf.min_lr / peak
        return _join([_linear(conf.warmup_lr_init, peak, w),
                      _cosine(peak, d - w, alpha)], [w])
    if conf.scheduler == 'CosineAnnealingLR':
        return _cosine(conf.lr, max(total, 2), conf.min_lr / conf.lr)
    if conf.scheduler == 'WarmupLinear':
        return _join([_linear(conf.warmup_lr_init, conf.lr, max(warmup, 1)),
                      _linear(conf.lr, conf.min_lr, max(total - warmup, 1))],
                     [max(warmup, 1)])
    if conf.scheduler in ('ReduceLROnPlateau', 'constant'):
        return lambda count: _f32(conf.lr)
    raise ValueError(f'unknown scheduler {conf.scheduler!r}; '
                     f'supported: {SCHEDULERS}')


def _maybe_epoch_quantize(sched, conf, steps_per_epoch: int):
    """cosine_interval_type: 'epoch' updates the LR once per epoch
    (config.py:153); 'step' (default) updates every step."""
    if conf.cosine_interval_type == 'step':
        return sched
    if conf.cosine_interval_type == 'epoch':
        spe = max(steps_per_epoch, 1)
        return lambda count: sched((count // spe) * spe)
    raise ValueError(
        f'unknown cosine_interval_type {conf.cosine_interval_type!r}')


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau`` with the JAX package's settings
    (``factor``, ``patience``, ``atol``; rtol 1e-4, no cooldown, one value
    a step): after ``patience`` steps whose loss did not beat the best by
    the tolerances, the scale on the updates is multiplied by ``factor``.
    The state is tensors on the parameters' device, so a step needs no
    host sync."""

    RTOL = 1e-4   # optax's default, which the JAX package keeps

    def __init__(self, factor: float, patience: int, atol: float):
        if not 0.0 < factor < 1.0:
            raise ValueError(f'Factor must be in the range (0, 1), got '
                             f'factor = {factor}.')
        self.factor, self.patience, self.atol = factor, patience, atol
        self.best_value = torch.tensor(float('inf'))
        self.plateau_count = torch.tensor(0, dtype=torch.int32)
        self.scale = torch.tensor(1.0)

    def update(self, value):
        """The scale for this step's updates, after counting ``value``."""
        dev = value.device
        best, plateau = self.best_value.to(dev), self.plateau_count.to(dev)
        avg = value.float()
        improved = avg < (1 - self.RTOL) * best - self.atol
        best = torch.where(improved, avg, best)
        count = torch.where(improved, torch.zeros_like(plateau), plateau + 1)
        hit = count == self.patience
        self.plateau_count = torch.where(hit, torch.zeros_like(count), count)
        self.scale = torch.clamp_min(torch.where(
            hit, self.scale.to(dev) * self.factor, self.scale.to(dev)), 0.0)
        self.best_value = best
        return self.scale

    def state_dict(self) -> dict:
        return {'best_value': self.best_value, 'scale': self.scale,
                'plateau_count': self.plateau_count}

    def load_state_dict(self, state: dict) -> None:
        self.best_value = state['best_value']
        self.scale = state['scale']
        self.plateau_count = state['plateau_count']


class Transform(torch.optim.Optimizer):
    """One optax chain as a torch optimizer. A subclass's ``update(p, g,
    state, group)`` returns the chain's update for p before the plateau
    scale; ``step(value)`` scales it by the plateau's scale (when there is
    one, keyed on ``value``, the training loss) and adds it to p.
    ``state_dict`` carries the plateau's state beside the per-parameter
    state."""

    def __init__(self, params, defaults: dict, plateau=None):
        super().__init__(params, defaults)
        self.plateau = plateau

    @torch.no_grad()
    def step(self, closure=None, *, value=None):
        if closure is not None:
            raise ValueError('the port\'s optimizers take no closure')
        scale = None
        if self.plateau is not None:
            if value is None:
                raise ValueError('ReduceLROnPlateau needs the step\'s loss '
                                 'as value')
            scale = self.plateau.update(value)
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                u = self.update(p, p.grad, self.state[p], group)
                if scale is not None:
                    u = scale.to(u.dtype) * u
                p.add_(u)

    def update(self, p, g, state, group):
        raise NotImplementedError

    def state_dict(self):
        sd = super().state_dict()
        if self.plateau is not None:
            sd['plateau'] = self.plateau.state_dict()
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        plateau = state_dict.pop('plateau', None)
        super().load_state_dict(state_dict)
        if self.plateau is not None:
            self.plateau.load_state_dict(plateau)


class Adam(Transform):
    """``optax.adam``/``adamw`` (``weight_decay`` not None) and, with
    ``amsgrad``, ``optax.amsgrad`` or the adamw chain around
    ``scale_by_amsgrad``: the max is taken over the bias-corrected second
    moment, then divided into, unlike torch's ``amsgrad=True``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float | None = None, amsgrad: bool = False,
                 plateau=None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      amsgrad=amsgrad), plateau)

    def update(self, p, g, state, group):
        b1, b2 = group['b1'], group['b2']
        if not state:
            state['count'] = 0
            state['mu'] = torch.zeros_like(p)
            state['nu'] = torch.zeros_like(p)
            if group['amsgrad']:
                state['nu_max'] = torch.zeros_like(p)
        mu = state['mu'] = (1 - b1) * g + b1 * state['mu']
        nu = state['nu'] = (1 - b2) * (g ** 2) + b2 * state['nu']
        count = state['count'] = state['count'] + 1
        mu_hat = mu / float(_f32(1) - _f32(b1) ** _f32(count))
        nu_hat = nu / float(_f32(1) - _f32(b2) ** _f32(count))
        if group['amsgrad']:
            nu_hat = state['nu_max'] = torch.maximum(state['nu_max'], nu_hat)
        u = mu_hat / (torch.sqrt(nu_hat) + group['eps'])
        if group['weight_decay'] is not None:
            u = u + group['weight_decay'] * p
        return float(-_f32(group['lr'])) * u


class SGD(Transform):
    """``optax.sgd`` with momentum (``optax.trace``), optionally Nesterov."""

    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.9,
                 nesterov: bool = False, plateau=None):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov), plateau)

    def update(self, p, g, state, group):
        m = group['momentum']
        if not state:
            state['trace'] = torch.zeros_like(p)
        t = state['trace'] = g + m * state['trace']
        u = g + m * t if group['nesterov'] else t
        return float(-_f32(group['lr'])) * u


def make_optimizer(conf, params, steps_per_epoch: int = 1000):
    """The optimizer ``conf.optimizer`` names over ``params`` (a dict of
    tensors or an iterable), with ``conf.scheduler``'s schedule as its
    ``schedule`` attribute (step -> lr) and, for ReduceLROnPlateau, its
    ``plateau``."""
    sched = _maybe_epoch_quantize(make_lr_schedule(conf, steps_per_epoch),
                                  conf, steps_per_epoch)
    plateau = None
    if conf.scheduler == 'ReduceLROnPlateau':
        if conf.plateau_mode != 'min':
            # the train step feeds value=loss (lower is better); 'max' would
            # need a metric plumbed in instead — reject rather than ignore
            raise ValueError(
                f"plateau_mode {conf.plateau_mode!r} unsupported: the plateau "
                "scheduler keys off the training loss ('min')")
        plateau = ReduceOnPlateau(conf.factor, conf.patience, conf.plateau_eps)
    params = list(params.values() if isinstance(params, dict) else params)
    lr = float(sched(0))
    if conf.optimizer == 'adamw':
        opt = Adam(params, lr, weight_decay=conf.weight_decay,
                   amsgrad=conf.amsgrad, plateau=plateau)
    elif conf.optimizer == 'adam':
        opt = Adam(params, lr, amsgrad=conf.amsgrad, plateau=plateau)
    elif conf.optimizer == 'sgd':
        opt = SGD(params, lr, momentum=conf.momentum, nesterov=conf.nesterov,
                  plateau=plateau)
    elif conf.optimizer == 'madgrad':
        from srgd_tpu_torch.train.madgrad import Madgrad
        opt = Madgrad(params, lr, momentum=conf.momentum,
                      weight_decay=conf.weight_decay,
                      decoupled_decay=conf.madgrad_decoupled_decay,
                      plateau=plateau)
    else:
        raise ValueError(f'unknown optimizer {conf.optimizer}')
    opt.schedule = sched
    return opt


def set_lr(optimizer, step: int) -> None:
    """Every group's ``lr`` := the optimizer's schedule at ``step``."""
    lr = float(optimizer.schedule(step))
    for group in optimizer.param_groups:
        group['lr'] = lr


# ---------------------------------------------------------------------------
# Train state and step
# ---------------------------------------------------------------------------

def trainable_params(wrapper) -> dict:
    """The parameters a train step updates, by state-dict name: the net's,
    and a learned log-SNR schedule's under ``log_snr.``."""
    params = dict(wrapper.net.named_parameters())
    if getattr(wrapper, 'log_snr', None) is not None:
        params.update({f'log_snr.{k}': v
                       for k, v in wrapper.log_snr.named_parameters()})
    return params


@dataclass
class TrainState:
    """``params``: the live parameters (the modules' own tensors) by name;
    ``ema_params``: float32 copies; ``step``: steps taken. The training
    loop also leaves the losses of the steps it ran and its ``PhaseTimer``
    here. A mesh run returns whole CPU copies and ``optimizer`` None."""
    params: dict
    optimizer: Transform | None
    ema_params: dict
    step: int = 0
    losses: list = field(default_factory=list)
    timer: Any = None

    @property
    def opt_state(self) -> dict:
        return self.optimizer.state_dict()


def create_train_state(params: dict, optimizer) -> TrainState:
    return TrainState(params=params, optimizer=optimizer,
                      ema_params={k: v.detach().float().clone()
                                  for k, v in params.items()})


def step_draws(seed: int, step: int, device) -> GeneratorDraws:
    """The draws of train step ``step``: a generator keyed by (seed, step),
    the counterpart of ``fold_in(PRNGKey(seed), step)``, so a resumed run
    draws what an uninterrupted one does."""
    return GeneratorDraws((seed << 32) + step, device)


def make_train_step(wrapper, ema_decay: float, conditional: bool, seed: int,
                    mesh_params=None):
    """Returns ``step(state, hr, lr_cond, label=None) -> loss``: uint8
    batches normalised on the device, the step's draws keyed by the step,
    loss, backward, the optimizer step (value = loss for the plateau), then
    the EMA; ``state`` is updated in place and the loss comes back as a
    device tensor.

    With ``mesh_params`` (``train.sharded.MeshParams``) the batch is this
    rank's rows of the global batch: the draws are made at the global shape
    and cut to those rows, the gradients and the loss are averaged over the
    mesh before the optimizer steps on the masters, and the updated shards
    are gathered back into the modules; the loss returned is the global
    one."""

    def step(state: TrainState, hr, lr_cond, label=None):
        if hr.dtype == torch.uint8:
            hr = hr.float() / 255.0
        if lr_cond.dtype == torch.uint8:
            lr_cond = lr_cond.float() / 255.0
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        draws = step_draws(seed, state.step, hr.device)
        if mesh_params is not None:
            from srgd_tpu_torch.train.sharded import RowDraws, local_rows
            b = hr.shape[0] * mesh_params.mesh.data_size
            draws = RowDraws(draws, b, local_rows(b, mesh_params.mesh))
            for p in mesh_params.live.values():
                p.grad = None
        loss = wrapper.loss(hr, lr_cond, label if conditional else None,
                            draws=draws)
        loss.backward()
        loss = loss.detach()
        if mesh_params is not None:
            loss = mesh_params.reduce(loss)
        set_lr(opt, state.step)
        opt.step(value=loss)
        if mesh_params is not None:
            mesh_params.gather()
        ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        return loss

    return step
