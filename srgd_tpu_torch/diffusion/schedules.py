"""Noise schedules of the three diffusion families.

Counterpart of ``srgd_tpu/diffusion/schedules.py``, copied because that
module imports ``jax.numpy``:

- the discrete beta schedules and their DDPM/DDIM tables
  (``make_discrete_schedule``) and the training loss weights
  (``discrete_loss_weight``), built in float64 numpy and cast to float32;
- the continuous-time log-SNR tables (``make_log_snr_table``): the sampling
  times are a static linspace, so the values are computed once on the host in
  float64 and cast to float32; the training loss draws its times, so it
  takes the float32 tensor functions of ``LOG_SNR_SCHEDULES``;
- the learned monotonic log-SNR net (``LearnedLogSNR``), an ``nn.Module``
  whose parameter names are the reference checkpoint's ``log_snr.*`` keys;
- the EDM (Karras) sigma schedule and preconditioners (``EDMParams``), whose
  scalars are float32 numpy values, as the JAX sampler's traced scalars are;
  the training loss takes them per sample on tensors (``*_t`` methods).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Discrete beta schedules (DDPM family): float64 tables, float32 outputs
# ---------------------------------------------------------------------------

def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps: int, start: float = -3, end: float = 3,
                          tau: float = 1, clamp_min: float = 1e-5) -> np.ndarray:
    def _sigmoid(x):
        return 1 / (1 + np.exp(-x))

    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start = _sigmoid(start / tau)
    v_end = _sigmoid(end / tau)
    alphas_cumprod = ((-_sigmoid((t * (end - start) + start) / tau) + v_end)
                      / (v_end - v_start))
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


BETA_SCHEDULES = {
    'linear': linear_beta_schedule,
    'cosine': cosine_beta_schedule,
    'sigmoid': sigmoid_beta_schedule,
}


@dataclass(frozen=True)
class DiscreteSchedule:
    """The DDPM/DDIM tables the samplers read, float32 numpy arrays of
    shape (T,)."""

    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    num_timesteps: int


def make_discrete_schedule(beta_schedule: str,
                           timesteps: int) -> DiscreteSchedule:
    """The tables of ``beta_schedule`` over ``timesteps`` steps. Some entries
    are inf or nan at the boundary indices (alphas_cumprod of exactly 1 after
    the cosine schedule's clipping), as in the reference's float64 buffers;
    the samplers never read them."""
    if beta_schedule not in BETA_SCHEDULES:
        raise ValueError(f'unknown beta schedule {beta_schedule}')
    betas = BETA_SCHEDULES[beta_schedule](timesteps)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    with np.errstate(divide='ignore', invalid='ignore', over='ignore'):
        posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                              / (1.0 - alphas_cumprod))

        def f32(a):
            return np.asarray(a, dtype=np.float32)

        return DiscreteSchedule(
            alphas_cumprod=f32(alphas_cumprod),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev)
                                     / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev)
                                     * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
            num_timesteps=int(timesteps),
        )


def discrete_loss_weight(beta_schedule: str, timesteps: int, objective: str,
                         min_snr_loss_weight: bool = False,
                         min_snr_gamma: float = 5.0) -> np.ndarray:
    """The per-timestep training loss weight of ``objective`` (the JAX
    ``DiscreteSchedule.loss_weight``), float32 (T,): snr (clipped to
    ``min_snr_gamma`` from above with ``min_snr_loss_weight``) over snr,
    itself or snr + 1. Entry 0 may be nan for a schedule whose
    alphas_cumprod reaches 1, as in the reference."""
    if beta_schedule not in BETA_SCHEDULES:
        raise ValueError(f'unknown beta schedule {beta_schedule}')
    alphas_cumprod = np.cumprod(1.0 - BETA_SCHEDULES[beta_schedule](timesteps))
    with np.errstate(divide='ignore', invalid='ignore', over='ignore'):
        snr = alphas_cumprod / (1 - alphas_cumprod)
        clipped = (np.minimum(snr, min_snr_gamma) if min_snr_loss_weight
                   else snr)
        if objective == 'pred_noise':
            weight = clipped / snr
        elif objective == 'pred_x0':
            weight = clipped
        elif objective == 'pred_v':
            weight = clipped / (snr + 1)
        else:
            raise ValueError(f'unknown objective {objective}')
    return np.asarray(weight, dtype=np.float32)


# ---------------------------------------------------------------------------
# Continuous-time log-SNR tables (VDM family)
# ---------------------------------------------------------------------------

def make_log_snr_table(noise_schedule: str, times: np.ndarray) -> np.ndarray:
    """log-SNR of a fixed schedule at fixed sampling times, float64 on the
    host, float32 out. The learned schedule is ``LearnedLogSNR.table``."""
    t = np.asarray(times, dtype=np.float64)
    if noise_schedule == 'linear':
        vals = -np.log(np.maximum(np.expm1(1e-4 + 10 * t ** 2), 1e-20))
    elif noise_schedule == 'cosine':
        s = 0.008
        vals = -np.log(np.maximum(
            np.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2 - 1, 1e-5))
    else:
        raise ValueError(f'unknown noise schedule {noise_schedule}')
    return vals.astype(np.float32)


def beta_linear_log_snr(t):
    """-log(expm1(1e-4 + 10 t^2)) on a float32 tensor."""
    return -torch.log(torch.clamp_min(torch.expm1(1e-4 + 10 * (t ** 2)),
                                      1e-20))


def alpha_cosine_log_snr(t, s: float = 0.008):
    return -torch.log(torch.clamp_min(
        torch.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2 - 1, 1e-5))


LOG_SNR_SCHEDULES = {
    'linear': beta_linear_log_snr,
    'cosine': alpha_cosine_log_snr,
}

# beta-linear log-SNR at t = 0 and t = 1: the learned schedule's endpoints
LOG_SNR_MAX = float(-np.log(np.expm1(1e-4)))
LOG_SNR_MIN = float(-np.log(np.expm1(1e-4 + 10.0)))


class MonotonicLinear(nn.Module):
    """A linear layer through |W| and |b| (key ``net``): monotonically
    increasing in every input."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.net = nn.Linear(d_in, d_out, device=device)

    def forward(self, x):
        return F.linear(x, self.net.weight.abs().float(),
                        self.net.bias.abs().float())


class _Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class _LastAxis(nn.Module):
    def forward(self, x):
        return x[..., None]


class LearnedLogSNR(nn.Module):
    """The learned monotonic log-SNR schedule (VDM appendix H), float32:
    t -> mono(1, 1) -> residual(mono(1, h) -> sigmoid -> mono(h, 1)),
    normalised so that t = 0 and t = 1 give the beta-linear endpoints.

    Parameters ``net.1.net.*``, ``net.2.fn.0.net.*`` and ``net.2.fn.2.net.*``
    are the reference's ``log_snr.net...`` entries without the prefix. The
    training loss's gradient mix (``frac_gradient``) is applied by
    ``ContinuousDiffusion.log_snr_of``."""

    def __init__(self, hidden_dim: int = 1024, device=None):
        super().__init__()
        self.net = nn.Sequential(
            _LastAxis(), MonotonicLinear(1, 1, device=device),
            _Residual(nn.Sequential(
                MonotonicLinear(1, hidden_dim, device=device), nn.Sigmoid(),
                MonotonicLinear(hidden_dim, 1, device=device))))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """U(+-1/sqrt(fan_in)) for every weight and bias (torch's default
        bound), drawn on the CPU from ``gen`` in module order."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                            * bound)

    def forward(self, t):
        t = t.float()
        f = lambda v: self.net(v)[..., 0]  # noqa: E731
        out0, out1 = f(torch.zeros_like(t)), f(torch.ones_like(t))
        return ((LOG_SNR_MIN - LOG_SNR_MAX) * ((f(t) - out0) / (out1 - out0))
                + LOG_SNR_MAX)

    @torch.no_grad()
    def table(self, num_steps: int) -> np.ndarray:
        """log-SNR at linspace(1, 0, N + 1), float32 numpy."""
        dev = self.net[1].net.weight.device
        t = torch.from_numpy(np.linspace(1.0, 0.0, num_steps + 1)
                             .astype(np.float32)).to(dev)
        return self(t).cpu().numpy()


# ---------------------------------------------------------------------------
# EDM (Karras) schedule and preconditioners
# ---------------------------------------------------------------------------

def _f32(v):
    return np.float32(v)


@dataclass(frozen=True)
class EDMParams:
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 80.0
    S_tmin: float = 0.05
    S_tmax: float = 50.0
    S_noise: float = 1.003

    # the preconditioners take and return float32 numpy scalars, in the
    # JAX expressions' order (python constants are float64, then float32)
    def c_skip(self, sigma):
        return _f32(self.sigma_data ** 2) / (sigma * sigma
                                             + _f32(self.sigma_data ** 2))

    def c_out(self, sigma):
        return (sigma * _f32(self.sigma_data)
                / np.sqrt(sigma * sigma + _f32(self.sigma_data ** 2)))

    def c_in(self, sigma):
        return _f32(1.0) / np.sqrt(sigma * sigma + _f32(self.sigma_data ** 2))

    def c_noise(self, sigma):
        return _f32(0.25) * np.log(sigma)

    # the same on float32 tensors of per-sample sigmas, in the JAX training
    # loss's expressions
    def c_skip_t(self, sigma):
        return self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)

    def c_out_t(self, sigma):
        return (sigma * self.sigma_data
                / torch.sqrt(sigma ** 2 + self.sigma_data ** 2))

    def c_in_t(self, sigma):
        return 1.0 / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def c_noise_t(self, sigma):
        return 0.25 * torch.log(sigma)

    def loss_weight_t(self, sigma):
        return ((sigma ** 2 + self.sigma_data ** 2)
                / (sigma * self.sigma_data) ** 2)

    def sample_schedule(self, num_sample_steps: int) -> np.ndarray:
        """Karras rho schedule: N sigmas from sigma_max down to sigma_min and
        a trailing 0, (N + 1,) float32."""
        n = num_sample_steps
        inv_rho = 1.0 / self.rho
        steps = np.arange(n, dtype=np.float32)
        sigmas = (self.sigma_max ** inv_rho
                  + steps / (n - 1) * (self.sigma_min ** inv_rho
                                       - self.sigma_max ** inv_rho)) ** self.rho
        return np.concatenate([sigmas, [0.0]]).astype(np.float32)

    def gammas(self, sigmas: np.ndarray, num_sample_steps: int) -> np.ndarray:
        """Per-step churn factors: min(S_churn / N, sqrt(2) - 1) where
        S_tmin <= sigma <= S_tmax, else 0."""
        g = min(self.S_churn / num_sample_steps, math.sqrt(2) - 1)
        return np.where((sigmas >= self.S_tmin) & (sigmas <= self.S_tmax), g,
                        0.0).astype(np.float32)
