"""Discrete-time Gaussian diffusion (the DDPM/DDIM family): the ancestral and
DDIM samplers, untiled and alternating-grid tiled (DDIM), with the three
objectives and DeepCache.

Counterpart of ``srgd_tpu/diffusion/gaussian.py``. The
tables come from float64 beta schedules cast to float32
(``schedules.make_discrete_schedule``); every scalar is a float32 numpy
value, as in the JAX step.

- ``model_predictions``: the net's output read as noise (``pred_noise``),
  the clean image (``pred_x0``) or v (``pred_v``), turned into (eps, x0);
  DDIM clamps x0 to [-1, 1] and re-derives eps from it.
- ancestral (``p_sample_loop``, all T steps): the posterior mean of the
  clamped x0 plus exp(0.5 log var) * noise, none at t = 0; no final clamp.
- DDIM (``ddim_sample`` and the tiled sampler): over ``ddim_time_pairs``,
  x0 sqrt(ac_next) + sqrt(1 - ac_next) eps, the reference's update at
  eta = 0, the only value its factory builds; the terminal pair (t, -1)
  returns x0. It draws no step noise.
- tiled: after every odd step but the terminal one, the margin is re-noised
  to sqrt(1 - ac[t_next]) * noise.

Noise, from a source like ``base.GeneratorNoise``: untiled, ``init(shape)``
once and, for each ancestral step but the last (t = 0), ``step(i, shape)``
(i is the step's index); tiled, ``init(canvas)``, then after each odd step
that re-noises the margin ``margin(i, canvas)``. A test replays the JAX keys: untiled, the init
key of ``split(rng)`` and ``fold_in(rng', i)``; tiled, the two halves of
``split(fold_in(rng', i))``.
"""

from __future__ import annotations

import numpy as np
import torch

from srgd_tpu_torch.diffusion import schedules
from srgd_tpu_torch.diffusion.base import (
    GeneratorNoise, drop_conditions, elementwise_loss, guidance_scale,
    guided_denoise, make_deep_cache, nhwc_net_apply,
    normalize_to_neg_one_to_one, pad_tiles_to_multiple, per_sample_mean,
    prepare_tile_context, resolve_guidance_mode, unnormalize_to_zero_to_one,
)
from srgd_tpu_torch.tiling import (
    extract_tiles, make_geometry, reflect_pad, scatter_tiles,
)

OBJECTIVES = ('pred_noise', 'pred_x0', 'pred_v')
_f32 = np.float32


def ddim_time_pairs(total_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """[(T-1, t'), ..., (t, -1)]: linspace(-1, T-1, steps+1) reversed,
    truncated to ints, in consecutive pairs; (steps, 2) int32."""
    times = np.linspace(-1, total_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(np.int64).tolist()))
    return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int32)


class GaussianDiffusion:
    """DDPM/DDIM wrapper of a denoiser net whose time input is the integer
    timestep. ``sampling_timesteps`` < ``timesteps`` samples with DDIM, else
    ancestrally over all T steps. DeepCache as in ``continuous.py``. The
    training keywords (offset noise, min-SNR weighting, condition dropout,
    loss type) are read by ``loss``."""

    def __init__(self, net, *, image_size: int, channels: int = 3,
                 timesteps: int = 1000, sampling_timesteps: int | None = None,
                 objective: str = 'pred_noise', beta_schedule: str = 'linear',
                 deep_cache_interval: int = 0,
                 deep_cache_depth: int = 2, deep_cache_schedule: str = '',
                 offset_noise_strength: float = 0.0,
                 min_snr_loss_weight: bool = False, min_snr_gamma: float = 5.0,
                 cond_drop_prob: float = 0.0,
                 class_cond_drop_prob: float = 0.0, loss_type: str = 'l2'):
        if objective not in OBJECTIVES:
            raise ValueError('objective must be either pred_noise (predict '
                             'noise) or pred_x0 (predict image start) or '
                             'pred_v (predict v)')
        if sampling_timesteps is None:
            sampling_timesteps = timesteps
        if sampling_timesteps > timesteps:
            raise ValueError(f'sampling_timesteps {sampling_timesteps} > '
                             f'timesteps {timesteps}')
        self.net = net
        self.image_size = image_size
        self.channels = channels
        self.timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps
        self.is_ddim_sampling = sampling_timesteps < timesteps
        self.objective = objective
        self.beta_schedule = beta_schedule
        self.sched = schedules.make_discrete_schedule(beta_schedule, timesteps)
        self.loss_weight = schedules.discrete_loss_weight(
            beta_schedule, timesteps, objective, min_snr_loss_weight,
            min_snr_gamma)
        self.offset_noise_strength = offset_noise_strength
        self.cond_drop_prob = cond_drop_prob
        self.class_cond_drop_prob = class_cond_drop_prob
        self.loss_type = loss_type
        self.deep_cache_interval = deep_cache_interval
        self.deep_cache_depth = deep_cache_depth
        self.deep_cache_schedule = deep_cache_schedule
        self.net_apply = nhwc_net_apply(net, deep_cache_depth)

    # x0 / eps conversions: float32 table entries times tensors
    def predict_start_from_noise(self, x, t: int, eps):
        s = self.sched
        return (float(s.sqrt_recip_alphas_cumprod[t]) * x
                - float(s.sqrt_recipm1_alphas_cumprod[t]) * eps)

    def predict_noise_from_start(self, x, t: int, x0):
        s = self.sched
        return ((float(s.sqrt_recip_alphas_cumprod[t]) * x - x0)
                / float(s.sqrt_recipm1_alphas_cumprod[t]))

    def predict_start_from_v(self, x, t: int, v):
        s = self.sched
        return (float(s.sqrt_alphas_cumprod[t]) * x
                - float(s.sqrt_one_minus_alphas_cumprod[t]) * v)

    def q_posterior(self, x0, x, t: int):
        """(mean, clipped log variance) of q(x_{t-1} | x_t, x0)."""
        s = self.sched
        mean = (float(s.posterior_mean_coef1[t]) * x0
                + float(s.posterior_mean_coef2[t]) * x)
        return mean, s.posterior_log_variance_clipped[t]

    def q_sample(self, x0, t: int, noise):
        s = self.sched
        return (float(s.sqrt_alphas_cumprod[t]) * x0
                + float(s.sqrt_one_minus_alphas_cumprod[t]) * noise)

    def model_predictions(self, x, t: int, cond, class_label, mode: str,
                          scale: float, clip_x_start: bool = False,
                          rederive_pred_noise: bool = False, deep_cache=None,
                          return_cache: bool = False):
        """(eps, x0) of the guided net at timestep t, and the fresh cache
        last with ``return_cache``."""
        time_b = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                            device=x.device)
        out = guided_denoise(self.net_apply, x, time_b, cond, class_label,
                             mode, scale, deep_cache=deep_cache,
                             return_cache=return_cache)
        cache = ()
        if return_cache:
            out, cache = out[0], out[1:]

        def clip(v):
            return torch.clamp(v, -1.0, 1.0) if clip_x_start else v

        if self.objective == 'pred_noise':
            eps = out
            x0 = clip(self.predict_start_from_noise(x, t, eps))
            if clip_x_start and rederive_pred_noise:
                eps = self.predict_noise_from_start(x, t, x0)
        elif self.objective == 'pred_x0':
            x0 = clip(out)
            eps = self.predict_noise_from_start(x, t, x0)
        else:
            x0 = clip(self.predict_start_from_v(x, t, out))
            eps = self.predict_noise_from_start(x, t, x0)
        return (eps, x0) + cache

    def p_sample_step(self, x, t: int, cond, class_label, noise, mode: str,
                      scale: float, **cache_kw):
        """One ancestral step from timestep t: (x_prev,)[ + (cache,)]."""
        eps, x0, *cache = self.model_predictions(x, t, cond, class_label,
                                                 mode, scale, **cache_kw)
        x0 = torch.clamp(x0, -1.0, 1.0)
        mean, log_var = self.q_posterior(x0, x, t)
        if t > 0:
            mean = mean + float(np.exp(_f32(0.5) * log_var)) * noise
        return (mean, *cache)

    def ddim_step(self, x, time: int, time_next: int, cond, class_label,
                  mode: str, scale: float, **cache_kw):
        """One DDIM step (eta = 0) from ``time`` to ``time_next`` (-1 on the
        terminal pair, which returns x0): (x_next,)[ + (cache,)]."""
        eps, x0, *cache = self.model_predictions(
            x, time, cond, class_label, mode, scale, clip_x_start=True,
            rederive_pred_noise=True, **cache_kw)
        if time_next < 0:
            return (x0, *cache)
        alpha_next = self.sched.alphas_cumprod[time_next]
        c = np.sqrt(np.maximum(_f32(1.0) - alpha_next, _f32(0.0)))
        return (float(np.sqrt(alpha_next)) * x0 + float(c) * eps, *cache)

    @torch.inference_mode()
    def p_sample_loop(self, cond, class_label, *, cond_scale=1.0,
                      guidance_start_steps=0, class_cond_scale=1.0,
                      class_guidance_start_steps=0, generation_start_steps=0,
                      noise=None):
        """Ancestral sampling over all T steps; cond in [-1, 1]."""
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        T, gss = self.timesteps, generation_start_steps
        noise = noise or GeneratorNoise(0, cond.device)
        init = noise.init(cond.shape)
        img = self.q_sample(cond, T - gss, init) if gss > 0 else init
        dc = make_deep_cache(self, T - gss, mode, shape=cond.shape)
        for i in range(gss, T):
            t = T - 1 - i
            nz = noise.step(i, img.shape) if t > 0 else None
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            img, = dc.step(lambda **kw: self.p_sample_step(
                img, t, cond, class_label, nz, mode, scale, **kw), i - gss)
        return unnormalize_to_zero_to_one(img)

    @torch.inference_mode()
    def ddim_sample(self, cond, class_label, *, cond_scale=1.0,
                    guidance_start_steps=0, class_cond_scale=1.0,
                    class_guidance_start_steps=0, generation_start_steps=0,
                    sampling_timesteps=None, noise=None):
        """DDIM over ``ddim_time_pairs``; cond in [-1, 1]."""
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        n_steps = sampling_timesteps or self.sampling_timesteps
        pairs = ddim_time_pairs(self.timesteps, n_steps)
        gss = generation_start_steps
        noise = noise or GeneratorNoise(0, cond.device)
        init = noise.init(cond.shape)
        img = (self.q_sample(cond, int(pairs[gss][0]), init) if gss > 0
               else init)
        dc = make_deep_cache(self, n_steps - gss, mode, shape=cond.shape)
        for i in range(gss, n_steps):
            time, time_next = int(pairs[i][0]), int(pairs[i][1])
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            img, = dc.step(lambda **kw: self.ddim_step(
                img, time, time_next, cond, class_label, mode, scale, **kw),
                i - gss)
        return unnormalize_to_zero_to_one(img)

    def sample(self, condition_x, class_label=None, *, cond_scale=1.0,
               guidance_start_steps=0, class_cond_scale=1.0,
               class_guidance_start_steps=0, generation_start_steps=0,
               num_sample_steps=None, noise=None):
        """Untiled sampling, condition_x (B, H, W, C) in [0, 1]: DDIM when
        ``sampling_timesteps`` < ``timesteps`` (``num_sample_steps`` DDIM
        steps), else ancestral over all T steps (``num_sample_steps`` is not
        read), as the reference dispatches. No final clamp."""
        cond = normalize_to_neg_one_to_one(condition_x)
        kw = dict(cond_scale=cond_scale,
                  guidance_start_steps=guidance_start_steps,
                  class_cond_scale=class_cond_scale,
                  class_guidance_start_steps=class_guidance_start_steps,
                  generation_start_steps=generation_start_steps, noise=noise)
        if self.is_ddim_sampling:
            return self.ddim_sample(cond, class_label,
                                    sampling_timesteps=num_sample_steps, **kw)
        return self.p_sample_loop(cond, class_label, **kw)

    @torch.inference_mode()
    def tiled_sample(self, condition_x, class_label=None, *,
                     batch_size: int = 4, tile_size: int = 256,
                     tile_stride: int | None = None, cond_scale=1.0,
                     guidance_start_steps=0, class_cond_scale=1.0,
                     class_guidance_start_steps=0, generation_start_steps=0,
                     num_sample_steps=None, noise=None):
        """Alternating-grid tiled DDIM over ``ddim_time_pairs(T, n)``.
        condition_x: (B, H, W, C) in [0, 1] at the target resolution;
        returns (B, H, W, C) in [0, 1]."""
        n_steps = num_sample_steps or self.sampling_timesteps
        b, h, w, _ = condition_x.shape
        geom = make_geometry(h, w, tile_size, tile_stride)
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        pairs = ddim_time_pairs(self.timesteps, n_steps)
        noise = noise or GeneratorNoise(0, condition_x.device)
        gss = generation_start_steps

        cond_padded = reflect_pad(normalize_to_neg_one_to_one(condition_x),
                                  geom.pad)
        canvas = tuple(cond_padded.shape)
        init = noise.init(canvas)
        img = (self.q_sample(cond_padded, int(pairs[gss][0]), init) if gss > 0
               else init)
        cond_tiles, label_tiles, n_chunks, chunks, interior_mask = \
            prepare_tile_context(cond_padded, geom, b, batch_size, class_label)
        dc = make_deep_cache(self, n_steps - gss, mode, cond_tiles=cond_tiles)

        def tiled(canvas_t, p):
            return pad_tiles_to_multiple(extract_tiles(canvas_t, geom, p),
                                         chunks[p])

        for i in range(gss, n_steps):
            p = i % 2
            time, time_next = int(pairs[i][0]), int(pairs[i][1])
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            tiles, n_orig = tiled(img, p)
            outs = []
            for k in range(n_chunks[p]):
                sl = slice(k * chunks[p], (k + 1) * chunks[p])
                nx, = dc.step(
                    lambda **kw: self.ddim_step(
                        tiles[sl], time, time_next, cond_tiles[p][sl],
                        None if label_tiles[p] is None else label_tiles[p][sl],
                        mode, scale, **kw),
                    (i - gss) // 2, p, sl)
                outs.append(nx)
            img = scatter_tiles(img, torch.cat(outs)[:n_orig], geom, p)

            if p == 1 and interior_mask is not None and time_next >= 0:
                # margin := q_sample(zeros, t_next); the terminal step keeps
                # the margin as it is
                coeff = float(self.sched.sqrt_one_minus_alphas_cumprod[time_next])
                fresh = noise.margin(i, canvas) * coeff
                img = img * interior_mask + fresh * (1.0 - interior_mask)

        left, top, right, bottom = geom.crop
        out = img[:, top:bottom, left:right, :]
        return unnormalize_to_zero_to_one(torch.clamp(out, -1.0, 1.0))

    # ------------------------------------------------------------------
    # Training loss: ``GaussianDiffusion.loss`` of the JAX package.
    # ------------------------------------------------------------------
    def loss(self, img, condition_x, class_label=None, *, draws, noise=None,
             t=None):
        """Scalar training loss. img / condition_x: (B, H, W, C) in [0, 1].
        ``draws``: timesteps ``t`` (B,) uniform over [0, T), ``noise``,
        ``offset`` (B, 1, 1, C) when ``offset_noise_strength`` > 0, and the
        whole-batch dropout uniforms. The target is the objective's (noise,
        x0 or v), each sample weighted by the schedule's loss weight."""
        b = img.shape[0]
        dev = img.device
        if t is None:
            t = draws.randint('t', (b,), self.timesteps)
        x_start = normalize_to_neg_one_to_one(img)
        if noise is None:
            noise = draws.normal('noise', img.shape)
        if self.offset_noise_strength > 0.0:
            offset = draws.normal('offset', (b, 1, 1, img.shape[-1]))
            noise = noise + self.offset_noise_strength * offset
        cond, class_mask = drop_conditions(
            draws, normalize_to_neg_one_to_one(condition_x), class_label,
            self.cond_drop_prob, self.class_cond_drop_prob)

        def table(values):
            return torch.from_numpy(values).to(dev)[t].reshape(
                (b,) + (1,) * (img.dim() - 1))

        sa = table(self.sched.sqrt_alphas_cumprod)
        s1a = table(self.sched.sqrt_one_minus_alphas_cumprod)
        x = sa * x_start + s1a * noise
        out = self.net_apply(x, t.float(), cond, class_label, class_mask)
        if self.objective == 'pred_noise':
            target = noise
        elif self.objective == 'pred_x0':
            target = x_start
        else:
            target = sa * noise - s1a * x_start
        losses = per_sample_mean(elementwise_loss(out, target, self.loss_type))
        losses = losses * torch.from_numpy(self.loss_weight).to(dev)[t]
        return torch.mean(losses)
