"""Continuous-time Gaussian diffusion (VDM), the reference's shipped family:
the ancestral, DDIM(eta) and DPM-Solver++(2M) samplers, untiled and
alternating-grid tiled, on a linear, cosine or learned log-SNR schedule, with
or without DeepCache.

Counterpart of ``srgd_tpu/diffusion/continuous.py``. The JAX version compiles
the step loop into one scan; here it is a plain Python loop of eager steps.
Step math (per step i, log-SNR from a float64 host table, or from the
learned schedule's float32 net):

    c        = -expm1(logSNR - logSNR_next)
    alpha^2  = sigmoid(logSNR),  sigma^2 = sigmoid(-logSNR)
    x0       = (x - sigma * eps_hat) / alpha, clamped to [-1, 1]

    ancestral:
    mean     = alpha_next * (x * (1 - c) / alpha + c * x0)
    x_next   = mean + sqrt(sigma_next^2 * c) * noise   (no noise on the last step)

    ddim (eps re-derived from the clamped x0; std = eta * sqrt(sigma_next^2 * c)):
    x_next   = alpha_next * x0 + sqrt(sigma_next^2 - std^2) * eps + std * noise
               (eta = 1 is the ancestral posterior; eta = 0 uses no noise)

    dpmpp (2M, data prediction, lambda = logSNR / 2, h = lambda_next - lambda):
    D        = x0 + (x0 - x0_prev) / (2 r),  r = h_prev / h   (first step: D = x0)
    x_next   = sigma_next / sigma * x - alpha_next * expm1(-h) * D

Noise. Every random draw comes from one noise source with three methods,
each returning a float32 standard-normal tensor of the given shape on the
run's device. The samplers call them in this order:

- ``tiled_sample``: ``init(canvas)`` once, for the starting canvas; then for
  each executed step i in increasing order, ``step(i, canvas)`` (the step's
  noise at canvas resolution, then tiled, so results do not depend on the
  tile batch size) unless i is the last step, and after an odd step, when
  the canvas has a margin, ``margin(i, canvas)`` for the margin re-noise.
- ``sample``: ``init(shape)`` once unless ``init_noise`` is given, then
  ``step(i, shape)`` for each step but the last unless ``step_noises`` is
  given.

``ddim`` with ``eta = 0`` and ``dpmpp`` use no step noise and draw none, so
with ``GeneratorNoise`` their margin draws follow the init draw directly.

``GeneratorNoise`` (the default) draws them in that order from one seeded
``torch.Generator``. A test replays the JAX key schedule by handing in a
source that returns, for ``step(i)`` and ``margin(i)``, the normals of the
two halves of ``split(fold_in(rng, i))`` and, for ``init``, those of the
init key (``srgd_tpu.diffusion.continuous.tiled_sample``).

DeepCache (``deep_cache_interval > 1``): the net's deep half runs only on
the refresh steps of ``base.refresh_mask``, over the executed step counter
(untiled) or the per-parity counter (tiled, one cache stack per grid parity
holding every tile's cache); the steps in between run the shallow half on the
kept cache. ``dpmpp`` refuses it.
"""

from __future__ import annotations

import numpy as np
import torch

from srgd_tpu_torch.diffusion.base import (
    Capture, GeneratorNoise, crop_frames, drop_conditions, elementwise_loss,
    guidance_scale, guided_denoise, make_deep_cache, nhwc_net_apply,
    normalize_to_neg_one_to_one, pad_tiles_to_multiple, per_sample_mean,
    prepare_tile_context, resolve_guidance_mode, run_tile_chunks,
    unnormalize_to_zero_to_one,
)
from srgd_tpu_torch.diffusion.schedules import (
    LOG_SNR_SCHEDULES, make_log_snr_table,
)
from srgd_tpu_torch.tiling import (
    extract_tiles, make_geometry, reflect_pad, scatter_tiles,
)

def _f32(v):
    return np.float32(v)


def _sigmoid(v):
    return _f32(1.0) / (_f32(1.0) + np.exp(-_f32(v)))


SAMPLERS = ('ancestral', 'ddim', 'dpmpp')


class ContinuousDiffusion:
    """Wraps a denoiser net with the continuous-time samplers. ``sampler``:
    'ancestral' (the reference's), 'ddim' (``ddim_eta`` 0 deterministic, 1
    the ancestral posterior variance) or 'dpmpp' (DPM-Solver++(2M)).
    ``noise_schedule`` 'learned' reads the ``LearnedLogSNR`` module passed as
    ``log_snr``. ``deep_cache_interval`` > 1 turns DeepCache on, split at
    U-Net stage ``deep_cache_depth``, refreshing on ``deep_cache_schedule``
    (``base.refresh_mask``). The training keywords (condition dropout, loss
    type, min-SNR weighting, ``frac_gradient``) are read by ``loss``."""

    def __init__(self, net, *, image_size: int, channels: int = 3,
                 noise_schedule: str = 'linear', num_sample_steps: int = 500,
                 clip_sample_denoised: bool = True, sampler: str = 'ancestral',
                 ddim_eta: float = 0.0, deep_cache_interval: int = 0,
                 deep_cache_depth: int = 2, deep_cache_schedule: str = '',
                 log_snr=None, min_snr_loss_weight: bool = False,
                 min_snr_gamma: float = 5.0, cond_drop_prob: float = 0.0,
                 class_cond_drop_prob: float = 0.0, loss_type: str = 'l2',
                 learned_noise_schedule_frac_gradient: float = 1.0):
        if sampler not in SAMPLERS:
            raise ValueError(f'unknown continuous sampler {sampler!r}; '
                             f'supported: {", ".join(map(repr, SAMPLERS))}')
        if sampler == 'dpmpp' and deep_cache_interval > 1:
            raise NotImplementedError(
                'dpmpp + deep_cache is not supported: the multistep solver '
                'threads a previous-x0 state that would interleave with the '
                'deep-feature cache refresh schedule; use ddim/ancestral '
                'with deep_cache, or dpmpp without it')
        if (noise_schedule == 'learned') != (log_snr is not None):
            raise ValueError('the learned noise schedule takes its '
                             'LearnedLogSNR module as log_snr, and only it')
        self.net = net
        self.image_size = image_size
        self.channels = channels
        self.noise_schedule = noise_schedule
        self.num_sample_steps = num_sample_steps
        self.clip_sample_denoised = clip_sample_denoised
        self.sampler = sampler
        self.ddim_eta = ddim_eta
        self.deep_cache_interval = deep_cache_interval
        self.deep_cache_depth = deep_cache_depth
        self.deep_cache_schedule = deep_cache_schedule
        self.log_snr = log_snr
        self.min_snr_loss_weight = min_snr_loss_weight
        self.min_snr_gamma = min_snr_gamma
        self.cond_drop_prob = cond_drop_prob
        self.class_cond_drop_prob = class_cond_drop_prob
        self.loss_type = loss_type
        self.frac_gradient = learned_noise_schedule_frac_gradient
        self.net_apply = nhwc_net_apply(net, deep_cache_depth)

    @property
    def uses_step_noise(self) -> bool:
        return self.sampler == 'ancestral' or (self.sampler == 'ddim'
                                               and bool(self.ddim_eta))

    def log_snr_table(self, num_steps: int) -> np.ndarray:
        """Per-step log-SNR at linspace(1, 0, N+1), float32."""
        if self.log_snr is not None:
            return self.log_snr.table(num_steps)
        return make_log_snr_table(self.noise_schedule,
                                  np.linspace(1.0, 0.0, num_steps + 1))

    def calibration_times(self, n: int = 6) -> np.ndarray:
        """Net time inputs for int8 calibration (``nn.quant``): the log-SNR
        table at max(n - 1, 1) steps, learned schedule included."""
        return self.log_snr_table(max(n - 1, 1))

    def q_sample_log_snr(self, x_start, log_snr, noise):
        alpha = float(np.sqrt(_sigmoid(log_snr)))
        sigma = float(np.sqrt(_sigmoid(-_f32(log_snr))))
        return x_start * alpha + noise * sigma

    def p_sample_tiles(self, x, cond, class_label, noise, log_snr,
                       log_snr_next, mode: str, scale: float, is_last: bool,
                       prev_x0=None, log_snr_prev=None, deep_cache=None,
                       return_cache: bool = False):
        """One reverse step on a batch of tiles (or whole images). Returns
        (x_next, x_start), and the fresh cache last with ``return_cache``.
        Scalars are float32, as in the JAX step. For 'dpmpp' the caller
        threads the multistep state: ``prev_x0`` (the previous step's
        x_start, shaped like x) and ``log_snr_prev``; both None on the first
        executed step, where the update is the one-step DDIM limit."""
        ls, lsn = _f32(log_snr), _f32(log_snr_next)
        c = -np.expm1(ls - lsn)
        alpha = np.sqrt(_sigmoid(ls))
        sigma = np.sqrt(_sigmoid(-ls))
        alpha_next = np.sqrt(_sigmoid(lsn))
        sq_sigma_next = _sigmoid(-lsn)

        time_b = torch.full((x.shape[0],), float(ls), dtype=torch.float32,
                            device=x.device)
        eps = guided_denoise(self.net_apply, x, time_b, cond, class_label,
                             mode, scale, deep_cache=deep_cache,
                             return_cache=return_cache)
        cache = ()
        if return_cache:
            eps, cache = eps[0], eps[1:]
        x_start = (x - float(sigma) * eps) / float(alpha)
        clip = self.clip_sample_denoised
        if clip:
            x_start = torch.clamp(x_start, -1.0, 1.0)

        if self.sampler == 'dpmpp':
            h = _f32(0.5) * (lsn - ls)
            d = x_start
            if prev_x0 is not None:
                r = _f32(0.5) * (ls - _f32(log_snr_prev)) / h
                d = x_start + (x_start - prev_x0) / float(_f32(2.0) * r)
            x_next = (float(np.sqrt(sq_sigma_next) / sigma) * x
                      - float(alpha_next * np.expm1(-h)) * d)
            return (x_next, x_start) + cache

        if self.sampler == 'ddim':
            if clip:    # eps re-derived from the clamped x0
                eps = (x - float(alpha) * x_start) / float(sigma)
            if not self.ddim_eta:
                return (float(alpha_next) * x_start
                        + float(np.sqrt(sq_sigma_next)) * eps,
                        x_start) + cache
            std = _f32(self.ddim_eta) * np.sqrt(np.maximum(sq_sigma_next * c,
                                                           _f32(0.0)))
            x_next = (float(alpha_next) * x_start
                      + float(np.sqrt(np.maximum(sq_sigma_next - std * std,
                                                 _f32(0.0)))) * eps)
            if not is_last:
                x_next = x_next + float(std) * noise
            return (x_next, x_start) + cache

        if clip:
            mean = float(alpha_next) * (x * float(_f32(1.0) - c)
                                        / float(alpha) + float(c) * x_start)
        else:
            mean = float(alpha_next / alpha) * (x - float(c * sigma) * eps)
        if not is_last:
            var = max(float(sq_sigma_next * c), 0.0)
            mean = mean + float(np.sqrt(_f32(var))) * noise
        return (mean, x_start) + cache

    @torch.inference_mode()
    def sample(self, condition_x, class_label=None, *, cond_scale: float = 1.0,
               guidance_start_steps: int = 0, class_cond_scale: float = 1.0,
               class_guidance_start_steps: int = 0,
               generation_start_steps: int = 0,
               num_sample_steps: int | None = None, init_noise=None,
               step_noises=None, noise=None, capture_trajectory: bool = False,
               capture_x0: bool = False):
        """Untiled sampling. condition_x: (B, H, W, C) in [0, 1]; returns
        (B, H, W, C) in [0, 1], with the trajectory and/or x0 frame stacks
        after it when ``capture_trajectory`` / ``capture_x0`` ask for them
        (``base.Capture``: frame 0 the init image, then the image, or the
        clamped x0 estimate, after each executed step). ``init_noise`` (B,
        H, W, C) and ``step_noises`` (N, B, H, W, C) override the noise
        source, as the JAX ``sample`` allows."""
        n_steps = num_sample_steps or self.num_sample_steps
        gss = generation_start_steps
        cond = normalize_to_neg_one_to_one(condition_x)
        table = self.log_snr_table(n_steps)
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        needs_steps = self.uses_step_noise and step_noises is None
        if noise is None and (init_noise is None or needs_steps):
            noise = GeneratorNoise(0, cond.device)

        if init_noise is None:
            init_noise = noise.init(cond.shape)
        img = (self.q_sample_log_snr(cond, table[gss], init_noise)
               if gss > 0 else init_noise)
        dc = make_deep_cache(self, n_steps - gss, mode, shape=cond.shape)
        cap = Capture(capture_trajectory, capture_x0, n_steps - gss, img)
        prev_x0 = None      # dpmpp: the previous step's x_start
        for i in range(gss, n_steps):
            is_last = i == n_steps - 1
            if is_last or not self.uses_step_noise:
                nz = None
            elif step_noises is not None:
                nz = step_noises[i]
            else:
                nz = noise.step(i, img.shape)
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            img, x_start = dc.step(
                lambda **kw: self.p_sample_tiles(
                    img, cond, class_label, nz, table[i], table[i + 1], mode,
                    scale, is_last, prev_x0=prev_x0,
                    log_snr_prev=table[max(i - 1, 0)], **kw), i - gss)
            if self.sampler == 'dpmpp':
                prev_x0 = x_start
            cap.add(img, x_start)
        return cap.result(
            unnormalize_to_zero_to_one(torch.clamp(img, -1.0, 1.0)))

    @torch.inference_mode()
    def tiled_sample(self, condition_x, class_label=None, *,
                     batch_size: int = 4, tile_size: int = 256,
                     tile_stride: int | None = None, cond_scale: float = 1.0,
                     guidance_start_steps: int = 0,
                     class_cond_scale: float = 1.0,
                     class_guidance_start_steps: int = 0,
                     generation_start_steps: int = 0,
                     num_sample_steps: int | None = None,
                     start_white_noise: bool = True, noise=None, mesh=None,
                     capture_trajectory: bool = False,
                     capture_x0: bool = False):
        """Alternating-grid tiled sampling. condition_x: (B, H, W, C) in
        [0, 1] at the target resolution (the pre-upscaled LR image); returns
        (B, H, W, C) in [0, 1]. ``noise``: the noise source (default
        ``GeneratorNoise(0, device)``); ``mesh``: a ``parallel.mesh.Mesh``
        whose data ranks split the tile chunks (``base.run_tile_chunks``),
        so every rank gets world 1's output and frames.

        ``capture_trajectory`` / ``capture_x0``: the debug frame stacks
        after the output (``base.Capture``), each frame cropped to the
        output region: frame 0 the init canvas, then the canvas, or the
        canvas of x0 estimates its tiles scatter, after each executed step.
        Not with DeepCache."""
        n_steps = num_sample_steps or self.num_sample_steps
        b, h, w, _ = condition_x.shape
        geom = make_geometry(h, w, tile_size, tile_stride)
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        table = self.log_snr_table(n_steps)
        if noise is None:
            noise = GeneratorNoise(0, condition_x.device)
        gss = generation_start_steps

        cond_padded = reflect_pad(normalize_to_neg_one_to_one(condition_x),
                                  geom.pad)
        canvas = tuple(cond_padded.shape)
        init = noise.init(canvas)
        if gss > 0:
            img = self.q_sample_log_snr(cond_padded, table[gss], init)
        elif start_white_noise:
            img = init
        else:
            img = self.q_sample_log_snr(cond_padded, table[0], init)

        cond_tiles, label_tiles, n_chunks, chunks, interior_mask = \
            prepare_tile_context(cond_padded, geom, b, batch_size, class_label)
        dc = make_deep_cache(self, n_steps - gss, mode, cond_tiles=cond_tiles)
        if self.deep_cache_interval > 1 and (capture_trajectory or capture_x0):
            raise NotImplementedError(
                'deep_cache_interval > 1 with tiled debug captures is not '
                'supported: the per-step state stack would also stack the '
                'per-tile deep-feature caches. Capture with deep-cache off.')
        cap = Capture(capture_trajectory, capture_x0, n_steps - gss, img,
                      crop=geom.crop)

        # dpmpp (and an x0 capture) threads a canvas of the step's x_start:
        # each step's tiles read it on their own grid and scatter their
        # x_start back
        dpmpp = self.sampler == 'dpmpp'
        thread_x0 = dpmpp or cap.x0
        x0_canvas = torch.zeros_like(img) if thread_x0 else None

        def tiled(canvas_t, p):
            return pad_tiles_to_multiple(extract_tiles(canvas_t, geom, p),
                                         chunks[p])

        for i in range(gss, n_steps):
            p = i % 2
            is_last = i == n_steps - 1
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            tiles, n_orig = tiled(img, p)
            nz = None
            if not is_last and self.uses_step_noise:
                nz, _ = tiled(noise.step(i, canvas), p)
            px = tiled(x0_canvas, p)[0] if dpmpp and i > gss else None
            outs = run_tile_chunks(
                lambda sl, **kw: self.p_sample_tiles(
                    tiles[sl], cond_tiles[p][sl],
                    None if label_tiles[p] is None else label_tiles[p][sl],
                    None if nz is None else nz[sl], table[i], table[i + 1],
                    mode, scale, is_last,
                    prev_x0=None if px is None else px[sl],
                    log_snr_prev=table[max(i - 1, 0)], **kw),
                dc, (i - gss) // 2, p, n_chunks[p], chunks[p], n_orig, tiles,
                n_out=2 if thread_x0 else 1, mesh=mesh)
            img = scatter_tiles(img, outs[0], geom, p)
            if thread_x0:
                x0_canvas = scatter_tiles(x0_canvas, outs[1], geom, p)

            if p == 1 and interior_mask is not None:
                # margin := q_sample(zeros, t_next) = sigma_next * noise, after
                # every odd step including the last (the crop never reaches it)
                sigma_next = float(np.sqrt(_sigmoid(-_f32(table[i + 1]))))
                fresh = noise.margin(i, canvas) * sigma_next
                img = img * interior_mask + fresh * (1.0 - interior_mask)
            cap.add(img, x0_canvas)

        out = crop_frames(img, geom.crop)
        return cap.result(
            unnormalize_to_zero_to_one(torch.clamp(out, -1.0, 1.0)))

    # ------------------------------------------------------------------
    # Training loss: ``ContinuousDiffusion.loss`` of the JAX package.
    # ------------------------------------------------------------------
    def log_snr_of(self, times):
        """log-SNR of float32 times (b,) on the device, differentiable in a
        learned schedule's parameters, with its ``frac_gradient`` mix."""
        if self.log_snr is None:
            return LOG_SNR_SCHEDULES[self.noise_schedule](times)
        normed = self.log_snr(times)
        if self.frac_gradient == 1.0:
            return normed
        return (normed * self.frac_gradient
                + normed.detach() * (1 - self.frac_gradient))

    def loss(self, img, condition_x, class_label=None, *, draws, noise=None,
             times=None):
        """Scalar training loss. img / condition_x: (B, H, W, C) in [0, 1].
        ``draws``: the draw source (``base.GeneratorDraws``): times ``t``
        (B,) uniform, ``noise`` (B, H, W, C) normal, and the whole-batch
        dropout uniforms. The net predicts the noise; with
        ``min_snr_loss_weight`` each sample's loss is weighted by
        max(snr, gamma) / snr (the continuous family clamps from below)."""
        b = img.shape[0]
        if times is None:
            times = draws.uniform('t', (b,))
        if noise is None:
            noise = draws.normal('noise', img.shape)
        x_start = normalize_to_neg_one_to_one(img)
        cond, class_mask = drop_conditions(
            draws, normalize_to_neg_one_to_one(condition_x), class_label,
            self.cond_drop_prob, self.class_cond_drop_prob)
        log_snr = self.log_snr_of(times)
        padded = log_snr.reshape((b,) + (1,) * (img.dim() - 1))
        x = (x_start * torch.sqrt(torch.sigmoid(padded))
             + noise * torch.sqrt(torch.sigmoid(-padded)))
        eps_hat = self.net_apply(x, log_snr, cond, class_label, class_mask)
        losses = per_sample_mean(elementwise_loss(eps_hat, noise,
                                                  self.loss_type))
        if self.min_snr_loss_weight:
            snr = torch.exp(log_snr)
            losses = losses * (torch.clamp_min(snr, self.min_snr_gamma) / snr)
        return torch.mean(losses)
