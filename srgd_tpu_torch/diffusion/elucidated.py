"""EDM (Karras "elucidated") diffusion: the stochastic Heun sampler, DPM-Solver++(2M)
and the alternating-grid tiled Heun sampler, with DeepCache.

Counterpart of ``srgd_tpu/diffusion/elucidated.py``. Every
scalar (sigmas, churn factors, the preconditioners, DPM++'s h and r) is a
float32 numpy value, as in the JAX sampler.

- ``precond_denoise``: c_skip(s) x + c_out(s) net(c_in(s) x, c_noise(s)),
  c_noise = log(s) / 4 as the net's time input; classifier-free guidance
  merges the whole preconditioned outputs; clamped to [-1, 1].
- Heun (``sample_org``): per step, churn x_hat = x + sqrt(s_hat^2 - s^2) *
  S_noise * noise with s_hat = s (1 + gamma), an Euler step to s_next and
  its Heun correction; the last step (s_next = 0) is Euler only.
- DPM++(2M) (``sample_using_dpmpp``) in t = -log(sigma).
- tiled: the churn noise is drawn and added at canvas level, the tiles of one
  grid take their Heun step, and after every odd step the margin is
  re-noised to sigma_i * noise (the CURRENT step's sigma). Heun only, as in
  the reference.

DeepCache: a refresh step runs both Heun evaluations full and keeps the
cache of the later one; a cached step reads the cache in both. DPM++
refreshes uniformly every ``deep_cache_interval`` steps.

Noise, from a source like ``base.GeneratorNoise``: ``init(shape)`` once,
then ``step(i, shape)`` for the churn of each
executed step whose gamma is not 0; DPM++ draws no step noise. Tiled, at
canvas shape, plus ``margin(i, canvas)`` after an odd step when the canvas
has a margin. A test replays the JAX keys: untiled, the init key of
``split(rng)`` and ``fold_in(rng', i)``; tiled, the two halves of
``split(fold_in(rng', i))``.
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
from srgd_tpu_torch.diffusion.schedules import EDMParams
from srgd_tpu_torch.tiling import (
    extract_tiles, make_geometry, reflect_pad, scatter_tiles,
)

_f32 = np.float32


class ElucidatedDiffusion:
    """EDM wrapper of a denoiser net whose time input is c_noise(sigma).
    ``use_dpmpp_solver`` picks DPM++(2M) over Heun for untiled ``sample``.
    DeepCache as in ``continuous.py``. The training keywords (condition
    dropout, loss type) are read by ``loss``."""

    def __init__(self, net, *, image_size: int, channels: int = 3,
                 num_sample_steps: int = 32, edm: EDMParams | None = None,
                 use_dpmpp_solver: bool = False, deep_cache_interval: int = 0,
                 deep_cache_depth: int = 2, deep_cache_schedule: str = '',
                 cond_drop_prob: float = 0.0,
                 class_cond_drop_prob: float = 0.0, loss_type: str = 'l2'):
        self.net = net
        self.image_size = image_size
        self.channels = channels
        self.num_sample_steps = num_sample_steps
        self.edm = edm or EDMParams()
        self.use_dpmpp_solver = use_dpmpp_solver
        self.deep_cache_interval = deep_cache_interval
        self.deep_cache_depth = deep_cache_depth
        self.deep_cache_schedule = deep_cache_schedule
        self.cond_drop_prob = cond_drop_prob
        self.class_cond_drop_prob = class_cond_drop_prob
        self.loss_type = loss_type
        self.net_apply = nhwc_net_apply(net, deep_cache_depth)

    def calibration_times(self, n: int = 6) -> np.ndarray:
        """Net time inputs for int8 calibration (``nn.quant``): c_noise of
        the Karras schedule's max(n, 2) sigmas, its trailing 0 dropped."""
        sig = self.edm.sample_schedule(max(n, 2))[:-1]
        return np.asarray(self.edm.c_noise(sig), np.float32)

    def precond_denoise(self, x, sigma, cond, class_label, mode: str,
                        scale: float, deep_cache=None,
                        return_cache: bool = False):
        """The preconditioned, guided denoiser at float32 ``sigma``, clamped
        to [-1, 1] as every sampler of the reference asks; the fresh cache
        last with ``return_cache``."""
        e = self.edm
        c_in, c_skip, c_out = (float(e.c_in(sigma)), float(e.c_skip(sigma)),
                               float(e.c_out(sigma)))
        time_b = torch.full((x.shape[0],), float(e.c_noise(sigma)),
                            dtype=torch.float32, device=x.device)

        def apply_fn(xs, ts, cs, lb, mask, **kw):
            out = self.net_apply(c_in * xs, ts, cs, lb, mask, **kw)
            if kw.get('return_cache'):
                return c_skip * xs + c_out * out[0], out[1]
            return c_skip * xs + c_out * out

        out = guided_denoise(apply_fn, x, time_b, cond, class_label, mode,
                             scale, deep_cache=deep_cache,
                             return_cache=return_cache)
        cache = ()
        if return_cache:
            out, cache = out[0], out[1:]
        out = torch.clamp(out, -1.0, 1.0)
        return (out,) + cache if return_cache else out

    def sigmas_gammas(self, n_steps: int):
        sig = self.edm.sample_schedule(n_steps)      # (N+1,), trailing 0
        return sig, self.edm.gammas(sig, n_steps)

    def churn(self, x, sigma, gamma, draw):
        """(x_hat, sigma_hat): x + sqrt(max(s_hat^2 - s^2, 0)) * S_noise *
        noise with s_hat = s + gamma s; ``draw()`` gives the noise, and is
        not called at gamma = 0, where x_hat is x."""
        sigma_hat = sigma + gamma * sigma
        if gamma == 0:
            return x, sigma_hat
        eps = float(_f32(self.edm.S_noise)) * draw()
        amp = np.sqrt(np.maximum(sigma_hat * sigma_hat - sigma * sigma,
                                 _f32(0.0)))
        return x + float(amp) * eps, sigma_hat

    def heun(self, x_hat, sigma_hat, sigma_next, cond, class_label, mode: str,
             scale: float, second_order: bool, **cache_kw):
        """The Euler step from the churned x_hat to sigma_next and, with
        ``second_order``, its Heun correction: (x_next, d)[ + (cache,)], d
        the step's derivative (x - denoised) / sigma, the corrector's d' on
        a Heun step: what the reference's x0 capture stores. A refresh
        (``return_cache``) runs both evaluations full and returns the later
        one's cache; a cached step reads ``deep_cache`` in both."""
        den, *cache = self._denoise(x_hat, sigma_hat, cond, class_label, mode,
                                    scale, **cache_kw)
        d = (x_hat - den) / float(sigma_hat)
        x_next = x_hat + float(sigma_next - sigma_hat) * d
        if second_order:
            den2, *cache = self._denoise(x_next, sigma_next, cond, class_label,
                                         mode, scale, **cache_kw)
            d2 = (x_next - den2) / float(sigma_next)
            x_next = x_hat + float(_f32(0.5) * (sigma_next - sigma_hat)) * (
                d + d2)
            d = d2
        return (x_next, d, *cache)

    def _denoise(self, x, sigma, cond, class_label, mode, scale, **cache_kw):
        out = self.precond_denoise(x, sigma, cond, class_label, mode, scale,
                                   **cache_kw)
        return out if cache_kw.get('return_cache') else (out,)

    @staticmethod
    def _init(noise, base, sig, gss: int):
        """sigma_0 * noise, or from step gss > 0 ``base`` + sigma_gss *
        noise."""
        if gss > 0:
            return base + float(sig[gss]) * noise.init(base.shape)
        return float(sig[0]) * noise.init(base.shape)

    @torch.inference_mode()
    def sample_org(self, condition_x, class_label=None, *, cond_scale=1.0,
                   guidance_start_steps=0, class_cond_scale=1.0,
                   class_guidance_start_steps=0, generation_start_steps=0,
                   num_sample_steps=None, noise=None, capture_trajectory=False,
                   capture_x0=False):
        """Stochastic Heun, untiled: condition_x (B, H, W, C) in [0, 1]. The
        captures (``base.Capture``) hold the image after each executed step
        and, as the reference's x0 capture does, the step's derivative d
        (d' on Heun steps), not the denoised image."""
        n = num_sample_steps or self.num_sample_steps
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        cond = normalize_to_neg_one_to_one(condition_x)
        sig, gam = self.sigmas_gammas(n)
        gss = generation_start_steps
        noise = noise or GeneratorNoise(0, cond.device)
        img = self._init(noise, cond, sig, gss)
        dc = make_deep_cache(self, n - gss, mode, shape=cond.shape)
        cap = Capture(capture_trajectory, capture_x0, n - gss, img)
        for i in range(gss, n):
            x_hat, sigma_hat = self.churn(
                img, sig[i], gam[i], lambda: noise.step(i, img.shape))
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            img, d = dc.step(lambda **kw: self.heun(
                x_hat, sigma_hat, sig[i + 1], cond, class_label, mode, scale,
                i < n - 1, **kw), i - gss)
            cap.add(img, d)
        return cap.result(
            unnormalize_to_zero_to_one(torch.clamp(img, -1.0, 1.0)))

    @torch.inference_mode()
    def sample_using_dpmpp(self, condition_x, class_label=None, *,
                           cond_scale=1.0, guidance_start_steps=0,
                           class_cond_scale=1.0, class_guidance_start_steps=0,
                           generation_start_steps=0, num_sample_steps=None,
                           noise=None, capture_trajectory=False,
                           capture_x0=False):
        """DPM-Solver++(2M), untiled; the first executed step and the last
        (sigma_next = 0) take the first-order update. The x0 capture holds
        each step's combined estimate D."""
        n = num_sample_steps or self.num_sample_steps
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        cond = normalize_to_neg_one_to_one(condition_x)
        sig, _ = self.sigmas_gammas(n)
        gss = generation_start_steps
        noise = noise or GeneratorNoise(0, cond.device)
        img = self._init(noise, cond, sig, gss)
        # uniform refreshes, whatever the schedule, as in the reference
        dc = make_deep_cache(self, n - gss, mode, shape=cond.shape,
                             schedule='')
        cap = Capture(capture_trajectory, capture_x0, n - gss, img)
        old = None
        for i in range(gss, n):
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            denoised, = dc.step(lambda **kw: self._denoise(
                img, sig[i], cond, class_label, mode, scale, **kw),
                i - gss)
            t = -np.log(sig[i])
            h = -np.log(np.maximum(sig[i + 1], _f32(1e-20))) - t
            d = denoised
            if i != gss and sig[i + 1] != 0:
                r = (t + np.log(sig[max(i - 1, 0)])) / h
                gamma = _f32(-1.0) / (_f32(2.0) * r)
                d = (float(_f32(1.0) - gamma) * denoised
                     + float(gamma) * old)
            img = float(sig[i + 1] / sig[i]) * img - float(np.expm1(-h)) * d
            old = denoised
            cap.add(img, d)
        return cap.result(
            unnormalize_to_zero_to_one(torch.clamp(img, -1.0, 1.0)))

    def sample(self, condition_x, class_label=None, **kw):
        """``sample_using_dpmpp`` when ``use_dpmpp_solver``, else Heun."""
        if self.use_dpmpp_solver:
            return self.sample_using_dpmpp(condition_x, class_label, **kw)
        return self.sample_org(condition_x, class_label, **kw)

    @torch.inference_mode()
    def tiled_sample(self, condition_x, class_label=None, *,
                     batch_size: int = 4, tile_size: int = 256,
                     tile_stride: int | None = None, cond_scale=1.0,
                     guidance_start_steps=0, class_cond_scale=1.0,
                     class_guidance_start_steps=0, generation_start_steps=0,
                     num_sample_steps=None, noise=None, mesh=None,
                     capture_trajectory=False, capture_x0=False):
        """Alternating-grid tiled Heun. condition_x: (B, H, W, C) in [0, 1]
        at the target resolution; returns (B, H, W, C) in [0, 1]. ``mesh``
        and the captures: as the continuous family's, the x0 canvas (which
        starts as the init canvas) holding the tiles' d, as ``sample_org``'s
        x0 capture does."""
        n = num_sample_steps or self.num_sample_steps
        b, h, w, _ = condition_x.shape
        geom = make_geometry(h, w, tile_size, tile_stride)
        mode = resolve_guidance_mode(cond_scale, class_cond_scale)
        sig, gam = self.sigmas_gammas(n)
        noise = noise or GeneratorNoise(0, condition_x.device)
        gss = generation_start_steps

        cond_padded = reflect_pad(normalize_to_neg_one_to_one(condition_x),
                                  geom.pad)
        canvas = tuple(cond_padded.shape)
        img = self._init(noise, cond_padded, sig, gss)
        cond_tiles, label_tiles, n_chunks, chunks, interior_mask = \
            prepare_tile_context(cond_padded, geom, b, batch_size, class_label)
        dc = make_deep_cache(self, n - gss, mode, cond_tiles=cond_tiles)
        if self.deep_cache_interval > 1 and (capture_trajectory or capture_x0):
            raise NotImplementedError(
                'deep_cache_interval > 1 with tiled debug captures is not '
                'supported (the state stack would also stack the per-tile '
                'deep-feature caches); capture with deep-cache off')
        cap = Capture(capture_trajectory, capture_x0, n - gss, img,
                      crop=geom.crop)
        x0_canvas = img if cap.x0 else None

        for i in range(gss, n):
            p = i % 2
            scale = guidance_scale(i, mode, cond_scale, guidance_start_steps,
                                   class_cond_scale,
                                   class_guidance_start_steps)
            img_hat, sigma_hat = self.churn(img, sig[i], gam[i],
                                            lambda: noise.step(i, canvas))
            tiles, n_orig = pad_tiles_to_multiple(
                extract_tiles(img_hat, geom, p), chunks[p])
            outs = run_tile_chunks(
                lambda sl, **kw: self.heun(
                    tiles[sl], sigma_hat, sig[i + 1], cond_tiles[p][sl],
                    None if label_tiles[p] is None else label_tiles[p][sl],
                    mode, scale, i < n - 1, **kw),
                dc, (i - gss) // 2, p, n_chunks[p], chunks[p], n_orig, tiles,
                n_out=2 if cap.x0 else 1, mesh=mesh)
            # the tiles' Heun steps land on the un-churned canvas
            img = scatter_tiles(img, outs[0], geom, p)
            if cap.x0:
                x0_canvas = scatter_tiles(x0_canvas, outs[1], geom, p)

            if p == 1 and interior_mask is not None:
                fresh = float(sig[i]) * noise.margin(i, canvas)
                img = img * interior_mask + fresh * (1.0 - interior_mask)
            cap.add(img, x0_canvas)

        out = crop_frames(img, geom.crop)
        return cap.result(
            unnormalize_to_zero_to_one(torch.clamp(out, -1.0, 1.0)))

    # ------------------------------------------------------------------
    # Training loss: ``ElucidatedDiffusion.loss`` of the JAX package.
    # ------------------------------------------------------------------
    def loss(self, img, condition_x, class_label=None, *, draws, noise=None,
             sigmas=None):
        """Scalar training loss. img / condition_x: (B, H, W, C) in [0, 1].
        ``draws``: the whole-batch dropout uniforms, ``sigma`` (B,) normal
        (sigmas = exp(P_mean + P_std n)) and ``noise``. Per-sample
        preconditioning; each sample's loss weighted by the EDM loss
        weight."""
        b = img.shape[0]
        e = self.edm
        x = normalize_to_neg_one_to_one(img)
        cond, class_mask = drop_conditions(
            draws, normalize_to_neg_one_to_one(condition_x), class_label,
            self.cond_drop_prob, self.class_cond_drop_prob)
        if sigmas is None:
            sigmas = torch.exp(e.P_mean + e.P_std * draws.normal('sigma', (b,)))
        if noise is None:
            noise = draws.normal('noise', x.shape)
        sig_b = sigmas.reshape((b,) + (1,) * (x.dim() - 1))
        noised = x + sig_b * noise
        net_out = self.net_apply(e.c_in_t(sig_b) * noised, e.c_noise_t(sigmas),
                                 cond, class_label, class_mask)
        denoised = e.c_skip_t(sig_b) * noised + e.c_out_t(sig_b) * net_out
        losses = per_sample_mean(elementwise_loss(denoised, x, self.loss_type))
        return torch.mean(losses * e.loss_weight_t(sigmas))
