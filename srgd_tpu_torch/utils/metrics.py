"""Validation metrics: PSNR and SSIM.

Counterpart of ``srgd_tpu/utils/metrics.py``. Inputs are (B, H, W, C)
tensors in [0, 1]; each function returns a 0-dim float32 tensor.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def psnr(a, b, max_val: float = 1.0):
    """Per-batch mean PSNR in dB."""
    mse = torch.mean(torch.square(a - b), dim=(1, 2, 3))
    return torch.mean(20 * math.log10(max_val)
                      - 10 * torch.log10(torch.clamp_min(mse, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(a, b, max_val: float = 1.0, size: int = 11, sigma: float = 1.5):
    """Mean SSIM (Wang et al.), valid-window convolution, per-channel mean."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    win = _gaussian_kernel(size, sigma, a.device)[None, None]

    def filt(x):
        # depthwise valid conv per channel
        b_, h, w, c = x.shape
        y = F.conv2d(x.permute(0, 3, 1, 2).reshape(b_ * c, 1, h, w), win)
        return y.reshape(b_, c, *y.shape[-2:]).permute(0, 2, 3, 1)

    mu_a, mu_b = filt(a), filt(b)
    sa = filt(a * a) - mu_a ** 2
    sb = filt(b * b) - mu_b ** 2
    sab = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2)
    return torch.mean(num / den)
