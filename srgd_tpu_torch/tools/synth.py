"""Procedural images for the evaluation tools: the port's own copy of
``make_image`` and its helpers in ``tools/make_synth_dataset.py`` (numpy
only, the same bytes for the same generator), so the installed package
needs nothing outside it. Multi-scale 1/f textures, sharp geometric edges,
gradients and periodic patterns: the statistics SR training needs, with no
dataset to fetch."""

import numpy as np


def _fractal_noise(rng, size, beta):
    """1/f^beta random field per channel, normalized to [0, 1]."""
    f = np.fft.fftfreq(size)[:, None] ** 2 + np.fft.fftfreq(size)[None, :] ** 2
    amp = (f + 1.0 / size ** 2) ** (-beta / 2.0)
    out = np.empty((size, size, 3), np.float32)
    for c in range(3):
        phase = rng.uniform(0, 2 * np.pi, (size, size))
        spec = amp * np.exp(1j * phase)
        img = np.real(np.fft.ifft2(spec))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        out[:, :, c] = img
    return out


def _shapes(rng, size, n=24):
    """Random filled ellipses/rectangles/lines over a gradient background."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    gdir = rng.uniform(-1, 1, 2)
    base = (gdir[0] * xx + gdir[1] * yy)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    img = base[:, :, None] * rng.uniform(0.2, 1.0, 3) \
        + rng.uniform(0.0, 0.5, 3)
    for _ in range(n):
        color = rng.uniform(0, 1, 3)
        kind = rng.integers(0, 3)
        cx, cy = rng.uniform(0, 1, 2) * size
        if kind == 0:      # ellipse
            rx, ry = rng.uniform(0.02, 0.25, 2) * size
            th = rng.uniform(0, np.pi)
            c, s = np.cos(th), np.sin(th)
            u = (xx * size - cx) * c + (yy * size - cy) * s
            v = -(xx * size - cx) * s + (yy * size - cy) * c
            mask = (u / rx) ** 2 + (v / ry) ** 2 < 1
        elif kind == 1:    # rectangle
            w_, h_ = rng.uniform(0.03, 0.3, 2) * size
            mask = (np.abs(xx * size - cx) < w_) & (np.abs(yy * size - cy) < h_)
        else:              # thick line
            th = rng.uniform(0, np.pi)
            d = np.abs((xx * size - cx) * np.sin(th)
                       - (yy * size - cy) * np.cos(th))
            mask = d < rng.uniform(1, 6)
        alpha = rng.uniform(0.5, 1.0)
        img[mask] = img[mask] * (1 - alpha) + color * alpha
    return np.clip(img, 0, 1)


def _grating(rng, size):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        f = rng.uniform(2, 40)
        th = rng.uniform(0, np.pi)
        ph = rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * f * (xx * np.cos(th) + yy * np.sin(th)) + ph)
        img[:, :, c] = 0.5 + 0.5 * wave
    # blend with a shapes layer so gratings carry edges too
    return np.clip(0.6 * img + 0.4 * _shapes(rng, size, n=8), 0, 1)


def make_image(rng, size):
    """A (size, size, 3) uint8 image of one of four kinds drawn from the
    numpy generator ``rng``."""
    kind = rng.integers(0, 4)
    if kind == 0:
        img = _fractal_noise(rng, size, beta=rng.uniform(1.5, 3.0))
    elif kind == 1:
        img = _shapes(rng, size)
    elif kind == 2:
        img = _grating(rng, size)
    else:  # texture + shapes composite (most natural-image-like)
        img = np.clip(
            0.5 * _fractal_noise(rng, size, beta=rng.uniform(1.8, 2.6))
            + 0.5 * _shapes(rng, size), 0, 1)
    return (img * 255).astype(np.uint8)
