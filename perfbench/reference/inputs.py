"""The reference's own preparation of an LR image for the sampler: the x4
bicubic pre-upscale (PIL's BICUBIC, the reference CLI's), and the daemon's
bucket pad (reflect up to a multiple of the bucket) and crop."""

from __future__ import annotations

import numpy as np


def upscale(lr: np.ndarray, scale: int = 4) -> np.ndarray:
    """(h, w, 3) uint8 -> (scale h, scale w, 3) float32 in [0, 1]."""
    from PIL import Image
    h, w = lr.shape[:2]
    im = Image.fromarray(lr).resize((w * scale, h * scale),
                                    resample=Image.BICUBIC)
    return np.asarray(im, dtype=np.float32) / 255.0


def bucket_pad(lr: np.ndarray, bucket: int) -> np.ndarray:
    h, w = lr.shape[:2]
    bh, bw = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    return np.pad(lr, ((0, bh - h), (0, bw - w), (0, 0)), mode='reflect')


def to_uint8(out01: np.ndarray) -> np.ndarray:
    return np.clip(np.round(out01 * 255.0), 0, 255).astype(np.uint8)
