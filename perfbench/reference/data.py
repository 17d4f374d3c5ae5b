"""The training data stage judged on its own: every sample of a batch
against the benchmark's photos (made again from the seed) and the
configuration's three classes, with numpy and PIL only.

- ``hr`` is a crop of the configuration's size out of one of the photos,
  turned by one of the eight flips and quarter turns (hflip, rotate);
- the label is one of the classes: 0 'realsr' (the Real-ESRGAN chain),
  1 'denoise' (white noise added at full size), 2 'sr' (a clean bicubic
  down to the LR size and back up);
- ``cond`` fits its label: under 'denoise' it lies from ``hr`` by white
  noise (neighbouring pixels' residuals uncorrelated, its spread that of
  the class's sigma, 2 to 20 levels); under the two others it is an
  upsample from the LR size (the residual strongly correlated), and under
  'sr' it lies within rounding of PIL's bicubic down and up of ``hr``.

The thresholds leave wide room: over 700 samples of the configuration's
pipeline (256-px crops of 400-px photos) 'denoise' read a neighbour
correlation of -0.007 to 0.007 and a spread of 2.1 to 19.9 levels, the two
others 0.76 to 0.91, and 'sr' an RMS of 0.61 to 0.67 levels from PIL's (the
program resizes with its own bicubic)."""

from __future__ import annotations

import numpy as np

DENOISE, SR = 1, 2         # class 0 is 'realsr'
NOISE_CORR = 0.3          # |neighbour correlation| below it: white noise
NOISE_STD = (1.0, 25.0)   # levels
SR_RMS = 1.5              # levels from PIL's bicubic down and up


def pack(img: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 -> (..., H, W) int32, one number a pixel."""
    img = img.astype(np.int32)
    return (img[..., 0] << 16) | (img[..., 1] << 8) | img[..., 2]


def is_turned_crop(hr: np.ndarray, photos: np.ndarray) -> bool:
    """Whether ``hr`` (S, S, 3) is a crop of one of ``photos`` (packed,
    (n, H, W)) under one of the eight flips and quarter turns."""
    s = hr.shape[0]
    n, h, w = photos.shape
    rows, cols = h - s + 1, w - s + 1
    if rows < 1 or cols < 1 or hr.shape[1] != s:
        return False
    probes = ((s - 1, s - 1), (0, s - 1), (s - 1, 0), (s // 2, s // 3))
    for flip in (False, True):
        for k in range(4):
            q = pack(np.rot90(hr[:, ::-1] if flip else hr, k))
            cand = np.argwhere(photos[:, :rows, :cols] == q[0, 0])
            for py, px in probes:
                if not len(cand):
                    break
                cand = cand[photos[cand[:, 0], cand[:, 1] + py,
                                   cand[:, 2] + px] == q[py, px]]
            for i, y, x in cand:
                if np.array_equal(photos[i, y:y + s, x:x + s], q):
                    return True
    return False


def updown(img: np.ndarray, lr: int) -> np.ndarray:
    """PIL's bicubic down to ``lr`` and back up, float64."""
    from PIL import Image
    s = img.shape[0]
    return np.asarray(Image.fromarray(img).resize((lr, lr), Image.BICUBIC)
                      .resize((s, s), Image.BICUBIC)).astype(np.float64)


def cond_fits(hr: np.ndarray, cond: np.ndarray, label: int, lr: int,
              num_classes: int) -> bool:
    if not 0 <= label < num_classes or cond.shape != hr.shape:
        return False
    r = cond.astype(np.float64) - hr
    d = r - r.mean()
    corr = float((d[:, 1:] * d[:, :-1]).mean() / max(d.var(), 1e-12))
    if label == DENOISE:
        return abs(corr) < NOISE_CORR and \
            NOISE_STD[0] <= float(r.std()) <= NOISE_STD[1]
    if corr <= NOISE_CORR:
        return False
    if label == SR:
        e = cond.astype(np.float64) - updown(hr, lr)
        return float(np.sqrt(np.mean(e * e))) <= SR_RMS
    return True


def faults(batches, photos: np.ndarray, crop: int, lr: int,
           num_classes: int, batch_size: int) -> float:
    """Samples of ``batches`` ((hr, cond, label) numpy) that the data stage
    got wrong; inf where a batch has the wrong shape or type."""
    packed = pack(photos)
    bad = 0
    for hr, cond, label in batches:
        if (hr.dtype != np.uint8 or cond.dtype != np.uint8
                or hr.shape != (batch_size, crop, crop, 3)
                or cond.shape != hr.shape or label.shape != (batch_size,)
                or label.dtype.kind not in 'iu'):
            return float('inf')
        for h, c, lab in zip(hr, cond, label):
            bad += not (is_turned_crop(h, packed)
                        and cond_fits(h, c, int(lab), lr, num_classes))
    return float(bad)
