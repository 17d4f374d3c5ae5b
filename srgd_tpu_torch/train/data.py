"""Training data pipeline: image folder -> (hr, lr_condition, label) batches.

The port's own copy of ``srgd_tpu/train/data.py`` (the JAX package's
numpy pipeline; tests/test_torch_hygiene.py holds its code to the original,
and tests/test_torch_train_loop.py its batches). Only the imports differ:
the native helpers are ``srgd_tpu_torch.train.native``, and scipy's
``fftconvolve`` and ``j1`` are imported with the module, where the original
imports them inside ``_conv2d`` and ``sinc_kernel``, on the data threads.

The reference released no trainer or dataset code; its config implies a
Real-ESRGAN-style degradation pipeline (train_trans_mode: 'realesrgan',
config.py:149-150) over HR crops with hflip/90-degree-rotation augmentation
(config.py:94-95) and a 3-class degradation-conditioning task
'realsr_denoise_sr' (config.py:20-21). This module re-creates that surface:

  class 0 'realsr':  degradation chain selected by train_trans_mode
  class 1 'denoise': additive noise at HR resolution
  class 2 'sr':      clean x4 bicubic down -> bicubic up

Every degradation knob the reference Config accepts (config.py:146-170) is
honored here via ``DegradeConfig``: train_trans_mode (simple / aug_v1 /
aug_v2 / realesrgan), the blur family probs (gaussian / advance
[anisotropic] / sinc + sinc factor range), the noise family probs (gauss /
iso / multiplicative), image compression prob + quality bounds,
usm_sharpener, and interpolation. Unknown values raise. The exact recipes
were never shipped, so the chains are documented re-creations of the
Real-ESRGAN-style pipeline the knobs describe, not parity. Host-side
(numpy/scipy/PIL + the native C helpers) with a thread prefetcher; the
device only ever sees fixed-shape batches (uint8 with ``as_uint8``).
"""

from __future__ import annotations

import glob
import io
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
# imported here, never first on the data threads: two first imports racing
# each other leave scipy half initialised and every data thread dies
from scipy.signal import fftconvolve
from scipy.special import j1

CLASS_REALSR, CLASS_DENOISE, CLASS_SR = 0, 1, 2

TRANS_MODES = ('simple', 'aug_v1', 'aug_v2', 'realesrgan')
INTERPOLATIONS = ('BILINEAR', 'BICUBIC', 'LANCZOS')


@dataclass
class DegradeConfig:
    """The reference's degradation config surface (config.py:146-170)."""

    trans_mode: str = 'realesrgan'
    usm_sharpener: bool = False
    interpolation: str = 'BICUBIC'
    blur_prob: float = 0.5
    advance_blur_prob: float = 0.5
    gaussian_blur_prob: float = 0.5
    sinc_blur_prob: float = 0.5
    sinc_blur_factor_min: float = 0.9
    sinc_blur_factor_max: float = 1.1
    image_compression_prob: float = 0.5
    quality_lower: int = 50
    quality_upper: int = 100
    noise_prob: float = 0.5
    gauss_noise_prob: float = 0.5
    iso_noise_prob: float = 0.5
    multiplicative_noise_prob: float = 0.5

    def __post_init__(self):
        if self.trans_mode not in TRANS_MODES:
            raise ValueError(
                f'unsupported train_trans_mode {self.trans_mode!r}; '
                f'supported: {TRANS_MODES}')
        if self.interpolation not in INTERPOLATIONS:
            raise ValueError(
                f'unsupported interpolation {self.interpolation!r}; '
                f'supported: {INTERPOLATIONS}')

    @classmethod
    def from_conf(cls, conf) -> 'DegradeConfig':
        return cls(
            trans_mode=conf.train_trans_mode,
            usm_sharpener=conf.usm_sharpener,
            interpolation=conf.interpolation,
            blur_prob=conf.blur_prob,
            advance_blur_prob=conf.advance_blur_prob,
            gaussian_blur_prob=conf.gaussian_blur_prob,
            sinc_blur_prob=conf.sinc_blur_prob,
            sinc_blur_factor_min=conf.sinc_blur_factor_min,
            sinc_blur_factor_max=conf.sinc_blur_factor_max,
            image_compression_prob=conf.image_compression_prob,
            quality_lower=conf.quality_lower,
            quality_upper=conf.quality_upper,
            noise_prob=conf.noise_prob,
            gauss_noise_prob=conf.gauss_noise_prob,
            iso_noise_prob=conf.iso_noise_prob,
            multiplicative_noise_prob=conf.multiplicative_noise_prob,
        )


def list_images(root: str) -> list:
    exts = ('*.png', '*.jpg', '*.jpeg', '*.bmp', '*.webp')
    files = []
    for e in exts:
        files += glob.glob(os.path.join(root, '**', e), recursive=True)
    return sorted(files)


def fold_split(files: list, n_fold: int, fold: str, role: str,
               validation_ratio: float = 1.0) -> list:
    """Deterministic fold-based train/val split over the sorted file list.

    Re-creates the protocol the reference's ``n_fold``/``train_fold`` knobs
    describe (the reference config.py:65-66; the trainer that read them
    was never shipped): sorted file i belongs to fold ``i % n_fold``;
    ``fold`` (CSV of fold ids, e.g. '0' or '0,3') names the fold(s) HELD
    OUT for validation in this run — the cross-validation convention where
    run #k trains on everything except fold k — so role='train' keeps the
    complement and role='val' keeps the named folds, subsampled to the
    first ``ceil(validation_ratio * len)`` files (config.py:71).
    role=None (or n_fold <= 1) disables splitting."""
    if role is None or n_fold <= 1:
        return files
    import math
    held_out = {int(x) for x in str(fold).split(',') if x != ''}
    bad = sorted(i for i in held_out if not 0 <= i < n_fold)
    if bad:
        raise ValueError(
            f'train_fold ids {bad} out of range for n_fold={n_fold}')
    if role == 'train':
        return [f for i, f in enumerate(files) if i % n_fold not in held_out]
    if role == 'val':
        out = [f for i, f in enumerate(files) if i % n_fold in held_out]
        return out[:math.ceil(len(out) * validation_ratio)]
    raise ValueError(f'unknown fold role {role!r}')


def filter_by_min_size(files: list, min_size: int) -> list:
    """crop_size_limit (config.py:86): keep only images whose short side is
    >= the crop size (header-only size read; no pixel decode)."""
    from PIL import Image
    kept = []
    for f in files:
        try:
            with Image.open(f) as im:
                w, h = im.size
        except Exception:
            continue
        if min(w, h) >= min_size:
            kept.append(f)
    return kept


PREPROCESS_MODES = ('randomcrop', 'centercrop', 'justresize',
                    'resize_randomcrop')


def _ensure_min_size(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h >= size and w >= size:
        return img
    # upscale-pad small images to the crop size
    from PIL import Image
    scale = max(size / h, size / w)
    im = Image.fromarray(img).resize(
        (max(size, int(w * scale + 0.5)), max(size, int(h * scale + 0.5))),
        Image.BICUBIC)
    return np.asarray(im)


def _random_crop(img: np.ndarray, size: int, rng: np.random.Generator):
    img = _ensure_min_size(img, size)
    h, w = img.shape[:2]
    y = int(rng.integers(0, h - size + 1))
    x = int(rng.integers(0, w - size + 1))
    return img[y:y + size, x:x + size]


def _center_crop(img: np.ndarray, size: int):
    img = _ensure_min_size(img, size)
    h, w = img.shape[:2]
    y, x = (h - size) // 2, (w - size) // 2
    return img[y:y + size, x:x + size]


def preprocess_crop(img: np.ndarray, size: int, mode: str,
                    rng: np.random.Generator, scale_size: int = 0):
    """The reference's crop-method surface (config.py:146-148):
    randomcrop / centercrop / justresize / resize_randomcrop."""
    if mode == 'randomcrop':
        return _random_crop(img, size, rng)
    if mode == 'centercrop':
        return _center_crop(img, size)
    if mode == 'justresize':
        return _resize(img, (size, size))
    if mode == 'resize_randomcrop':
        target = scale_size or size
        img = _ensure_min_size(img, target)
        h, w = img.shape[:2]
        r = target / min(h, w)
        img = _resize(img, (max(size, int(w * r + 0.5)),
                            max(size, int(h * r + 0.5))))
        return _random_crop(img, size, rng)
    raise ValueError(f'unsupported preprocess mode {mode!r}; '
                     f'supported: {PREPROCESS_MODES}')


def _augment(img: np.ndarray, rng, hflip: bool, rotate: bool):
    if hflip and rng.random() < 0.5:
        img = img[:, ::-1]
    if rotate:
        img = np.rot90(img, k=int(rng.integers(0, 4)))
    return np.ascontiguousarray(img)


def _jpeg(img: np.ndarray, quality: int) -> np.ndarray:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', quality=quality)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert('RGB'))


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    from srgd_tpu_torch.train import native
    out = native.gaussian_blur(img, sigma)
    if out is not None:
        return out
    from PIL import Image, ImageFilter
    return np.asarray(Image.fromarray(img).filter(
        ImageFilter.GaussianBlur(radius=sigma)))


def _resize(img: np.ndarray, size, interpolation: str = 'BICUBIC') -> np.ndarray:
    # size is (W, H) PIL-style
    if interpolation == 'BICUBIC':
        from srgd_tpu_torch.train import native
        out = native.bicubic_resize(img, size[1], size[0])
        if out is not None:
            return out
    from PIL import Image
    resample = {'BILINEAR': Image.BILINEAR, 'BICUBIC': Image.BICUBIC,
                'LANCZOS': Image.LANCZOS}[interpolation]
    return np.asarray(Image.fromarray(img).resize(size, resample))


# ---------------------------------------------------------------------------
# Degradation ops (Real-ESRGAN-style; uint8 in/out, float32 internal)
# ---------------------------------------------------------------------------

def _conv2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Per-channel reflect-padded 2D convolution, uint8 -> uint8.

    FFT-based: the degradation kernels are 21x21, where direct convolution
    (scipy.ndimage) costs ~84 ms per 256px batch item on this 1-core box vs
    ~5 ms via FFT — the single largest CPU cost in the training data path.
    np.pad 'symmetric' matches scipy.ndimage.convolve(mode='reflect')
    (edge-pixel-repeating reflection), and all kernels here are
    180-degree-symmetric so correlation == convolution."""
    pad = kernel.shape[0] // 2
    f = np.pad(img.astype(np.float32), ((pad, pad), (pad, pad), (0, 0)),
               mode='symmetric')
    out = fftconvolve(f, kernel[:, :, None].astype(np.float32), mode='valid')
    return np.clip(out, 0, 255).astype(np.uint8)


def sinc_kernel(cutoff: float, size: int = 21) -> np.ndarray:
    """2D circular low-pass (sinc) filter, the Real-ESRGAN ringing/overshoot
    kernel: k(r) = cutoff * J1(cutoff*r) / (2*pi*r), normalized to sum 1."""
    assert size % 2 == 1
    ax = np.arange(size) - size // 2
    xx, yy = np.meshgrid(ax, ax)
    r = np.sqrt(xx * xx + yy * yy)
    with np.errstate(divide='ignore', invalid='ignore'):
        k = cutoff * j1(cutoff * r) / (2 * np.pi * r)
    k[size // 2, size // 2] = cutoff ** 2 / (4 * np.pi)
    return (k / k.sum()).astype(np.float32)


def aniso_gaussian_kernel(sig_x: float, sig_y: float, theta: float,
                          size: int = 21) -> np.ndarray:
    """Rotated anisotropic Gaussian kernel (the 'advance blur')."""
    assert size % 2 == 1
    ax = np.arange(size) - size // 2
    xx, yy = np.meshgrid(ax, ax)
    c, s = np.cos(theta), np.sin(theta)
    xr = c * xx + s * yy
    yr = -s * xx + c * yy
    k = np.exp(-0.5 * ((xr / sig_x) ** 2 + (yr / sig_y) ** 2))
    return (k / k.sum()).astype(np.float32)


def iso_noise(img: np.ndarray, rng: np.random.Generator,
              color_shift: float = 0.03, intensity: float = 0.5) -> np.ndarray:
    """Camera-sensor-style noise: Poisson-scaled luminance noise plus a hue
    shift on the chroma (the ISONoise transform the config names)."""
    f = img.astype(np.float32) / 255.0
    lum = f.mean(axis=2, keepdims=True)
    poisson = rng.poisson(lum * 255.0 * intensity) / (255.0 * intensity + 1e-8)
    f = f + (poisson - lum) * intensity
    shift = rng.normal(0, color_shift, (1, 1, 3)).astype(np.float32)
    f = f + shift * intensity
    return np.clip(f * 255.0, 0, 255).astype(np.uint8)


def multiplicative_noise(img: np.ndarray, rng: np.random.Generator,
                         lo: float = 0.9, hi: float = 1.1) -> np.ndarray:
    gain = rng.uniform(lo, hi, img.shape).astype(np.float32)
    return np.clip(img.astype(np.float32) * gain, 0, 255).astype(np.uint8)


def gauss_noise(img: np.ndarray, rng: np.random.Generator,
                sigma_range=(2.0, 20.0)) -> np.ndarray:
    sigma = rng.uniform(*sigma_range)
    out = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def usm_sharpen(img: np.ndarray, weight: float = 0.5, radius: float = 2.0,
                threshold: int = 10) -> np.ndarray:
    """Unsharp masking of HR targets (usm_sharpener, config.py:156): sharpen
    only where the residual exceeds the threshold (Real-ESRGAN USMSharp)."""
    blur = _gaussian_blur(img, radius).astype(np.float32)
    residual = img.astype(np.float32) - blur
    mask = (np.abs(residual) > threshold).astype(np.float32)
    out = img.astype(np.float32) + weight * residual * mask
    return np.clip(out, 0, 255).astype(np.uint8)


def _apply_blur(img: np.ndarray, rng: np.random.Generator,
                cfg: DegradeConfig, blur_sigma=(0.2, 2.0)) -> np.ndarray:
    """OneOf blur gated by the per-kind probs (blur_prob gates the group)."""
    kinds, weights = [], []
    for kind, p in (('gaussian', cfg.gaussian_blur_prob),
                    ('advance', cfg.advance_blur_prob),
                    ('sinc', cfg.sinc_blur_prob)):
        if p > 0:
            kinds.append(kind)
            weights.append(p)
    if not kinds:
        return img
    w = np.asarray(weights) / np.sum(weights)
    kind = kinds[int(rng.choice(len(kinds), p=w))]
    if kind == 'gaussian':
        return _gaussian_blur(img, float(rng.uniform(*blur_sigma)))
    if kind == 'advance':
        return _conv2d(img, aniso_gaussian_kernel(
            float(rng.uniform(0.2, 3.0)), float(rng.uniform(0.2, 3.0)),
            float(rng.uniform(0, np.pi)), size=21))
    # sinc: cutoff scaled by the configured factor range around pi/3
    factor = rng.uniform(cfg.sinc_blur_factor_min, cfg.sinc_blur_factor_max)
    cutoff = float(np.clip((np.pi / 3.0) * factor, 0.1, np.pi))
    return _conv2d(img, sinc_kernel(cutoff, size=21))


def _apply_noise(img: np.ndarray, rng: np.random.Generator,
                 cfg: DegradeConfig, sigma_range=(2.0, 20.0)) -> np.ndarray:
    kinds, weights = [], []
    for kind, p in (('gauss', cfg.gauss_noise_prob),
                    ('iso', cfg.iso_noise_prob),
                    ('mult', cfg.multiplicative_noise_prob)):
        if p > 0:
            kinds.append(kind)
            weights.append(p)
    if not kinds:
        return img
    w = np.asarray(weights) / np.sum(weights)
    kind = kinds[int(rng.choice(len(kinds), p=w))]
    if kind == 'gauss':
        return gauss_noise(img, rng, sigma_range)
    if kind == 'iso':
        return iso_noise(img, rng)
    return multiplicative_noise(img, rng)


def _degrade_chain(hr: np.ndarray, rng: np.random.Generator,
                   cfg: DegradeConfig, scale: int = 4) -> np.ndarray:
    """The 'realsr' class chain, selected by cfg.trans_mode."""
    size = hr.shape[0]
    lr_size = size // scale
    interp = cfg.interpolation

    if cfg.trans_mode == 'simple':
        return _resize(_resize(hr, (lr_size, lr_size), interp),
                       (size, size), interp)

    if cfg.trans_mode in ('aug_v1', 'aug_v2'):
        # one round: OneOf blur -> downscale -> OneOf noise -> jpeg
        out = hr
        if rng.random() < cfg.blur_prob:
            out = _apply_blur(out, rng, cfg)
        out = _resize(out, (lr_size, lr_size), interp)
        if rng.random() < cfg.noise_prob:
            out = _apply_noise(out, rng, cfg, sigma_range=(2.0, 20.0 / scale * 4))
        if rng.random() < cfg.image_compression_prob:
            out = _jpeg(out, int(rng.integers(cfg.quality_lower,
                                              cfg.quality_upper + 1)))
        if cfg.trans_mode == 'aug_v2':
            # v2 adds a second, milder noise+compression round
            if rng.random() < cfg.noise_prob * 0.5:
                out = _apply_noise(out, rng, cfg, sigma_range=(1.0, 8.0))
            if rng.random() < cfg.image_compression_prob * 0.5:
                out = _jpeg(out, int(rng.integers(cfg.quality_lower,
                                                  cfg.quality_upper + 1)))
        return _resize(out, (size, size), interp)

    # realesrgan: two-stage chain + optional final sinc (Real-ESRGAN fig. 2)
    out = hr
    cur = size
    for stage, (down_lo, down_hi) in enumerate([(0.4, 0.7), (0.6, 1.0)]):
        if rng.random() < cfg.blur_prob:
            out = _apply_blur(out, rng, cfg)
        cur = max(lr_size, int(size * rng.uniform(down_lo, down_hi)))
        out = _resize(out, (cur, cur), interp)
        if rng.random() < cfg.noise_prob:
            out = _apply_noise(out, rng, cfg)
        if rng.random() < cfg.image_compression_prob:
            out = _jpeg(out, int(rng.integers(cfg.quality_lower,
                                              cfg.quality_upper + 1)))
    out = _resize(out, (lr_size, lr_size), interp)
    if rng.random() < cfg.sinc_blur_prob:
        factor = rng.uniform(cfg.sinc_blur_factor_min, cfg.sinc_blur_factor_max)
        cutoff = float(np.clip((np.pi / 3.0) * factor, 0.1, np.pi))
        out = _conv2d(out, sinc_kernel(cutoff, size=11))
    return _resize(out, (size, size), interp)


def degrade(hr: np.ndarray, label: int, rng: np.random.Generator,
            scale: int = 4, quality_lower: int = 50, quality_upper: int = 95,
            noise_range=(2.0, 20.0), blur_sigma=(0.2, 2.0),
            cfg: Optional[DegradeConfig] = None) -> np.ndarray:
    """HR uint8 (S, S, 3) -> degraded condition uint8 (S, S, 3) (already
    bicubic-upscaled back to HR size, as fed to the net).

    The quality_* kwargs are a legacy shorthand; a full DegradeConfig takes
    precedence for the realsr-class chain."""
    if cfg is None:
        cfg = DegradeConfig(quality_lower=quality_lower,
                            quality_upper=quality_upper)
    size = hr.shape[0]
    lr_size = size // scale

    if label == CLASS_SR:
        lr = _resize(hr, (lr_size, lr_size), cfg.interpolation)
        return _resize(lr, (size, size), cfg.interpolation)

    if label == CLASS_DENOISE:
        sigma = rng.uniform(*noise_range)
        noisy = hr.astype(np.float32) + rng.normal(0, sigma, hr.shape)
        return np.clip(noisy, 0, 255).astype(np.uint8)

    return _degrade_chain(hr, rng, cfg, scale=scale)


class DegradationDataset:
    """Iterable over (hr, cond, label) float32 [0,1] batches with prefetch."""

    def __init__(self, root: str, crop_size: int = 256, batch_size: int = 16,
                 num_classes: int = 3, hflip: bool = True, rotate: bool = True,
                 seed: int = 0, num_workers: int = 4,
                 quality_lower: int = 50, quality_upper: int = 95,
                 degrade_cfg: Optional[DegradeConfig] = None,
                 preprocess: str = 'randomcrop', scale_size: int = 0,
                 shuffle: bool = True, scale: int = 4, crop_rate: int = 1,
                 crop_size_limit: bool = False, n_fold: int = 1,
                 fold: str = '0', fold_role: Optional[str] = None,
                 validation_ratio: float = 1.0, as_uint8: bool = False):
        self.files = list_images(root)
        if not self.files:
            raise FileNotFoundError(f'no images under {root}')
        if crop_size_limit:   # config.py:86: drop images smaller than a crop
            self.files = filter_by_min_size(self.files, crop_size)
            if not self.files:
                raise FileNotFoundError(
                    f'crop_size_limit: no image under {root} has short side '
                    f'>= crop_size {crop_size}')
        self.files = fold_split(self.files, n_fold, fold, fold_role,
                                validation_ratio)
        if not self.files:
            raise FileNotFoundError(
                f'fold split n_fold={n_fold} train_fold={fold!r} '
                f'role={fold_role!r} selected no files under {root}')
        self.scale = scale            # hr_image_size // lr_image_size
        self.crop_rate = max(int(crop_rate), 1)   # config.py:84: crop a
        # crop_rate x larger region, resize down — zoom-out augmentation
        # (1 = off, the shipped YAML's value)
        self.shuffle = shuffle
        self._cursor = 0                       # sequential order when not
        self._cursor_lock = threading.Lock()   # shuffling (conf.shuffle)
        self.crop_size = crop_size
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.hflip, self.rotate = hflip, rotate
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.cfg = degrade_cfg or DegradeConfig(quality_lower=quality_lower,
                                                quality_upper=quality_upper)
        if preprocess not in PREPROCESS_MODES:
            raise ValueError(f'unsupported preprocess {preprocess!r}; '
                             f'supported: {PREPROCESS_MODES}')
        # reference semantics: realesrgan mode ignores train_preprocess
        # (config.py:149-150)
        self.preprocess = ('randomcrop' if self.cfg.trans_mode == 'realesrgan'
                           else preprocess)
        self.scale_size = scale_size
        # as_uint8 keeps batches in uint8 [0,255] for the consumer to
        # normalize on the device: a quarter of float32's host-to-device
        # bytes.
        self.as_uint8 = as_uint8

    def _sample(self, rng: np.random.Generator):
        from PIL import Image
        if self.shuffle:
            idx = int(rng.integers(0, len(self.files)))
        else:
            with self._cursor_lock:
                idx, self._cursor = self._cursor, self._cursor + 1
            idx %= len(self.files)
        path = self.files[idx]
        img = np.asarray(Image.open(path).convert('RGB'))
        big = self.crop_size * self.crop_rate
        hr = preprocess_crop(img, big, self.preprocess, rng, self.scale_size)
        if big != self.crop_size:
            hr = _resize(hr, (self.crop_size, self.crop_size),
                         self.cfg.interpolation)
        hr = _augment(hr, rng, self.hflip, self.rotate)
        label = int(rng.integers(0, self.num_classes))
        cond = degrade(hr, label, rng, cfg=self.cfg, scale=self.scale)
        if self.cfg.usm_sharpener and self.cfg.trans_mode == 'realesrgan':
            # Real-ESRGAN sharpens the GT when usm_sharpener is on
            hr = usm_sharpen(hr)
        return hr, cond, label

    def _make_batch(self, rng: np.random.Generator):
        hrs, conds, labels = [], [], []
        for _ in range(self.batch_size):
            hr, cond, label = self._sample(rng)
            hrs.append(hr)
            conds.append(cond)
            labels.append(label)
        hr, cond = np.stack(hrs), np.stack(conds)
        if not self.as_uint8:
            hr = hr.astype(np.float32) / 255.0
            cond = cond.astype(np.float32) / 255.0
        return hr, cond, np.asarray(labels, np.int32)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        def worker(wid):
            rng = np.random.default_rng(self.seed * 1000 + wid)
            while not stop.is_set():
                batch = self._make_batch(rng)
                try:
                    q.put(batch, timeout=1.0)
                except queue.Full:
                    continue

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
