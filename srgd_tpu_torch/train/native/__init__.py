"""ctypes loader for the native data-pipeline ops (``degrade_native.c``).

The port's own copy of ``srgd_tpu/train/native``: the C source is the JAX
package's, byte for byte (tests/test_torch_hygiene.py holds it so). The
library is built on first use with a C compiler into the git-ignored
``build/srgd_tpu_torch/native/`` at the repository root, keyed by a hash of
the source and flags, never next to the source. When no compiler or build
is available every consumer takes the PIL path: the JAX package's own
semantics for host data code. ``backend()`` says which path a run takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger('srgd_tpu_torch.native')

SRC = Path(__file__).resolve().parent / 'degrade_native.c'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'srgd_tpu_torch' / 'native'
CFLAGS = ('-O3', '-shared', '-fPIC')

_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(' '.join(CFLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f'_degrade_native_{h.hexdigest()[:16]}.so'


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
    for cc in ('gcc', 'cc', 'g++'):
        try:
            subprocess.run([cc, *CFLAGS, '-o', str(tmp), str(SRC), '-lm'],
                           check=True, capture_output=True)
            os.replace(tmp, out)   # atomic: a concurrent build never loads a half file
            return True
        except (OSError, subprocess.CalledProcessError) as e:
            logger.debug('native build with %s failed: %s', cc, e)
    return False


def get_lib():
    """Returns the loaded library or None (the PIL path)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.bicubic_resize.argtypes = [u8p] + [ctypes.c_int] * 3 + [u8p] + \
            [ctypes.c_int] * 2
        lib.bicubic_resize.restype = None
        lib.gaussian_blur.argtypes = [u8p] + [ctypes.c_int] * 3 + \
            [ctypes.c_float, u8p]
        lib.gaussian_blur.restype = None
        _lib = lib
    except OSError as e:
        logger.warning('native degrade lib unavailable: %s', e)
    return _lib


def backend() -> str:
    """'native' when the C helpers load, else 'pil'."""
    return 'native' if get_lib() is not None else 'pil'


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def bicubic_resize(img: np.ndarray, out_h: int, out_w: int):
    """uint8 (H, W, C) -> (out_h, out_w, C); None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    lib.bicubic_resize(_u8ptr(img), h, w, c, _u8ptr(out), out_h, out_w)
    return out


def gaussian_blur(img: np.ndarray, sigma: float):
    """uint8 (H, W, C) blurred; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty_like(img)
    lib.gaussian_blur(_u8ptr(img), h, w, c, ctypes.c_float(sigma), _u8ptr(out))
    return out
