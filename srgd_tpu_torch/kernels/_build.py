"""Build ``srgd_tpu_torch/csrc/*.cu`` into one shared library and load it.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/srgd_tpu_torch/`` at the repository root on first use, keyed by a hash
of the sources and flags, and loaded with ``ctypes``: one ``nvcc`` call over
all sources, which compiles them on parallel threads. The kernels have plain
C entry points: every pointer and the stream are passed as ``c_void_p`` and
each entry point returns ``cudaGetLastError()``, which :func:`check` turns
into an exception. There is no fallback: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'srgd_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--threads', '0', '-shared', '-Xcompiler', '-fPIC')
CUDA_BIN = '/usr/local/cuda/bin'   # searched after PATH and $CUDA_HOME/bin

_lib = None


def find_nvcc() -> str:
    """``nvcc`` from PATH, ``$CUDA_HOME/bin`` or ``CUDA_BIN``."""
    dirs = [os.environ.get('PATH', '')]
    for env in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(env):
            dirs.append(os.path.join(os.environ[env], 'bin'))
    dirs.append(CUDA_BIN)
    nvcc = shutil.which('nvcc', path=os.pathsep.join(dirs))
    if nvcc is None:
        raise RuntimeError(
            f'nvcc not found (searched PATH, $CUDA_HOME/bin and {CUDA_BIN}): '
            'the srgd_tpu_torch CUDA kernels are built from source on first '
            'use and have no fallback')
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu'))


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in ('.cu', '.cuh'):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f'libsrgd_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the sources unless a library for this exact source hash exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
    cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)   # atomic: concurrent builders never load a half file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.srgd_error_string.argtypes = [ctypes.c_int]
        lib.srgd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def entry(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """C entry point
    ``name(ptr * n_ptrs, int * n_ints, float * n_floats, stream) -> int``."""
    fn = getattr(load(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().srgd_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
