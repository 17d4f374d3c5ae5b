"""The work of each kernel's function, from its shapes: bytes that must
cross device memory (each input read once, each output written once) and
operations as the algorithm needs them; and the least time the chip could
take for it, the larger of bytes over the memory rate and operations over
the peak rate. Copied from chip_smoke.py's ``kernel_cases`` and
``int8_case`` and frozen here: they do not depend on what
implements the function. Hidden width: 4 heads x 32 = 128."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
HIDDEN, DIM_HEAD = 128, 32


def peaks() -> dict:
    with open(HERE / 'peaks.json') as f:
        return json.load(f)


def unet_counts(name: str = 'unet-dim128') -> dict:
    with open(HERE / f'{name}.json') as f:
        return json.load(f)


def linattn_block(b: int, n: int, c: int, es: int = 2) -> tuple:
    """(bytes, flops): x in and out, the four weights and three vectors;
    the q, k, v and out projections and the two context products."""
    nbytes = (2 * b * n * c + 4 * c * HIDDEN) * es + 12 * c
    flops = 2 * b * n * c * HIDDEN * 4 + 2 * 2 * b * n * HIDDEN * DIM_HEAD
    return nbytes, flops


def attn_block(b: int, n: int, c: int, es: int = 2) -> tuple:
    """(bytes, flops): as ``linattn_block``, with the n x n products of
    four heads."""
    nbytes = (2 * b * n * c + 4 * c * HIDDEN) * es + 12 * c
    flops = 2 * b * n * c * HIDDEN * 4 + 4 * b * 4 * n * n * DIM_HEAD
    return nbytes, flops


def int8_conv(m: int, cin: int, cout: int, ks: int) -> tuple:
    """(bytes, int8 operations) of an implicit-GEMM conv over m pixels:
    codes of x and w read once, scale and bias, the bf16 output written
    once."""
    k = ks * ks * cin
    return m * cin + cout * k + 8 * cout + 2 * m * cout, 2 * m * cout * k


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    p = peaks()
    return max(nbytes / p['hbm_bytes_per_s'], ops / p['flops_per_s'][dtype])


def forward_bound_s(kernel: str, tiles: int, counts: dict | None = None
                    ) -> float:
    """Least time of one forward's calls of ``kernel`` over ``tiles``
    tiles of the counts' size (one call per listed shape)."""
    counts = counts or unet_counts()
    total = 0.0
    if kernel in ('linattn_block', 'attn_block'):
        fn = linattn_block if kernel == 'linattn_block' else attn_block
        for n, c in counts[kernel]:
            total += bound_s(*fn(tiles, n, c), 'bfloat16')
    elif kernel == 'int8_conv':
        for h, w, cin, cout, ks, calls in counts[kernel]:
            total += calls * bound_s(*int8_conv(tiles * h * w, cin, cout, ks),
                                     'int8')
    else:
        raise KeyError(kernel)
    return total
