"""Continuous-time log-SNR tables.

Counterpart of ``make_log_snr_table`` in ``srgd_tpu/diffusion/schedules.py``,
copied because that module imports ``jax.numpy``. The sampling times are a
static linspace, so the log-SNR values are computed once on the host in
float64 and cast to float32.
"""

from __future__ import annotations

import math

import numpy as np


def make_log_snr_table(noise_schedule: str, times: np.ndarray) -> np.ndarray:
    """log-SNR at fixed sampling times, float64 on the host, float32 out."""
    t = np.asarray(times, dtype=np.float64)
    if noise_schedule == 'linear':
        vals = -np.log(np.maximum(np.expm1(1e-4 + 10 * t ** 2), 1e-20))
    elif noise_schedule == 'cosine':
        s = 0.008
        vals = -np.log(np.maximum(
            np.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2 - 1, 1e-5))
    elif noise_schedule == 'learned':
        raise NotImplementedError(
            'the learned log-SNR schedule is not ported to srgd_tpu_torch yet '
            '(ROADMAP.md Queue 1 item 11)')
    else:
        raise ValueError(f'unknown noise schedule {noise_schedule}')
    return vals.astype(np.float32)
