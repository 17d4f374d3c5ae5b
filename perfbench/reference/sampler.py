"""The plain reference of the alternating-grid tiled sampler of continuous-
time diffusion (VDM, linear log-SNR schedule): ancestral and DDIM(eta).

Canvas level, float32. The condition is the pre-upscaled LR image in [0, 1]
(B, H, W, C), mapped to [-1, 1] and reflect-padded to a multiple of the tile
plus one tile (a single tile where it fits). Step i denoises the aligned
grid when i is even and the half-tile-shifted interior grid when i is odd;
the net sees each tile alone (its tile of the noisy canvas, of the
condition with the margin zeroed, the label of its canvas), and the step is
pointwise on the pixels the grid covers:

    log-SNR(t) = -log(expm1(1e-4 + 10 t^2)),  t = linspace(1, 0, N + 1)
    c = -expm1(l - l'),  alpha^2 = sigmoid(l),  sigma^2 = sigmoid(-l)
    x0 = clamp((x - sigma eps) / alpha, -1, 1)
    ancestral: x' = alpha' (x (1 - c) / alpha + c x0) + sqrt(sigma'^2 c) z
    ddim:      eps = (x - alpha x0) / sigma,  s = eta sqrt(sigma'^2 c)
               x' = alpha' x0 + sqrt(sigma'^2 - s^2) eps + s z
    (no z on the last step of the schedule)

After every odd step the margin outside the shifted grid is set to
sigma' z_margin. A run that starts at step g > 0 starts from
alpha_g cond + sigma_g z_init. The output is the crop of the original
region, clamped to [-1, 1] and mapped to [0, 1].

The noise comes from ``noise`` (``init``, ``step``, ``margin`` at canvas
shape), drawn in that documented order: init; per step i, the step noise
unless i is the last; after an odd step, the margin noise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def log_snr_table(n_steps: int) -> np.ndarray:
    t = np.linspace(1.0, 0.0, n_steps + 1)
    return (-np.log(np.maximum(np.expm1(1e-4 + 10 * t ** 2), 1e-20))
            ).astype(np.float32)


def _sig(v):
    v = np.float32(v)
    return np.float32(1.0) / (np.float32(1.0) + np.exp(-v))


def geometry(h: int, w: int, ts: int):
    """(padded_h, padded_w, pad (l, r, t, b), interior (t, l, b, r))."""
    if h <= ts and w <= ts:
        ph, pw = ts, ts
    else:
        ph = ((h - 1) // ts + 1) * ts + ts
        pw = ((w - 1) // ts + 1) * ts + ts
    left, top = (pw - w) // 2, (ph - h) // 2
    pad = (left, pw - w - left, top, ph - h - top)
    if ph <= ts and pw <= ts:
        interior = (0, 0, ph, pw)
    else:
        interior = (ts // 2, ts // 2, ph - ts // 2, pw - ts // 2)
    return ph, pw, pad, interior


def grid(parity: int, ph: int, pw: int, interior, ts: int):
    """Top-left corners of the step's tiles, row-major."""
    if parity == 0:
        t0, l0, b0, r0 = 0, 0, ph, pw
    else:
        t0, l0, b0, r0 = interior
    return [(y, x) for y in range(t0, b0 - ts + 1, ts)
            for x in range(l0, r0 - ts + 1, ts)]


def step(img, eps, ls, lsn, z, sampler: str = 'ancestral', eta: float = 0.0):
    """One reverse step from log-SNR ``ls`` to ``lsn`` on the pixels of
    ``img`` given the noise estimate ``eps``; ``z`` the step's noise, None
    on the last step."""
    ls, lsn = np.float32(ls), np.float32(lsn)
    cc = -np.expm1(ls - lsn)
    alpha, sigma = np.sqrt(_sig(ls)), np.sqrt(_sig(-ls))
    alpha_n, sq_sigma_n = np.sqrt(_sig(lsn)), _sig(-lsn)
    x0 = torch.clamp((img - float(sigma) * eps) / float(alpha), -1.0, 1.0)
    if sampler == 'ancestral':
        nxt = float(alpha_n) * (img * float(np.float32(1.0) - cc)
                                / float(alpha) + float(cc) * x0)
        if z is not None:
            nxt = nxt + float(np.sqrt(np.float32(
                max(float(sq_sigma_n * cc), 0.0)))) * z
        return nxt
    if sampler == 'ddim':
        e = (img - float(alpha) * x0) / float(sigma)
        std = np.float32(eta) * np.sqrt(np.maximum(sq_sigma_n * cc,
                                                   np.float32(0.0)))
        nxt = (float(alpha_n) * x0 + float(np.sqrt(np.maximum(
            sq_sigma_n - std * std, np.float32(0.0)))) * e)
        if z is not None and eta:
            nxt = nxt + float(std) * z
        return nxt
    raise ValueError(f'unknown sampler {sampler!r}')


def tiled_sample(net, cond01, labels, noise, *, n_steps: int, start: int,
                 tile: int, sampler: str = 'ancestral', eta: float = 0.0,
                 chunk: int = 8):
    """cond01: (B, H, W, C) float32 in [0, 1]; labels: (B,) int or None.
    ``net(x, log_snr, cond, label)`` on NCHW float32 tiles. Returns (B, H,
    W, C) in [0, 1]. ``chunk`` tiles go through the net at once (a batch
    of tiles of every canvas; the reference's own memory bound)."""
    b, h, w, c = cond01.shape
    ph, pw, pad, interior = geometry(h, w, tile)
    l, r, t, bt = pad
    cond = cond01 * 2.0 - 1.0
    if any(pad):
        cond = F.pad(cond.permute(0, 3, 1, 2), (l, r, t, bt),
                     mode='reflect').permute(0, 2, 3, 1).contiguous()
    canvas = tuple(cond.shape)
    it, il, ib, ir = interior
    mask = torch.zeros((1, ph, pw, 1), device=cond.device)
    mask[:, it:ib, il:ir, :] = 1.0
    has_margin = bool((mask == 0).any())
    cond_z = cond * mask if has_margin else cond
    table = log_snr_table(n_steps)
    init = noise.init(canvas)
    if start > 0:
        ls = table[start]
        img = (cond * float(np.sqrt(_sig(ls)))
               + init * float(np.sqrt(_sig(-np.float32(ls)))))
    else:
        img = init
    uses_noise = sampler == 'ancestral' or bool(eta)
    for i in range(start, n_steps):
        p, last = i % 2, i == n_steps - 1
        ls, lsn = np.float32(table[i]), np.float32(table[i + 1])
        z = noise.step(i, canvas) if (not last and uses_noise) else None
        corners = grid(p, ph, pw, interior, tile)
        eps = torch.zeros_like(img)
        rows = [(k, y, x) for k in range(b) for y, x in corners]
        for s in range(0, len(rows), chunk):
            part = rows[s:s + chunk]
            xs = torch.stack([img[k, y:y + tile, x:x + tile]
                              for k, y, x in part]).permute(0, 3, 1, 2)
            cs = torch.stack([cond_z[k, y:y + tile, x:x + tile]
                              for k, y, x in part]).permute(0, 3, 1, 2)
            lab = (None if labels is None else
                   torch.stack([labels[k] for k, _, _ in part]))
            tb = torch.full((len(part),), float(ls), device=img.device)
            out = net(xs.contiguous(), tb, cs.contiguous(), lab)
            for j, (k, y, x) in enumerate(part):
                eps[k, y:y + tile, x:x + tile] = out[j].permute(1, 2, 0)
        covered = torch.zeros((1, ph, pw, 1), device=img.device)
        for y, x in corners:
            covered[:, y:y + tile, x:x + tile] = 1.0
        nxt = step(img, eps, ls, lsn, z, sampler, eta)
        img = nxt * covered + img * (1.0 - covered)
        if p == 1 and has_margin:
            fresh = noise.margin(i, canvas) * float(np.sqrt(_sig(-lsn)))
            img = img * mask + fresh * (1.0 - mask)
    out = img[:, t:t + h, l:l + w]
    return (torch.clamp(out, -1.0, 1.0) + 1.0) * 0.5
