#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and power limit (nvidia-smi), CUDA version; TF32
   is switched off for matmuls and convolutions.
2. build: the CUDA kernels are compiled from ``srgd_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version at every flagship
   shape (b = 8) in bfloat16 and float32, with max-abs error and CUDA-event
   times of both.
4. slice: the flagship net (dim 128, mults 1,2,4,8, full width, random
   weights from a seed, bfloat16) samples a 512x512 condition image through
   the tiled ancestral sampler with class CFG; the output must be finite, in
   [0, 1], of the right shape, and every U-Net forward must have launched
   each attention kernel once per attention block.
5. bench: one even and one odd step of a 512-px LR input (2304 canvas).

Then the kernel summary and, last, the device line. Exits non-zero, before
building anything, when no CUDA device is visible, and on any failure. There
is no CPU mode; the phase functions take a device and sizes so the tests can
rehearse them at a tiny size on the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# (n, c) of the linear-attention blocks and c of the full-attention blocks
# (n = 1024) that the flagship's tiled sampler runs
LINATTN_SHAPES = ((65536, 128), (16384, 128), (4096, 256), (4096, 512),
                  (16384, 256))
ATTN_SHAPES = ((1024, 512), (1024, 1024))
BF16_RTOL = 2e-2    # max|kernel - plain| <= 2e-2 * max|plain|
F32_ATOL = 1e-4     # max|kernel - plain| <= 1e-4 * max(1, max|plain|)

LINATTN_REPLACES = 'srgd_tpu/kernels/linattn_block.py:191'
ATTN_REPLACES = 'srgd_tpu/kernels/attn_block.py:107'


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {'phase': 'device', 'nvidia_smi': smi,
            'cuda': torch.version.cuda, 'torch': torch.__version__,
            'name': torch.cuda.get_device_name(0)}


def phase_build():
    from srgd_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    return {'phase': 'build', 'seconds': time.perf_counter() - t0,
            'library': str(path.name)}


def time_ms(torch, fn, device, iters: int) -> float:
    """Mean ms per call: CUDA events around ``iters`` calls after a warm-up
    (host clock on the CPU, where the tests rehearse this at tiny sizes)."""
    fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _within(err: float, ref_max: float, dtype, torch) -> tuple[bool, float]:
    tol = (BF16_RTOL * ref_max if dtype == torch.bfloat16
           else F32_ATOL * max(1.0, ref_max))
    return err <= tol, tol


def phase_kernels(torch, device, *, b=8, lin_shapes=LINATTN_SHAPES,
                  attn_shapes=ATTN_SHAPES, iters=5, seed=0):
    """Each kernel against its plain version at the given shapes, bf16 and f32.
    Inputs come from a seeded generator, weights scaled by 1/sqrt(fan-in)."""
    from srgd_tpu_torch.kernels import attn_block as ab
    from srgd_tpu_torch.kernels import linattn_block as lb
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    cases = []
    for kind, shapes in (('linattn_block', lin_shapes), ('attn_block', attn_shapes)):
        for n, c in shapes:
            x32 = randn(b, n, c)
            g1, g2 = 1 + randn(c, scale=0.1), 1 + randn(c, scale=0.1)
            bout = randn(c, scale=0.1)
            wout = randn(128, c, scale=128 ** -0.5)
            if kind == 'linattn_block':
                ws = [randn(c, 128, scale=c ** -0.5) for _ in range(3)]
            else:
                ws = [randn(c, 384, scale=c ** -0.5)]
            for dtype in (torch.bfloat16, torch.float32):
                x = x32.to(dtype)
                wd = [w.to(dtype) for w in ws] + [wout.to(dtype)]
                if kind == 'linattn_block':
                    args = (x, g1, *wd, bout, g2)
                    kern = lambda: lb.linattn_block(*args, dim_head=32)
                    plain = lambda: lb.linattn_block_plain(*args, dim_head=32)
                else:
                    args = (x, g1, *wd, bout)
                    kern = lambda: ab.attn_block(*args, heads=4, dim_head=32)
                    plain = lambda: ab.attn_block_plain(*args, heads=4,
                                                        dim_head=32)
                got, want = kern().float(), plain().float()
                if device.type == 'cuda':
                    torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ref_max = want.abs().max().item()
                ok, tol = _within(err, ref_max, dtype, torch)
                ok = ok and bool(torch.isfinite(got).all())
                cases.append({
                    'kernel': kind, 'n': n, 'c': c, 'b': b,
                    'dtype': str(dtype).replace('torch.', ''),
                    'max_abs_err': err, 'tol': tol, 'ok': ok,
                    'ms': time_ms(torch, kern, device, iters),
                    'plain_ms': time_ms(torch, plain, device, iters)})
                del got, want
    return {'phase': 'kernels', 'ok': all(c['ok'] for c in cases),
            'cases': cases}


def build_flagship(torch, device, *, dim=128, dim_mults=(1, 2, 4, 8),
                   full_attn=(False, False, False, True), seed=0):
    """The shipped config's net (conf/...dim128.yaml and Config defaults) and
    its continuous-time wrapper, with weights drawn from a seed, bf16."""
    from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
    from srgd_tpu_torch.nn.unet import SRUnet
    net = SRUnet(dim=dim, dim_mults=dim_mults, full_attn=full_attn,
                 learned_sinusoidal_cond=True, learned_sinusoidal_dim=32,
                 num_classes=3, dtype=torch.bfloat16, device=device)
    net.init_weights(torch.Generator(device='cpu').manual_seed(seed))
    return ContinuousDiffusion(net, image_size=256, noise_schedule='linear',
                               num_sample_steps=250)


def _attention_blocks(net) -> tuple[int, int]:
    """(linear, full) attention blocks one U-Net forward runs."""
    from srgd_tpu_torch.nn.layers import Attention, LinearAttention
    mods = list(net.modules())
    return (sum(isinstance(m, LinearAttention) for m in mods),
            sum(isinstance(m, Attention) for m in mods))


def phase_slice(torch, device, *, size=512, tile_size=256, steps=4,
                batch_size=8, seed=0, **net_kw):
    """Full-width tiled ancestral sampling with class CFG (doubled batch)."""
    from srgd_tpu_torch.diffusion.continuous import GeneratorNoise
    from srgd_tpu_torch.kernels import attn_block as ab
    from srgd_tpu_torch.kernels import linattn_block as lb
    wrapper = build_flagship(torch, device, seed=seed, **net_kw)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cond = torch.rand((1, size, size, 3), generator=gen, device=device)
    label = torch.tensor([1], device=device)
    n_lin, n_full = _attention_blocks(wrapper.net)

    forwards = 0
    net_forward = wrapper.net.forward

    def counted(*a, **k):
        nonlocal forwards
        forwards += 1
        return net_forward(*a, **k)

    wrapper.net.forward = counted
    lb.launches = ab.launches = 0
    t0 = time.perf_counter()
    out = wrapper.tiled_sample(
        cond, label, batch_size=batch_size, tile_size=tile_size,
        class_cond_scale=2.0, num_sample_steps=steps,
        noise=GeneratorNoise(seed + 2, device))
    if device.type == 'cuda':
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lin, full = lb.launches, ab.launches
    wrapper.net.forward = net_forward

    # every forward launches each attention block's kernel once; a CPU
    # rehearsal runs the plain versions, which never count
    per_block = forwards if device.type == 'cuda' else 0
    checks = {
        'shape': list(out.shape) == [1, size, size, 3],
        'finite': bool(torch.isfinite(out).all()),
        'in_unit_range': bool((out >= 0).all() and (out <= 1).all()),
        'linattn_launches': lin == n_lin * per_block,
        'attn_launches': full == n_full * per_block,
    }
    return {'phase': 'slice', 'ok': all(checks.values()), 'checks': checks,
            'shape': list(out.shape), 'steps': steps, 'forwards': forwards,
            'linattn_launches': lin, 'attn_launches': full,
            'linattn_blocks': n_lin, 'attn_blocks': n_full,
            'seconds': seconds, 'seconds_per_step': seconds / steps,
            'out_mean': out.mean().item()}


def phase_bench(torch, device, *, lr_size=512, tile_size=256, batch_size=8,
                seed=0, **net_kw):
    """One even and one odd step at the bench geometry: a lr_size LR input
    upscaled x4 (2048 out, 2304 canvas at tile 256), no CFG. The last two of
    250 steps run (248 even, 249 odd) and then the last alone, each after a
    warm-up, timed on the host clock around a synchronised call; the even
    step is their difference."""
    from srgd_tpu_torch.diffusion.continuous import GeneratorNoise
    from srgd_tpu_torch.tiling import make_geometry
    wrapper = build_flagship(torch, device, seed=seed, **net_kw)
    size = 4 * lr_size
    geom = make_geometry(size, size, tile_size)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cond = torch.rand((1, size, size, 3), generator=gen, device=device)

    def run(start):
        out = wrapper.tiled_sample(
            cond, None, batch_size=batch_size, tile_size=tile_size,
            num_sample_steps=250, generation_start_steps=start,
            noise=GeneratorNoise(seed + 2, device))
        if device.type == 'cuda':
            torch.cuda.synchronize()
        return out

    ms = {}
    for start in (248, 249):
        run(start)
        t0 = time.perf_counter()
        out = run(start)
        ms[start] = (time.perf_counter() - t0) * 1e3
    odd, even = ms[249], ms[248] - ms[249]
    ok = bool(torch.isfinite(out).all()) and even > 0
    return {'phase': 'bench', 'ok': ok,
            'canvas': [geom.padded_h, geom.padded_w],
            'tiles': [geom.n_tiles_even, geom.n_tiles_odd],
            'batch_size': batch_size, 'two_step_ms': ms[248],
            'even_step_ms': even, 'odd_step_ms': odd,
            'ms_per_step': ms[248] / 2,
            'implied_seconds_250_steps': 125 * ms[248] / 1e3}


def summary(kernels, slice_):
    out = []
    for name, src, rep, launches in (
            ('linattn_block', 'srgd_tpu_torch/csrc/linattn_block.cu',
             LINATTN_REPLACES, slice_['linattn_launches']),
            ('attn_block', 'srgd_tpu_torch/csrc/attn_block.cu',
             ATTN_REPLACES, slice_['attn_launches'])):
        mine = [c for c in kernels['cases'] if c['kernel'] == name]
        main = next(c for c in mine if c['dtype'] == 'bfloat16')
        out.append({'name': name, 'route': 'cuda', 'source': src,
                    'replaces': rep, 'launches': launches,
                    'max_abs_err': max(c['max_abs_err'] for c in mine),
                    'ms': main['ms'], 'plain_ms': main['plain_ms']})
    return {'kernels': out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible; this script has no CPU mode',
              file=sys.stderr)
        return 1
    try:
        import srgd_tpu_torch  # noqa: F401
    except ImportError:
        print('chip_smoke: run it from the root of the repository; the '
              'srgd_tpu_torch package is not importable', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    dev = phase_device(torch)
    emit(dev)
    emit(phase_build())
    kernels = phase_kernels(torch, device)
    emit(kernels)
    torch.cuda.synchronize()
    slice_ = phase_slice(torch, device)
    emit(slice_)
    torch.cuda.synchronize()
    bench = phase_bench(torch, device)
    emit(bench)
    torch.cuda.synchronize()
    emit(summary(kernels, slice_))
    failed = [p['phase'] for p in (kernels, slice_, bench) if not p['ok']]
    if failed:
        print(f'chip_smoke: failed phases {failed}', file=sys.stderr)
        return 1
    print(dev['nvidia_smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
