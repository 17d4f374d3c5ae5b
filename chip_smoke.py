#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and power limit (nvidia-smi), CUDA version; TF32
   is switched off for matmuls and convolutions.
2. build: the CUDA kernels are compiled from ``srgd_tpu_torch/csrc``.
3. kernels: each of the six kernels against its plain PyTorch version at every
   flagship shape (b = 8; ``groupnorm_silu`` with and without FiLM; every
   kernel's largest shape also at b = 16, the batch class CFG gives) in
   bfloat16 and float32 (the four tensor-core kernels, ``attention``,
   ``linattn_block``, ``attn_block`` and the linear-attention cores, also at
   ragged n, where their 64-row tiles end in a masked tail), with max-abs
   and rms error, the
   CUDA-event times of both (the 50 MB L2 is flushed before every timed call)
   and the bound: the least time the card could take, the larger of the
   function's bytes (inputs read once, outputs written once) over the memory
   rate and its operations over the peak rate for their type. For
   ``attention`` also the time of one ``F.scaled_dot_product_attention`` call
   on the same inputs, a yardstick the port never calls.
4. slice: the flagship net (dim 128, mults 1,2,4,8, full width, random
   weights from a seed, bfloat16) samples a 512x512 condition image through
   the tiled ancestral sampler with class CFG; the output must be finite, in
   [0, 1], of the right shape, and every U-Net forward must have launched
   ``linattn_block`` and ``attn_block`` once per attention block and no other
   kernel.
5. slice_pallas: the same net built with ``use_pallas``,
   ``use_pallas_attention`` and ``fused_linattn=False`` samples the same
   condition with DDIM at eta = 1; every forward must have launched
   ``groupnorm_silu`` once per Block, ``linear_attention_qkv`` once per
   linear and ``attention`` once per full attention block, and neither
   whole-block kernel. One forward of this net and of the default net on the
   same tile batch must agree within a relative bound, and so must each of
   its attention blocks on the input its twin saw; the default net also
   samples the same condition and noise and the two outputs' max-abs
   difference is reported; a 2-step ``dpmpp`` run must be finite and in
   [0, 1]; and the separate-q-k-v entry ``linear_attention``, which no module
   calls, is driven once on a stage-0 projection and must equal the packed
   entry bit for bit (``drive_launches`` in the summary, not ``launches``).
6. bench: one U-Net forward (b = 8 tiles of 256 px) and one even and one odd
   step of a 512-px LR input (2304 canvas), for the default net and for the
   ``use_pallas`` net.
7. profile, only with ``--profile``: ``torch.profiler`` over three forwards of
   each net, device time per kernel name, per kernel of the port (summed
   over all its launches and shapes) and per group of PyTorch's own kernels,
   and the device time of single calls of
   ``linattn_block``, ``attn_block``, ``linear_attention_qkv`` and
   ``attention`` beside SDPA's.

Every launch count is set to 0 just before a path is driven and read just
after. Then the kernel summary and, last, the device line. Exits non-zero,
before building anything, when no CUDA device is visible, and on any failure.
There is no CPU mode; the phase functions take a device and sizes so the
tests can rehearse them at a tiny size on the CPU.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

# (n, c) of the linear-attention blocks and c of the full-attention blocks
# (n = 1024) that the flagship's tiled sampler runs
LINATTN_SHAPES = ((65536, 128), (16384, 128), (4096, 256), (4096, 512),
                  (16384, 256))
ATTN_SHAPES = ((1024, 512), (1024, 1024))
# (rows, c) of the flagship's 38 Blocks, n of its linear-attention cores
# (C = 128) and n of its full-attention cores (4 heads of 32)
GN_SHAPES = ((65536, 128), (16384, 128), (16384, 256), (4096, 256),
             (4096, 512), (1024, 512), (1024, 1024))
LINEAR_SHAPES = (65536, 16384, 4096)
FLASH_SHAPES = (1024,)
# ragged cases at full width for the tensor-core kernels, whose tiles are 64
# rows: n of `attention`, (n, c) of `linattn_block` and `attn_block`, n of
# the linear-attention cores; no multiples of a tile
RAGGED_FLASH_SHAPES = (1000, 24)
RAGGED_LINATTN_SHAPES = ((4096 + 40, 256),)
RAGGED_ATTN_SHAPES = ((1000, 512), (24, 512))
RAGGED_LINEAR_SHAPES = (4096 + 40,)
FLUSH_WRITES = 16   # see time_ms
BF16_RTOL = 2e-2    # max|kernel - plain| <= 2e-2 * max|plain|
F32_ATOL = 1e-4     # max|kernel - plain| <= 1e-4 * max(1, max|plain|)
# max|y - y_default| / max|y_default| of one forward of the two bf16 nets, and
# of each attention block on its twin's input; the two round at different
# points
PALLAS_VS_DEFAULT_MAX = 0.05

# NVIDIA H100 SXM data sheet: device memory rate and dense peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}

# name -> (TPU kernel it replaces, CUDA source, wrapper module, counter)
KERNELS = {
    'linattn_block': ('srgd_tpu/kernels/linattn_block.py:191',
                      'linattn_block.cu', 'linattn_block', 'launches'),
    'attn_block': ('srgd_tpu/kernels/attn_block.py:107',
                   'attn_block.cu', 'attn_block', 'launches'),
    'groupnorm_silu': ('srgd_tpu/kernels/groupnorm_silu.py:60',
                       'groupnorm_silu.cu', 'groupnorm_silu', 'launches'),
    'attention': ('srgd_tpu/kernels/attention.py:53',
                  'attention.cu', 'attention', 'launches'),
    'linear_attention': ('srgd_tpu/kernels/linear_attention.py:90',
                         'linear_attention.cu', 'linear_attention',
                         'launches'),
    'linear_attention_qkv': ('srgd_tpu/kernels/linear_attention.py:197',
                             'linear_attention.cu', 'linear_attention',
                             'launches_qkv'),
}
OFF_PATH = ('linear_attention',)   # a public entry that no module calls
PALLAS_FLAGS = dict(use_pallas=True, use_pallas_attention=True,
                    fused_linattn=False)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _counter(name):
    import importlib
    _, _, module, attr = KERNELS[name]
    return importlib.import_module(f'srgd_tpu_torch.kernels.{module}'), attr


def reset_counts() -> None:
    for name in KERNELS:
        setattr(*_counter(name), 0)


def read_counts() -> dict:
    return {name: getattr(*_counter(name)) for name in KERNELS}


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
            'sources': [p.name for p in _build.sources()],
            'library': str(path.name)}


def time_ms(torch, fn, device, iters: int, flush=None) -> float:
    """Mean ms per call after a warm-up. On the card: CUDA events around each
    call, with ``flush`` (a buffer larger than the L2) rewritten before it so
    the call finds the cache cold, as it would behind another layer. On the
    CPU, where the tests rehearse this at tiny sizes, the host clock."""
    fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    events = []
    for _ in range(iters):
        if flush is not None:
            # rewritten FLUSH_WRITES times: the card is still busy with them
            # when the host has enqueued the call, so the timed window holds
            # the call's device time and not the host's launch latency
            for _ in range(FLUSH_WRITES):
                flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _within(err: float, ref_max: float, dtype, torch) -> tuple[bool, float]:
    tol = (BF16_RTOL * ref_max if dtype == torch.bfloat16
           else F32_ATOL * max(1.0, ref_max))
    return err <= tol, tol


def kernel_cases(torch, device, b, gen, *, lin_shapes, attn_shapes, gn_shapes,
                 linear_shapes, flash_shapes):
    """Yield (kernel, shape, make) for every kernel and shape; make(dtype)
    returns the kernel call, its plain version, the library call or None, and
    the bytes the function must move and the operations it must do, both
    from the shapes (element size es; hidden = 4 heads x 32 = 128)."""
    import torch.nn.functional as F

    from srgd_tpu_torch.kernels import attention as at
    from srgd_tpu_torch.kernels import attn_block as ab
    from srgd_tpu_torch.kernels import groupnorm_silu as gs
    from srgd_tpu_torch.kernels import linattn_block as lb
    from srgd_tpu_torch.kernels import linear_attention as la

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def es(dtype):
        return 2 if dtype == torch.bfloat16 else 4

    for kind, shapes in (('linattn_block', lin_shapes),
                         ('attn_block', attn_shapes)):
        for n, c in shapes:
            x32 = randn(b, n, c)
            g1, g2 = 1 + randn(c, scale=0.1), 1 + randn(c, scale=0.1)
            bout = randn(c, scale=0.1)
            wout = randn(128, c, scale=128 ** -0.5)
            if kind == 'linattn_block':
                ws = [randn(c, 128, scale=c ** -0.5) for _ in range(3)]
            else:
                ws = [randn(c, 384, scale=c ** -0.5)]

            def make(dtype, kind=kind, n=n, c=c, x32=x32, g1=g1, g2=g2,
                     bout=bout, wout=wout, ws=ws):
                x = x32.to(dtype)
                wd = [w.to(dtype) for w in ws] + [wout.to(dtype)]
                # x in, out, the four weights; qkv and out projections plus
                # the attention products
                nbytes = (2 * b * n * c + 4 * c * 128) * es(dtype) + 12 * c
                proj = 2 * b * n * c * 128 * 4
                if kind == 'linattn_block':
                    args = (x, g1, *wd, bout, g2)
                    return dict(
                        kern=lambda: lb.linattn_block(*args, dim_head=32),
                        plain=lambda: lb.linattn_block_plain(*args, dim_head=32),
                        bytes=nbytes, flops=proj + 2 * 2 * b * n * 128 * 32)
                args = (x, g1, *wd, bout)
                return dict(
                    kern=lambda: ab.attn_block(*args, heads=4, dim_head=32),
                    plain=lambda: ab.attn_block_plain(*args, heads=4,
                                                      dim_head=32),
                    bytes=nbytes, flops=proj + 4 * b * 4 * n * n * 32)

            yield kind, {'n': n, 'c': c}, make

    for rows, c in gn_shapes:
        x32 = randn(b, rows, c, scale=1.5) + 0.3
        gamma, beta = 1 + randn(c, scale=0.1), randn(c, scale=0.1)
        with_film = randn(b, 2, c, scale=0.2)

        # each ResnetBlock's block1 carries a FiLM, its block2 none
        for film in (with_film, None):
            def make(dtype, rows=rows, c=c, x32=x32, gamma=gamma, beta=beta,
                     film=film):
                x = x32.to(dtype)
                # x in, out, film and the affine; about 10 float operations
                # an element (two for the statistics, eight to normalise and
                # SiLU)
                return dict(
                    kern=lambda: gs.groupnorm_silu(x, gamma, beta, film),
                    plain=lambda: gs.groupnorm_silu_plain(x, gamma, beta, film),
                    bytes=(2 * b * rows * c * es(dtype) + 8 * c
                           + (0 if film is None else 8 * b * c)),
                    flops=10 * b * rows * c, flops_dtype='float32')

            yield ('groupnorm_silu',
                   {'n': rows, 'c': c, 'film': film is not None}, make)

    for n in flash_shapes:
        qkv32 = randn(b, n, 3, 4, 32)

        def make(dtype, n=n, qkv32=qkv32):
            # the transposed views of one projection, as Attention passes them
            qkv = qkv32.to(dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            return dict(
                kern=lambda: at.attention(q, k, v),
                plain=lambda: at.attention_plain(q, k, v),
                library=lambda: F.scaled_dot_product_attention(q, k, v),
                bytes=4 * b * 4 * n * 32 * es(dtype),
                flops=4 * b * 4 * n * n * 32)

        yield 'attention', {'n': n, 'c': 128}, make

    for n in linear_shapes:
        qkv32 = randn(b, n, 384)

        def make_qkv(dtype, n=n, qkv32=qkv32):
            qkv = qkv32.to(dtype)
            return dict(
                kern=lambda: la.linear_attention_qkv(qkv),
                plain=lambda: la.linear_attention_qkv_plain(qkv),
                bytes=4 * b * n * 128 * es(dtype),
                flops=2 * 2 * b * n * 128 * 32)

        def make_sep(dtype, n=n, qkv32=qkv32):
            q, k, v = (t.contiguous()
                       for t in qkv32.to(dtype).chunk(3, dim=-1))
            return dict(
                kern=lambda: la.linear_attention(q, k, v),
                plain=lambda: la.linear_attention_plain(q, k, v),
                bytes=4 * b * n * 128 * es(dtype),
                flops=2 * 2 * b * n * 128 * 32)

        yield 'linear_attention_qkv', {'n': n, 'c': 128}, make_qkv
        yield 'linear_attention', {'n': n, 'c': 128}, make_sep


def _largest(shapes):
    """The one shape with the most elements, as a tuple of shapes."""
    def size(s):
        return s if isinstance(s, int) else s[0] * s[1]
    return (max(shapes, key=size),)


def phase_kernels(torch, device, *, b=8, lin_shapes=LINATTN_SHAPES,
                  attn_shapes=ATTN_SHAPES, gn_shapes=GN_SHAPES,
                  linear_shapes=LINEAR_SHAPES, flash_shapes=FLASH_SHAPES,
                  ragged_lin_shapes=RAGGED_LINATTN_SHAPES,
                  ragged_flash_shapes=RAGGED_FLASH_SHAPES,
                  ragged_attn_shapes=RAGGED_ATTN_SHAPES,
                  ragged_linear_shapes=RAGGED_LINEAR_SHAPES, iters=5, seed=0):
    """Each kernel against its plain version at the given shapes, bf16 and f32,
    at batch b, at its largest shape also at 2 b, the batch class CFG
    gives, and the ragged shapes of the tensor-core kernels at b. The
    rms error is reported beside the gated max-abs error. Inputs come from a
    seeded generator, weights scaled by 1/sqrt(fan-in)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = (torch.empty(64 << 20, dtype=torch.uint8, device=device)
             if device.type == 'cuda' else None)
    shapes = dict(lin_shapes=lin_shapes, attn_shapes=attn_shapes,
                  gn_shapes=gn_shapes, linear_shapes=linear_shapes,
                  flash_shapes=flash_shapes)
    largest = {k: _largest(v) if v else () for k, v in shapes.items()}
    ragged = {**dict.fromkeys(shapes, ()), 'lin_shapes': ragged_lin_shapes,
              'flash_shapes': ragged_flash_shapes,
              'attn_shapes': ragged_attn_shapes,
              'linear_shapes': ragged_linear_shapes}
    todo = itertools.chain(
        zip(itertools.repeat(b),
            kernel_cases(torch, device, b, gen, **shapes)),
        zip(itertools.repeat(2 * b),
            kernel_cases(torch, device, 2 * b, gen, **largest)),
        zip(itertools.repeat(b),
            kernel_cases(torch, device, b, gen, **ragged)))
    cases = []
    for batch, (kind, shape, make) in todo:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace('torch.', '')
            case = make(dtype)
            got, want = case['kern']().float(), case['plain']().float()
            if device.type == 'cuda':
                torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rms = (got - want).square().mean().sqrt().item()
            ref_max = want.abs().max().item()
            ok, tol = _within(err, ref_max, dtype, torch)
            ok = ok and bool(torch.isfinite(got).all())
            del got, want
            by_bytes = case['bytes'] / HBM_BYTES_PER_S * 1e3
            by_ops = (case['flops']
                      / PEAK_FLOPS[case.get('flops_dtype', name)] * 1e3)
            library = case.get('library')
            cases.append({
                'kernel': kind, **shape, 'b': batch, 'dtype': name,
                'max_abs_err': err, 'rms_err': rms, 'tol': tol, 'ok': ok,
                'ms': time_ms(torch, case['kern'], device, iters, flush),
                'plain_ms': time_ms(torch, case['plain'], device, iters, flush),
                'library_ms': (None if library is None else
                               time_ms(torch, library, device, iters, flush)),
                'bytes': case['bytes'], 'flops': case['flops'],
                'bound_ms': max(by_bytes, by_ops),
                'bound_by': 'bytes' if by_bytes >= by_ops else 'operations'})
    return {'phase': 'kernels', 'ok': all(c['ok'] for c in cases),
            'cases': cases}


def build_flagship(torch, device, *, dim=128, dim_mults=(1, 2, 4, 8),
                   full_attn=(False, False, False, True), seed=0,
                   sampler='ancestral', ddim_eta=0.0, **flags):
    """The shipped config's net (conf/...dim128.yaml and Config defaults) and
    its continuous-time wrapper, with weights drawn from a seed, bf16.
    ``flags``: the U-Net's kernel flags."""
    from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
    from srgd_tpu_torch.nn.unet import SRUnet
    net = SRUnet(dim=dim, dim_mults=dim_mults, full_attn=full_attn,
                 learned_sinusoidal_cond=True, learned_sinusoidal_dim=32,
                 num_classes=3, dtype=torch.bfloat16, device=device, **flags)
    net.init_weights(torch.Generator(device='cpu').manual_seed(seed))
    return ContinuousDiffusion(net, image_size=256, noise_schedule='linear',
                               num_sample_steps=250, sampler=sampler,
                               ddim_eta=ddim_eta)


def _expected_launches(net, forwards: int) -> tuple[dict, dict]:
    """Launches of each kernel that ``forwards`` U-Net forwards of ``net``
    make, and that one forward makes: one per module that routes to it."""
    from srgd_tpu_torch.nn.layers import Attention, Block, LinearAttention
    mods = list(net.modules())
    blocks = [m for m in mods if isinstance(m, Block)]
    linear = [m for m in mods if isinstance(m, LinearAttention)]
    full = [m for m in mods if isinstance(m, Attention)]
    # bf16 with `fused` keeps the whole-block kernel under use_pallas
    to_flash = [m for m in full if m.use_pallas and not m.fused]
    per_forward = {
        'linattn_block': sum(not m.use_pallas for m in linear),
        'attn_block': len(full) - len(to_flash),
        'groupnorm_silu': sum(m.use_pallas for m in blocks),
        'attention': len(to_flash),
        'linear_attention': 0,
        'linear_attention_qkv': sum(m.use_pallas for m in linear),
    }
    return {k: v * forwards for k, v in per_forward.items()}, per_forward


def _sample_counted(torch, device, wrapper, cond, label, *, steps, tile_size,
                    batch_size, noise_seed, start=0):
    """One tiled class-CFG sampling run (steps ``start`` .. ``steps`` - 1 of
    ``steps``) with the launch counts set to 0 just before and read just
    after. Returns (out, forwards, launches, seconds)."""
    from srgd_tpu_torch.diffusion.continuous import GeneratorNoise
    forwards = 0
    net_forward = wrapper.net.forward

    def counted(*a, **k):
        nonlocal forwards
        forwards += 1
        return net_forward(*a, **k)

    wrapper.net.forward = counted
    reset_counts()
    t0 = time.perf_counter()
    out = wrapper.tiled_sample(
        cond, label, batch_size=batch_size, tile_size=tile_size,
        class_cond_scale=2.0, num_sample_steps=steps,
        generation_start_steps=start, noise=GeneratorNoise(noise_seed, device))
    if device.type == 'cuda':
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    wrapper.net.forward = net_forward
    return out, forwards, launches, seconds


def _slice_checks(torch, device, wrapper, out, size, forwards, launches):
    # a CPU rehearsal runs the plain versions, which never count
    expected, per_forward = _expected_launches(
        wrapper.net, forwards if device.type == 'cuda' else 0)
    checks = {
        'shape': list(out.shape) == [1, size, size, 3],
        'finite': bool(torch.isfinite(out).all()),
        'in_unit_range': bool((out >= 0).all() and (out <= 1).all()),
        'forwards': forwards > 0,
    }
    for name in KERNELS:
        checks[f'{name}_launches'] = launches[name] == expected[name]
    return checks, per_forward


def _slice_inputs(torch, device, size, seed):
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cond = torch.rand((1, size, size, 3), generator=gen, device=device)
    return cond, torch.tensor([1], device=device)


def phase_slice(torch, device, *, size=512, tile_size=256, steps=2,
                batch_size=8, seed=0, **net_kw):
    """Full-width tiled ancestral sampling with class CFG (doubled batch)
    through the default net: the two whole-block attention kernels."""
    wrapper = build_flagship(torch, device, seed=seed, **net_kw)
    cond, label = _slice_inputs(torch, device, size, seed)
    out, forwards, launches, seconds = _sample_counted(
        torch, device, wrapper, cond, label, steps=steps, tile_size=tile_size,
        batch_size=batch_size, noise_seed=seed + 2)
    checks, per_forward = _slice_checks(torch, device, wrapper, out, size,
                                        forwards, launches)
    return {'phase': 'slice', 'ok': all(checks.values()), 'checks': checks,
            'shape': list(out.shape), 'steps': steps, 'forwards': forwards,
            'launches': launches, 'per_forward': per_forward,
            'seconds': seconds, 'seconds_per_step': seconds / steps,
            'out_mean': out.mean().item()}


def phase_slice_pallas(torch, device, *, size=512, tile_size=256, steps=4,
                       batch_size=8, seed=0, pair_rows=256 * 256, **net_kw):
    """The ``use_pallas`` / ``use_pallas_attention`` / ``fused_linattn=False``
    net through the tiled DDIM(eta = 1) sampler with class CFG: kernels
    ``groupnorm_silu``, ``linear_attention_qkv`` and ``attention``."""
    from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
    from srgd_tpu_torch.kernels import linear_attention as la
    from srgd_tpu_torch.nn.layers import Attention, LinearAttention
    ddim = dict(sampler='ddim', ddim_eta=1.0)
    wrapper = build_flagship(torch, device, seed=seed, **ddim, **PALLAS_FLAGS,
                             **net_kw)
    cond, label = _slice_inputs(torch, device, size, seed)
    run = dict(tile_size=tile_size, batch_size=batch_size, noise_seed=seed + 2)
    out, forwards, launches, seconds = _sample_counted(
        torch, device, wrapper, cond, label, steps=steps, **run)
    checks, per_forward = _slice_checks(torch, device, wrapper, out, size,
                                        forwards, launches)

    # The default net on the same weights. One U-Net forward of each on the
    # same tile batch holds the second kernel set to the first at the net
    # level: both outputs are bf16 with different rounding points, a wrong
    # kernel gives a difference of the output's own size. With random weights
    # an attention block adds little to its residual, so each attention block
    # of the flagged net is also run on the input its twin saw in that
    # forward and held to the twin's output. Sampling from pure
    # noise divides by alpha ~ 0.007 in the first steps, so with random
    # weights it amplifies that rounding difference past the clamp: the
    # sampled outputs' difference is reported, not checked.
    default = build_flagship(torch, device, seed=seed, **ddim, **net_kw)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    tile = (batch_size, 3, tile_size, tile_size)
    fwd = dict(cond=torch.rand(tile, generator=gen, device=device) * 2 - 1,
               class_label=torch.arange(batch_size, device=device) % 3)
    x = torch.randn(tile, generator=gen, device=device)
    t = torch.rand(batch_size, generator=gen, device=device)
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, y, name=name: seen.update({name: (args[0], y)}))
        for name, m in default.net.named_modules()
        if isinstance(m, (Attention, LinearAttention))]

    def rel_diff(got, want):
        got, want = got.float(), want.float()
        return ((got - want).abs().max() / want.abs().max()).item()

    with torch.inference_mode():
        eps_default = default.net(x, t, **fwd)
        for hook in hooks:
            hook.remove()
        eps = wrapper.net(x, t, **fwd)
        forward_rel_diff = rel_diff(eps, eps_default)
        flagged = dict(wrapper.net.named_modules())
        block_rel_diff = max(rel_diff(flagged[name](x_in), y)
                             for name, (x_in, y) in seen.items())
    del seen
    checks['forward_tracks_default_net'] = (
        bool(torch.isfinite(eps).all())
        and forward_rel_diff <= PALLAS_VS_DEFAULT_MAX)
    checks['attention_blocks_track_default_net'] = (
        block_rel_diff <= PALLAS_VS_DEFAULT_MAX)
    diff_from_noise = (out - _sample_counted(
        torch, device, default, cond, label, steps=steps, **run)[0]
    ).abs().max().item()
    del default

    # two steps of DPM-Solver++(2M) on the same net
    dpmpp = ContinuousDiffusion(wrapper.net, image_size=256, sampler='dpmpp')
    out_dp, _, dp_launches, _ = _sample_counted(
        torch, device, dpmpp, cond, label, steps=2, **run)
    checks['dpmpp_finite_in_unit_range'] = bool(
        torch.isfinite(out_dp).all() and (out_dp >= 0).all()
        and (out_dp <= 1).all())

    # the separate-q-k-v entry on a stage-0 projection of this net: the same
    # device code as the packed entry, so the two agree bit for bit
    attn = wrapper.net.downs[0][2]
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    side = int(pair_rows ** 0.5)
    x = torch.randn((batch_size, attn.to_qkv.in_channels, side, side),
                    generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        qkv = attn.to_qkv(attn.norm(x)).permute(0, 2, 3, 1).reshape(
            batch_size, side * side, -1)
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
        reset_counts()
        separate = la.linear_attention(q, k, v)
        pair_launches = read_counts()
        packed = la.linear_attention_qkv(qkv)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    on_card = int(device.type == 'cuda')
    pair_diff = (separate.float() - packed.float()).abs().max().item()
    # on the CPU the two plain versions differ by the order of their sums
    checks['entry_pair_equal'] = pair_diff <= (
        0.0 if on_card else BF16_RTOL * packed.float().abs().max().item())
    checks['entry_pair_launches'] = pair_launches == {
        **dict.fromkeys(KERNELS, 0), 'linear_attention': on_card}

    return {'phase': 'slice_pallas', 'ok': all(checks.values()),
            'checks': checks, 'shape': list(out.shape), 'steps': steps,
            'sampler': 'ddim', 'ddim_eta': 1.0, 'forwards': forwards,
            'launches': launches, 'per_forward': per_forward,
            'forward_rel_diff_vs_default_net': forward_rel_diff,
            'attention_block_rel_diff_vs_default_net': block_rel_diff,
            'max_abs_diff_vs_default_net_from_noise': diff_from_noise,
            'dpmpp_launches': dp_launches,
            'entry_pair': {'shape': list(qkv.shape), 'max_abs_diff': pair_diff,
                           'drive_launches': pair_launches['linear_attention']},
            'seconds': seconds, 'seconds_per_step': seconds / steps,
            'out_mean': out.mean().item()}


def _bench_net(torch, device, wrapper, cond, *, tile_size, batch_size, seed,
               forward_iters):
    """ms of one forward on a tile batch, and of one even and one odd sampler
    step: the last two of 250 steps run (248 even, 249 odd) and then the last
    alone, each after a warm-up, timed on the host clock around a synchronised
    call; the even step is their difference."""
    from srgd_tpu_torch.diffusion.continuous import GeneratorNoise

    gen = torch.Generator(device=device).manual_seed(seed + 4)
    x = torch.randn((batch_size, 3, tile_size, tile_size), generator=gen,
                    device=device)
    t = torch.zeros(batch_size, device=device)

    def forward():
        with torch.inference_mode():
            wrapper.net(x, t, cond=x)

    forward()
    forward_ms = time_ms(torch, forward, device, forward_iters)

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
    return ok, {'forward_ms': forward_ms, 'two_step_ms': ms[248],
                'even_step_ms': even, 'odd_step_ms': odd,
                'ms_per_step': ms[248] / 2,
                'implied_seconds_250_steps': 125 * ms[248] / 1e3}


def phase_bench(torch, device, *, lr_size=512, tile_size=256, batch_size=8,
                seed=0, forward_iters=5, **net_kw):
    """The bench geometry: a lr_size LR input upscaled x4 (2048 out, 2304
    canvas at tile 256), no CFG, ancestral, bf16. The default net's numbers,
    then the same with the ``use_pallas`` net under ``pallas_`` keys."""
    from srgd_tpu_torch.tiling import make_geometry
    size = 4 * lr_size
    geom = make_geometry(size, size, tile_size)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cond = torch.rand((1, size, size, 3), generator=gen, device=device)
    res = {'phase': 'bench', 'canvas': [geom.padded_h, geom.padded_w],
           'tiles': [geom.n_tiles_even, geom.n_tiles_odd],
           'batch_size': batch_size}
    oks = []
    for prefix, flags in (('', {}), ('pallas_', PALLAS_FLAGS)):
        wrapper = build_flagship(torch, device, seed=seed, **flags, **net_kw)
        ok, nums = _bench_net(torch, device, wrapper, cond,
                              tile_size=tile_size, batch_size=batch_size,
                              seed=seed, forward_iters=forward_iters)
        oks.append(ok)
        res.update({prefix + k: v for k, v in nums.items()})
        del wrapper
    res['ok'] = all(oks)
    return res


# device kernel (function name in the profile) -> the port's kernel
DEVICE_KERNELS = {
    'phase_a': 'linattn_block', 'phase_b': 'linattn_block',
    'phase_a_mma': 'linattn_block', 'phase_b_mma': 'linattn_block',
    'qkv_proj': 'attn_block', 'attend': 'attn_block',
    'qkv_proj_mma': 'attn_block', 'attn_block_flash': 'attn_block',
    'out_proj_mma': 'attn_block',
    'gn_stats': 'groupnorm_silu', 'gn_fold': 'groupnorm_silu',
    'gn_apply': 'groupnorm_silu', 'flash': 'attention',
    'flash_mma': 'attention', 'kv_partials': 'linear_attention_qkv',
    'out_rows': 'linear_attention_qkv',
    'kv_partials_mma': 'linear_attention_qkv',
    'out_rows_mma': 'linear_attention_qkv'}
# the float32 device kernels: a bfloat16 net must spend no time in them
F32_ONLY_KERNELS = ('phase_a', 'phase_b', 'flash', 'qkv_proj', 'attend',
                    'kv_partials', 'out_rows')


def _device_rows(torch, run, calls: int, on_card: bool):
    """(ms per call, launches per call, name) of every device kernel that
    ``run()`` (``calls`` calls of something) launches, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        run()
    attr = 'self_device_time_total' if on_card else 'self_cpu_time_total'
    return sorted(((getattr(e, attr) / 1e3 / calls, e.count / calls, e.key)
                   for e in prof.key_averages() if getattr(e, attr) > 0
                   # on the card kernels only, not the operators over them
                   and (not on_card or e.device_type == DeviceType.CUDA)),
                  reverse=True)


def _function(key: str) -> str:
    """The function name of a profiler key: ``ns::name<args>(params)``."""
    import re
    m = re.search(r'(\w+)(<.*>)?\(', key)
    return m.group(1) if m else key


def _by_function(rows) -> dict:
    """ms per call of every device kernel, by function name."""
    out = {}
    for ms, _, key in rows:
        out[_function(key)] = out.get(_function(key), 0.0) + ms
    return out


def _by_kernel(rows, merge_owner: str) -> dict:
    """ms per call of each of the port's kernels, summed over its device
    kernels by function name; the partial merge that two of them share goes
    to ``merge_owner``, the one the profiled net routes to."""
    out = {}
    for ms, calls, key in rows:
        fn = _function(key)
        owner = merge_owner if fn == 'merge_kv_partials' else DEVICE_KERNELS.get(fn)
        if owner is not None:
            entry = out.setdefault(owner, {'ms': 0.0, 'device_kernels': {}})
            entry['ms'] += ms
            entry['device_kernels'][fn] = entry['device_kernels'].get(fn, 0.0) + ms
    return out


# what PyTorch's own device kernels are doing, by the first substring of the
# kernel's name that matches
OP_GROUPS = (
    ('convolutions', ('xmma', 'convolve', 'cudnn', 'conv')),
    ('gemm', ('nvjet', 'gemm', 'cutlass')),
    ('groupnorm_moments', ('RowwiseMoments',)),
    ('concatenations', ('CatArray',)),
    ('copies_and_casts', ('copy_kernel',)),
    ('reductions', ('reduce_kernel',)),
    ('elementwise', ('elementwise',)),
)


def _by_group(rows) -> dict:
    """ms per call of every device kernel summed by group: the port's own
    kernels together, then ``OP_GROUPS``, then ``other``."""
    out = {'port_kernels': 0.0, **{g: 0.0 for g, _ in OP_GROUPS}, 'other': 0.0}
    for ms, _, key in rows:
        fn = _function(key)
        if fn in DEVICE_KERNELS or fn == 'merge_kv_partials':
            group = 'port_kernels'
        else:
            group = next((g for g, subs in OP_GROUPS
                          if any(sub in key for sub in subs)), 'other')
        out[group] += ms
    return out


def phase_profile(torch, device, *, tile_size=256, batch_size=8, seed=0,
                  forwards=3, top=24, lin_shapes=LINATTN_SHAPES,
                  attn_shapes=ATTN_SHAPES, linear_shapes=LINEAR_SHAPES,
                  flash_shapes=FLASH_SHAPES, **net_kw):
    """``torch.profiler`` over ``forwards`` U-Net forwards of the default and
    of the ``use_pallas`` net (b = 8 tiles of 256 px, bf16): self device time
    per kernel name, in ms per forward, largest first, with the sum over all
    kernels beside the host-clock time of a forward, ``by_kernel``: each of
    the port's kernels' time per forward summed over all its launches and
    shapes, and ``by_group``: every device kernel's time by what it does. A
    bfloat16 net must spend no time in the float32 device kernels.
    Then ``standalone``: the device time (no host latency, L2 warm) of one
    call of the four tensor-core kernels at the flagship shapes,
    ``attention`` beside ``F.scaled_dot_product_attention``, and of the two
    kernels of three launches by device kernel. Not
    part of the default run: ``python3 chip_smoke.py --profile`` adds it."""
    import torch.nn.functional as F

    from srgd_tpu_torch.kernels import attention as at
    from srgd_tpu_torch.kernels import attn_block as ab
    from srgd_tpu_torch.kernels import linattn_block as lb
    from srgd_tpu_torch.kernels import linear_attention as la
    on_card = device.type == 'cuda'
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    x = torch.randn((batch_size, 3, tile_size, tile_size), generator=gen,
                    device=device)
    t = torch.zeros(batch_size, device=device)
    res = {'phase': 'profile', 'forwards': forwards, 'nets': {}}
    ok = True
    for name, flags, merge_owner in (
            ('default', {}, 'linattn_block'),
            ('use_pallas', PALLAS_FLAGS, 'linear_attention_qkv')):
        net = build_flagship(torch, device, seed=seed, **flags, **net_kw).net

        def run(n):
            with torch.inference_mode():
                for _ in range(n):
                    net(x, t, cond=x)
            if on_card:
                torch.cuda.synchronize()

        run(2)
        t0 = time.perf_counter()
        run(forwards)
        host_ms = (time.perf_counter() - t0) * 1e3 / forwards
        rows = _device_rows(torch, lambda: run(forwards), forwards, on_card)
        by_kernel = _by_kernel(rows, merge_owner)
        f32_ms = sum(ms for k in by_kernel.values()
                     for fn, ms in k['device_kernels'].items()
                     if fn in F32_ONLY_KERNELS)
        res['nets'][name] = {
            'host_ms_per_forward': host_ms,
            'kernel_ms_per_forward': sum(r[0] for r in rows),
            'by_kernel': by_kernel,
            'by_group': _by_group(rows),
            'ms_in_float32_kernels': f32_ms,
            'top': [{'ms': ms, 'calls': calls, 'name': key[:200]}
                    for ms, calls, key in rows[:top]]}
        ok = ok and sum(r[0] for r in rows) > 0 and f32_ms == 0
        del net

    def device_rows(fn, calls=5):
        def run():
            for _ in range(calls):
                fn()
            if on_card:
                torch.cuda.synchronize()
        run()
        return _device_rows(torch, run, calls, on_card)

    def device_ms(fn):
        return sum(r[0] for r in device_rows(fn))

    def device_split(name, fn):
        """The call's device time, and by device kernel in ``split``."""
        rows = device_rows(fn)
        standalone[name] = sum(r[0] for r in rows)
        split[name] = _by_function(rows)

    standalone, split = {}, {}
    for n, c in lin_shapes:
        xs = torch.randn((batch_size, n, c), generator=gen,
                         device=device).to(torch.bfloat16)
        ws = [(torch.randn((c, 128), generator=gen, device=device)
               * c ** -0.5).to(torch.bfloat16) for _ in range(3)]
        wout = (torch.randn((128, c), generator=gen, device=device)
                * 128 ** -0.5).to(torch.bfloat16)
        g = torch.ones(c, device=device)
        standalone[f'linattn_block_{n}_{c}'] = device_ms(
            lambda: lb.linattn_block(xs, g, *ws, wout, g, g, dim_head=32))
    for n, c in attn_shapes:
        xs = torch.randn((batch_size, n, c), generator=gen,
                         device=device).to(torch.bfloat16)
        wqkv = (torch.randn((c, 384), generator=gen, device=device)
                * c ** -0.5).to(torch.bfloat16)
        wout = (torch.randn((128, c), generator=gen, device=device)
                * 128 ** -0.5).to(torch.bfloat16)
        g = torch.ones(c, device=device)
        device_split(f'attn_block_{n}_{c}',
                     lambda: ab.attn_block(xs, g, wqkv, wout, g))
    for n in linear_shapes:
        qkv = torch.randn((batch_size, n, 384), generator=gen,
                          device=device).to(torch.bfloat16)
        device_split(f'linear_attention_qkv_{n}',
                     lambda: la.linear_attention_qkv(qkv))
    for n in flash_shapes:
        qkv = torch.randn((batch_size, n, 3, 4, 32), generator=gen,
                          device=device).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        standalone[f'attention_{n}'] = device_ms(lambda: at.attention(q, k, v))
        standalone[f'sdpa_{n}'] = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))
    res['standalone_device_ms'] = standalone
    res['standalone_by_device_kernel'] = split
    res['ok'] = ok
    return res


def summary(kernels, slice_, slice_pallas):
    """One entry per kernel: ``launches``, its launches on the two sampling
    paths (each counted from 0 around that run alone), the largest error over
    its cases, and the times and bound of its first bfloat16 case.
    ``drive_launches`` counts launches outside any path: no module calls
    ``linear_attention``, so its ``launches`` is 0 and the one direct call of
    ``slice_pallas`` stands there."""
    launches = {name: slice_['launches'][name] + slice_pallas['launches'][name]
                for name in KERNELS}
    drive = {**dict.fromkeys(KERNELS, 0),
             'linear_attention': slice_pallas['entry_pair']['drive_launches']}
    out = []
    for name, (replaces, source, _, _) in KERNELS.items():
        mine = [c for c in kernels['cases'] if c['kernel'] == name]
        main = next(c for c in mine if c['dtype'] == 'bfloat16')
        out.append({'name': name, 'route': 'cuda',
                    'source': f'srgd_tpu_torch/csrc/{source}',
                    'replaces': replaces, 'launches': launches[name],
                    'drive_launches': drive[name],
                    'max_abs_err': max(c['max_abs_err'] for c in mine),
                    'max_rms_err': max(c['rms_err'] for c in mine),
                    'ms': main['ms'], 'plain_ms': main['plain_ms'],
                    'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
                    'library_ms': main['library_ms'],
                    'shape': {k: main[k] for k in ('b', 'n', 'c')}})
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
    todo = [phase_kernels, phase_slice, phase_slice_pallas, phase_bench]
    if '--profile' in sys.argv[1:]:
        todo.append(phase_profile)
    phases = []
    for phase in todo:
        phases.append(phase(torch, device))
        emit(phases[-1])
        torch.cuda.synchronize()
    kernels, slice_, slice_pallas = phases[:3]
    table = summary(kernels, slice_, slice_pallas)
    emit(table)
    failed = [p['phase'] for p in phases if not p['ok']]
    # a kernel no module calls is held to its direct drive instead
    unlaunched = [k['name'] for k in table['kernels']
                  if k['launches' if k['name'] not in OFF_PATH
                       else 'drive_launches'] < 1]
    if failed or unlaunched:
        print(f'chip_smoke: failed phases {failed}; kernels never launched '
              f'{unlaunched}', file=sys.stderr)
        return 1
    print(dev['nvidia_smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
