#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and power limit (nvidia-smi), CUDA version; TF32
   is switched off for matmuls and convolutions.
2. build: the CUDA kernels are compiled from ``srgd_tpu_torch/csrc``.
3. kernels: each of the six TPU kernels' ports against its plain PyTorch version at every
   flagship shape (b = 8; ``groupnorm_silu`` with and without FiLM; every
   kernel's largest shape also at b = 16, the batch class CFG gives) in
   bfloat16 and float32 (the four tensor-core kernels, ``attention``,
   ``linattn_block``, ``attn_block`` and the linear-attention cores, also at
   ragged n, where their 64-row tiles end in a masked tail), with max-abs
   and rms error (``groupnorm_silu`` also called twice on the same inputs,
   which must give the same bits), the
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
6. deep_cache: DeepCache at depth 2 through both nets. One full forward with
   ``return_cache`` and one forward on that cache (b = 8 tiles) must agree
   within the bf16 kernel bound (whether their bits matched is printed), the
   full forward must launch what the net routes to (default 6 / 3,
   ``use_pallas`` 38 / 6 / 3) and the cached one what its two shallow stages
   and the final block route to (4 / 0 and 18 / 4 / 0); a tiled ancestral run
   with class CFG at interval 2 (4 steps on the 768 canvas) must run the full
   and cached forwards ``refresh_mask`` gives, each with its launches, and
   pass the output checks; and the ms of a full and of a cached forward.
7. families: the shipped YAML with ``model`` set, on the default net with
   class CFG: ``conditional_gaussian`` (``learned_sinusoidal_cond: false``)
   through tiled DDIM, ``conditional_elucidated`` through tiled Heun and
   untiled DPM++ on one 256 tile, and the continuous family on the learned
   log-SNR schedule; the output checks, and 6 / 3 launches every forward.
8. serve: the port's serving daemon (``srgd_tpu_torch.serve``) in-process
   from the serving YAML (w8a8 cleared, bf16, default net, random weights,
   DDIM eta 1 at 25 steps) with its HTTP front-end on 127.0.0.1: two seeded
   labelled requests give the same PNG bytes at 4x, two seedless requests
   with labels 0 and 1 sample as one batch, a guided request changes the
   pixels, guidance on both axes and a garbage body get 400, /healthz
   answers busy within 2 s mid-sample, /stats and /metrics agree, every
   forward launched 6 / 3, the forwards are those of the tile geometry,
   device memory does not grow across requests, and a watch pass writes
   two outputs as one batch; ms and forwards per request alone and
   coalesced, output MPix/s and peak device memory.
9. train: ``srgd_tpu_torch.train.loop.main`` on the training YAML
   (``conf/trained_evidence_dim128_synth.yaml``: dim 128 at full width,
   256-px crops, batch 8, bf16 over float32 parameters, AdamW, EMA) over 40
   procedural 320-px PNGs made from a seed: 6 steps with a checkpoint every
   3, then a second call resumes to step 8. Every loss finite; the
   gradients of the first linear attention's ``to_qkv`` and of
   ``init_conv`` finite and not zero; 6 / 3 launches every train forward
   and none in the backward; the step counter, optimizer state and
   best_score come back; the checkpoint samples through
   ``factory.get_model``; a ``use_pallas`` net's backward raises; both
   ``autograd.Function``s' gradients equal the plain version's at their
   flagship shapes (b = 8, bf16 and f32); ``remat_unet`` gives the same
   first loss with less peak memory. ms per train step, the loop's phase
   breakdown, the backward recompute's ms per step (profiler ranges), peak
   memory and the data path (native or PIL).
10. int8: W8A8 inference on the serving YAML at full width (``quantize:
   w8a8`` at 512 channels, bf16, random weights from a seed). ``int8_conv``
   (the s8 x s8 -> s32 implicit GEMM that replaces QuantConv's XLA conv) at
   every distinct shape of one b = 8 forward, bit for bit against its plain
   version (bf16 output and int32 accumulators) by both of its kernels (the
   Hopper ``wgmma`` kernel, which every net shape takes, and the first
   ``mma.sync`` one), with the ms of each, the plain version's, the bound
   and a bf16 ``F.conv2d`` of the same shape (a different function, for
   scale), and at ragged shapes (``RAGGED_INT8_SHAPES``); ``act_amax`` and
   ``quantize_act`` at every distinct activation of the forward, bit for
   bit (whole-tensor and per-channel amax; dynamic, calibrated and smoothed
   divisors), with their ms, the plain versions', the bound, the amax's
   ``torch.linalg.vector_norm`` and QuantConv's PyTorch-op chain that they
   replace; one forward of the bf16 net and of the int8 net with dynamic
   and with calibrated scales, each int8 one within 0.10 of the bf16 one
   relative to its largest value, launching every QuantConv's conv (all on
   the Hopper kernel) and quantize once and, dynamic only, its amax, the
   linear attentions but the quantized one through ``linattn_block``, its
   core through ``linear_attention_qkv`` and the full attentions through
   ``attn_block``; ``srgd_tpu_torch.infer --precision int8
   --quant_calibrate --quant_calibrate_cache`` twice on a 128-px input (the
   second run loads the cache); and one ``--precision int8`` request through
   ``srgd_tpu_torch.serve``.
11. mesh: the device mesh (``srgd_tpu_torch.parallel``, ``--mesh``) with
   one rank per visible card through NCCL (in this process when there is
   one card): phase 4's sampler through the mesh, bit-equal to the plain
   sampler at every world, 6 / 3 launches every forward, and the ms per
   step with and without the mesh path; one train step of the training
   YAML at ``mesh_shape`` (N, 1) against one device (its loss at rtol 1e-4,
   Adam's first moment, a tenth of the step's gradient, within the bf16
   tolerance in L2, the parameters within Adam's 2 lr), then a resume of
   each to step 2 (at world 1 both losses at rtol 1e-4; whether the bits
   matched is printed; at world N the same again in float32, for what the
   bf16 rounding of the split batch's gradients does); one ``python -m
   srgd_tpu_torch.infer --mesh N,1`` subprocess writing its PNG; and one
   ``python -m srgd_tpu_torch.serve --mesh N,1`` daemon answering a request
   and exiting 0 on SIGTERM. On a
   machine of more cards only this phase uses them: the others run on
   card 0 (``train`` with ``--device cuda:0``).
12. quality: the evaluation entry points (``srgd_tpu_torch.tools``) at full
   width. (a) ``quality_probe.main`` at QP_LR 128 (a 512 canvas), 4 steps,
   QP_QMIN 0, in float32, bfloat16, w8a8dyn, w8a8 and bfloat16+dc2.2 on
   seeded random weights: every output finite, in [0, 1], of the right
   shape, every line parsed, every forward launching what its net routes
   to (6 / 3 in float32 as in bf16, 4 / 0 cached; the w8a8 nets'
   QuantConvs, quantized linear attentions' cores and whole blocks left);
   (b) ``evidence_eval.main`` on the training YAML from a ``save_params``
   checkpoint of seeded weights at EV_HR 256, 4 steps, with EV_CFG: its
   three tables, every number finite, 6 / 3 a forward; (c) both debug
   captures in phase 4's sampler and in each of phase 7's runs, against a
   run without them: the same bits, 1 + steps - start frames, the last
   frame unnormalizing to the output, the frames' device bytes; (d)
   ``tools.flagship_ckpt``: the reference-format ``.pth`` of 137,569,939
   parameters loads with no key missing or left over and ``python -m
   srgd_tpu_torch.infer`` writes the x4 PNG, which the same ``.pth``
   sampled in this process with the CLI's options repeats bit for bit. Its
   launches count among the main paths'.
13. convert: checkpoint conversion (``srgd_tpu_torch.checkpoint.convert``)
   at full width. The flagship ``.pth`` converted forward to a float32 and a
   bfloat16 directory, each holding the ``.pth``'s weights (bfloat16 rounded
   once); the CLI (``srgd_tpu_torch.infer.main`` in this process: 2 steps,
   one 16-px PNG, the default net) on the ``.pth``, on the float32
   directory (the same PNG bits), on the ``.pth`` under ``param_dtype:
   bfloat16`` and on the bfloat16 directory (the same bits again); a 2-step
   ``train.loop.main`` run of the training YAML, its trainer directory
   exported with ``--reverse`` (float32 ``model.`` entries equal to its EMA
   weights) and the CLI on both (the same PNG). Every forward launches
   6 / 3; the seconds of each step and the files' bytes.
14. bench: one U-Net forward (b = 8 tiles of 256 px) and one even and one odd
   step of a 512-px LR input (2304 canvas), for the default net and for the
   ``use_pallas`` net.
15. profile, only with ``--profile``, in a fresh child process (``python3
   chip_smoke.py --profile-only``): ``torch.profiler`` over three forwards of
   each net (default, ``use_pallas`` and the int8 net of phase 10, which
   must launch none of PyTorch's abs or round kernels), device time
   per kernel name, per kernel of the port (summed over all its launches and
   shapes, and its device kernels per forward) and per group of PyTorch's
   own kernels, and the device time of single calls of ``linattn_block``,
   ``attn_block``, ``linear_attention_qkv``, ``groupnorm_silu`` (one device
   kernel a call) and ``attention`` beside SDPA's.

Every launch count is set to 0 just before a path is driven and read just
after. Then the kernel summary and, last, the device line. Exits non-zero,
before building anything, when no CUDA device is visible, and on any failure.
There is no CPU mode; the phase functions take a device and sizes so the
tests can rehearse them at a tiny size on the CPU.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import signal
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
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12, 'int8': 1979e12}

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
    # not Pallas kernels: the XLA int8 conv of QuantConv and its activation
    # amax and quantize (phase int8)
    'int8_conv': ('srgd_tpu/nn/quant.py:165', 'int8_conv.cu', 'int8_conv',
                  'launches'),
    'act_amax': ('srgd_tpu/nn/quant.py:153', 'quant_act.cu', 'quant_act',
                 'launches_amax'),
    'quantize_act': ('srgd_tpu/nn/quant.py:160', 'quant_act.cu', 'quant_act',
                     'launches'),
}
# the phases whose launches count as the main paths' in the summary
MAIN_PATHS = ('slice', 'slice_pallas', 'deep_cache', 'families', 'serve',
              'train', 'int8', 'mesh', 'quality', 'convert')
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
    from srgd_tpu_torch.kernels import int8_conv
    int8_conv.launches_wgmma = int8_conv.launches_mma = 0


def read_counts() -> dict:
    return {name: getattr(*_counter(name)) for name in KERNELS}


def _nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device(torch):
    smi = _nvidia_smi()
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
            # groupnorm_silu adds its partials in a fixed order: a second
            # call on the same inputs gives the same bits
            repeat = (bool(torch.equal(case['kern']().float(), got))
                      if kind == 'groupnorm_silu' else None)
            if device.type == 'cuda':
                torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rms = (got - want).square().mean().sqrt().item()
            ref_max = want.abs().max().item()
            ok, tol = _within(err, ref_max, dtype, torch)
            ok = ok and bool(torch.isfinite(got).all()) and repeat is not False
            del got, want
            by_bytes = case['bytes'] / HBM_BYTES_PER_S * 1e3
            by_ops = (case['flops']
                      / PEAK_FLOPS[case.get('flops_dtype', name)] * 1e3)
            library = case.get('library')
            cases.append({
                'kernel': kind, **shape, 'b': batch, 'dtype': name,
                'max_abs_err': err, 'rms_err': rms, 'tol': tol, 'ok': ok,
                'bitwise_repeat': repeat,
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
                   sampler='ancestral', ddim_eta=0.0, deep_cache_interval=0,
                   deep_cache_depth=2, **flags):
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
                               ddim_eta=ddim_eta,
                               deep_cache_interval=deep_cache_interval,
                               deep_cache_depth=deep_cache_depth)


SHIPPED_YAML = 'conf/conditional_continuous_linear_df8kost_dim128.yaml'


def build_family(torch, device, model, *, seed=0, **overrides):
    """The shipped YAML with ``model`` and ``overrides`` (Config fields)
    set, through the port's factory: random weights from ``seed``, bf16."""
    import os

    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.factory import get_model
    conf = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    SHIPPED_YAML))
    conf.model, conf.seed, conf.compute_dtype = model, seed, 'bfloat16'
    for key, value in overrides.items():
        setattr(conf, key, value)
    return get_model(conf, ckpt_path='', device=device)[0]


def _per_forward(mods) -> dict:
    """Launches of each kernel that one pass through the modules ``mods``
    makes: one per module that routes to it."""
    from srgd_tpu_torch.nn.layers import Attention, Block, LinearAttention
    from srgd_tpu_torch.nn.quant import QuantConv
    blocks = [m for m in mods if isinstance(m, Block)]
    linear = [m for m in mods if isinstance(m, LinearAttention)]
    full = [m for m in mods if isinstance(m, Attention)]
    # bf16 with `fused` keeps the whole-block kernel under use_pallas
    to_flash = [m for m in full if m.use_pallas and not m.fused]
    # a quantized linear attention leaves linattn_block for the submodules
    unfused = [m for m in linear if m.use_pallas or m.quant is not None]
    return {
        'linattn_block': len(linear) - len(unfused),
        'attn_block': len(full) - len(to_flash),
        'groupnorm_silu': sum(m.use_pallas for m in blocks),
        'attention': len(to_flash),
        'linear_attention': 0,
        'linear_attention_qkv': len(unfused),
        # every QuantConv once (the nets here have no quant + use_pallas
        # linear attention, whose to_out may run in float), and its
        # activation's amax where no statistic is recorded
        'int8_conv': sum(isinstance(m, QuantConv) for m in mods),
        'act_amax': sum(isinstance(m, QuantConv) and _dynamic(m)
                        for m in mods),
        'quantize_act': sum(isinstance(m, QuantConv) for m in mods),
    }


def _dynamic(m) -> bool:
    """Whether QuantConv ``m`` takes its activation's amax each call."""
    stat = m.act_amax_ch if m.smooth_alpha > 0 else m.act_scale
    return m.calibrating or stat is None


def _cached_per_forward(net, depth: int) -> dict:
    """Launches of a DeepCache forward at ``depth``: the encoder and decoder
    stages below it and the final block; no mid block."""
    stages = len(net.downs)
    mods = [m for part in (*net.downs[:depth], *net.ups[stages - depth:],
                           net.final_res_block) for m in part.modules()]
    return _per_forward(mods)


def _expected_launches(net, forwards: int, cached: int = 0,
                       depth: int = 0) -> tuple[dict, dict]:
    """Launches of each kernel that ``forwards`` U-Net forwards of ``net``,
    ``cached`` of them DeepCache forwards at ``depth``, make, and that one
    full forward makes."""
    per_forward = _per_forward(list(net.modules()))
    per_cached = _cached_per_forward(net, depth) if cached else per_forward
    return {k: v * (forwards - cached) + per_cached[k] * cached
            for k, v in per_forward.items()}, per_forward


def _counted(torch, device, wrapper, run):
    """``run()`` with the launch counts set to 0 just before and read just
    after, and the U-Net forwards counted, those on a DeepCache cache apart.
    Returns (out, forwards, cached_forwards, launches, seconds)."""
    forwards = cached = 0
    net_forward = wrapper.net.forward

    def counted(*a, **k):
        nonlocal forwards, cached
        forwards += 1
        cached += k.get('deep_cache') is not None
        return net_forward(*a, **k)

    wrapper.net.forward = counted
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = run()
        if device.type == 'cuda':
            torch.cuda.synchronize()
    finally:
        wrapper.net.forward = net_forward
    seconds = time.perf_counter() - t0
    return out, forwards, cached, read_counts(), seconds


def _sample_counted(torch, device, wrapper, cond, label, *, steps, tile_size,
                    batch_size, noise_seed, start=0):
    """One tiled class-CFG sampling run (steps ``start`` .. ``steps`` - 1 of
    ``steps``) through ``_counted``. Returns (out, forwards, launches,
    seconds); DeepCache forwards are counted by ``_counted`` itself."""
    from srgd_tpu_torch.diffusion.base import GeneratorNoise
    out, forwards, _, launches, seconds = _counted(
        torch, device, wrapper, lambda: wrapper.tiled_sample(
            cond, label, batch_size=batch_size, tile_size=tile_size,
            class_cond_scale=2.0, num_sample_steps=steps,
            generation_start_steps=start,
            noise=GeneratorNoise(noise_seed, device)))
    return out, forwards, launches, seconds


def _slice_checks(torch, device, wrapper, out, size, forwards, launches,
                  cached=0, depth=0):
    # a CPU rehearsal runs the plain versions, which never count
    on_card = device.type == 'cuda'
    expected, per_forward = _expected_launches(
        wrapper.net, forwards * on_card, cached * on_card, depth)
    checks = {
        'shape': list(out.shape) == [1, size, size, 3],
        'finite': bool(torch.isfinite(out).all()),
        'in_unit_range': bool((out >= 0).all() and (out <= 1).all()),
        'forwards': forwards > 0,
    }
    for name in KERNELS:
        checks[f'{name}_launches'] = launches[name] == expected[name]
    return checks, per_forward


def _forward_inputs(torch, device, batch_size, tile_size, seed):
    """(x, t, the forward's keywords) of one U-Net forward on a tile batch,
    from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tile = (batch_size, 3, tile_size, tile_size)
    fwd = dict(cond=torch.rand(tile, generator=gen, device=device) * 2 - 1,
               class_label=torch.arange(batch_size, device=device) % 3)
    x = torch.randn(tile, generator=gen, device=device)
    t = torch.rand(batch_size, generator=gen, device=device)
    return x, t, fwd


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
    x, t, fwd = _forward_inputs(torch, device, batch_size, tile_size, seed + 5)
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


def _expected_forwards(shape, tile_size, batch_size, steps, mask):
    """(full, cached) U-Net forwards of a tiled run of ``steps`` steps on a
    condition of ``shape`` (canvases, height, width): one per tile chunk of
    the step's grid parity, the tiles of all canvases pooled, cached where
    the per-parity refresh ``mask`` is False."""
    from srgd_tpu_torch.diffusion.base import pick_chunk
    from srgd_tpu_torch.tiling import make_geometry
    canvases, height, width = shape
    geom = make_geometry(height, width, tile_size)
    chunks = [-(-n // pick_chunk(n, batch_size))
              for n in (geom.n_tiles_even * canvases,
                        geom.n_tiles_odd * canvases)]
    full = sum(chunks[i % 2] for i in range(steps) if mask[i // 2])
    cached = sum(chunks[i % 2] for i in range(steps) if not mask[i // 2])
    return full, cached


def _launched(torch, device, fn):
    """(fn(), the launches it made)."""
    reset_counts()
    out = fn()
    if device.type == 'cuda':
        torch.cuda.synchronize()
    return out, read_counts()


def phase_deep_cache(torch, device, *, size=512, tile_size=256, steps=4,
                     batch_size=8, depth=2, seed=0, forward_iters=5, **net_kw):
    """DeepCache at ``depth`` through both kernel sets. For each net: one
    full forward with ``return_cache`` and one cached forward on that cache
    (b = ``batch_size`` tiles), held to each other within the bf16 kernel
    bound, with whether their bits matched, and the launches of each; a
    tiled ancestral run with class CFG at interval 2 whose full and cached
    forwards follow ``refresh_mask`` and launch what their stages route to;
    and the ms of a full and of a cached forward."""
    from srgd_tpu_torch.diffusion.base import GeneratorNoise, refresh_mask
    on_card = device.type == 'cuda'
    cond, label = _slice_inputs(torch, device, size, seed)
    mask = refresh_mask('', 2, (steps + 1) // 2 + 1)
    want_forwards = _expected_forwards((1, size, size), tile_size, batch_size,
                                       steps, mask)
    res = {'phase': 'deep_cache', 'depth': depth, 'interval': 2,
           'steps': steps, 'nets': {},
           'launches': dict.fromkeys(KERNELS, 0)}
    oks = []
    for name, flags in (('default', {}), ('use_pallas', PALLAS_FLAGS)):
        wrapper = build_flagship(torch, device, seed=seed, deep_cache_interval=2,
                                 deep_cache_depth=depth, **flags, **net_kw)
        net = wrapper.net
        x, t, fwd = _forward_inputs(torch, device, batch_size, tile_size,
                                    seed + 6)
        with torch.inference_mode():
            _, full_launches = _launched(
                torch, device, lambda: net(x, t, **fwd))
            (out, cache), cache_launches = _launched(
                torch, device, lambda: net(x, t, **fwd, cache_depth=depth,
                                           return_cache=True))
            cached, cached_launches = _launched(
                torch, device, lambda: net(x, t, **fwd, cache_depth=depth,
                                           deep_cache=cache))
        bitwise = bool(torch.equal(out, cached))
        diff = (out - cached).abs().max().item()
        tol = BF16_RTOL * out.abs().max().item()
        per_full = _per_forward(list(net.modules()))
        per_cached = _cached_per_forward(net, depth)
        scale = int(on_card)
        checks = {
            'fresh_cache_within_bf16_bound': bool(
                torch.isfinite(cached).all()) and diff <= tol,
            'full_forward_launches': full_launches == cache_launches == {
                k: v * scale for k, v in per_full.items()},
            'cached_forward_launches': cached_launches == {
                k: v * scale for k, v in per_cached.items()}}

        sampled, forwards, n_cached, launches, seconds = _counted(
            torch, device, wrapper, lambda: wrapper.tiled_sample(
                cond, label, batch_size=batch_size, tile_size=tile_size,
                class_cond_scale=2.0, num_sample_steps=steps,
                noise=GeneratorNoise(seed + 2, device)))
        run_checks, _ = _slice_checks(torch, device, wrapper, sampled, size,
                                      forwards, launches, n_cached, depth)
        checks.update(run_checks)
        checks['forwards_follow_refresh_mask'] = (
            (forwards - n_cached, n_cached) == want_forwards)
        for k in KERNELS:
            res['launches'][k] += launches[k]

        def timed(**kw):
            def run():
                with torch.inference_mode():
                    net(x, t, **fwd, **kw)
            return time_ms(torch, run, device, forward_iters)

        res['nets'][name] = {
            'ok': all(checks.values()), 'checks': checks,
            'fresh_cache_bitwise': bitwise, 'fresh_cache_max_abs_diff': diff,
            'tol': tol, 'cache_shape': list(cache.shape),
            'per_forward': per_full, 'per_cached_forward': per_cached,
            'forwards': forwards, 'cached_forwards': n_cached,
            'expected_forwards': list(want_forwards), 'launches': launches,
            'seconds': seconds, 'out_mean': sampled.mean().item(),
            'full_forward_ms': timed(),
            'cached_forward_ms': timed(cache_depth=depth, deep_cache=cache)}
        oks.append(res['nets'][name]['ok'])
        del wrapper, net, cache
    res['ok'] = all(oks)
    return res


def phase_families(torch, device, *, size=512, tile_size=256, batch_size=8,
                   seed=0, dpmpp_size=256, **conf_kw):
    """The other families and the learned schedule, each built from the
    shipped YAML with ``model`` set (and ``conf_kw``, which the tests use to
    shrink the net), on the default net with class CFG: tiled DDIM of
    ``conditional_gaussian`` (4 steps, ``learned_sinusoidal_cond: false``),
    tiled Heun of ``conditional_elucidated`` (4 steps) and its untiled
    DPM++ on one ``dpmpp_size`` tile (4 steps), and the continuous family on
    the learned log-SNR schedule (2 tiled steps). Every forward must launch
    what the default net routes to; every output must be finite, in [0, 1]
    and of the right shape."""
    from srgd_tpu_torch.diffusion.base import GeneratorNoise
    cond, label = _slice_inputs(torch, device, size, seed)
    small, _ = _slice_inputs(torch, device, dpmpp_size, seed + 7)
    # (model, Config overrides, runs: (name, steps, tiled))
    families = (
        ('conditional_gaussian', dict(learned_sinusoidal_cond=False),
         (('gaussian_ddim_tiled', 4, True),)),
        ('conditional_elucidated', {},
         (('elucidated_heun_tiled', 4, True), ('elucidated_dpmpp', 4, False))),
        ('conditional_continuous', dict(noise_schedule='learned'),
         (('continuous_learned_tiled', 2, True),)),
    )
    res = {'phase': 'families', 'runs': {},
           'launches': dict.fromkeys(KERNELS, 0)}
    for model, over, runs in families:
        wrapper = build_family(torch, device, model, seed=seed, **over,
                               **conf_kw)
        for name, steps, tiled in runs:
            noise = GeneratorNoise(seed + 2, device)
            if tiled:
                def run():
                    return wrapper.tiled_sample(
                        cond, label, batch_size=batch_size,
                        tile_size=tile_size, class_cond_scale=2.0,
                        num_sample_steps=steps, noise=noise)
            else:
                def run():
                    return wrapper.sample(small, label, class_cond_scale=2.0,
                                          num_sample_steps=steps, noise=noise)
            out, forwards, _, launches, seconds = _counted(torch, device,
                                                           wrapper, run)
            checks, per_forward = _slice_checks(
                torch, device, wrapper, out, size if tiled else dpmpp_size,
                forwards, launches)
            for k in KERNELS:
                res['launches'][k] += launches[k]
            res['runs'][name] = {
                'ok': all(checks.values()), 'checks': checks,
                'wrapper': type(wrapper).__name__, 'steps': steps,
                'forwards': forwards, 'launches': launches,
                'per_forward': per_forward, 'seconds': seconds,
                'out_mean': out.mean().item()}
        del wrapper
    res['ok'] = all(r['ok'] for r in res['runs'].values())
    return res


SERVING_YAML = 'conf/conditional_continuous_linear_df8kost_dim128_tpu_serving.yaml'


def _http(port, method, path, body=None):
    """(status, content type, body) of one request to the local daemon."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.getheader('Content-Type'), r.read()
    finally:
        conn.close()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _png(w, h, seed):
    """A random w x h RGB image as PNG bytes."""
    import io

    import numpy as np
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format='PNG')
    return buf.getvalue()


def _decoded(body):
    import io

    import numpy as np
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(body)))


def phase_serve(torch, device, *, conf=SERVING_YAML, seeded=(96, 80),
                square=128, watch=(100, 60), lr_bucket=64, tile_size=256,
                batch_size=8, steps=25, window=0.5):
    """The port's serving daemon in-process: the serving YAML (w8a8
    cleared: the port serves bf16), random weights from its seed, the
    default net, the fast profile (DDIM, eta 1, ``steps`` steps), its HTTP
    front-end on 127.0.0.1 in a thread. Sizes are (w, h) of the LR inputs.
    Checks: two seeded labelled requests give the same bytes at 4x; two
    seedless requests with labels 0 and 1 sent at once sample as one batch;
    a guided request changes the pixels, guidance on both axes and a
    garbage body get 400; /healthz answers within 2 s, busy, while a
    seeded request samples; /stats and /metrics agree with the traffic;
    every forward launched what the default net routes to, and the forwards
    are those the tile geometry gives; device memory after the third seeded
    request equals that after the first; one watch pass writes two 4x
    outputs as one batch."""
    import gc
    import os
    import tempfile
    import threading

    import numpy as np
    from PIL import Image

    from srgd_tpu_torch.serve import Server, bucket_pad, parse_args
    on_card = device.type == 'cuda'
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.TemporaryDirectory()
    in_dir, out_dir = (os.path.join(work.name, d) for d in ('in', 'out'))
    os.makedirs(in_dir)

    def memory():
        """(bytes the caching allocator has handed out, the same without
        cuBLAS's cached workspaces). PyTorch keeps one workspace per cuBLAS
        handle and stream, and a handle per thread: the batch worker's
        first sample and a handler thread that starts while another still
        holds its handle each add one, whatever the request."""
        if not on_card:
            return 0, 0
        gc.collect()
        raw = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        return raw, torch.cuda.memory_allocated()

    mem_start = memory()
    args = parse_args([
        '-c', os.path.join(here, conf), '-m', '', '--mode', 'both',
        '--device', device.type, '--input_dir', in_dir, '--output_dir',
        out_dir, '--port', '0', '--lr_bucket', str(lr_bucket),
        '--tile_size', str(tile_size), '--batch_size', str(batch_size),
        '--test_label', '0', '--continuous_sampler', 'ddim', '--ddim_eta',
        '1.0', '--num_sample_steps', str(steps), '--coalesce_window',
        str(window), '--max_batch_images', '2', '--warmup_sizes',
        str(square)])
    server = Server(args)
    wrapper = server.sampler.wrapper
    httpd = server.make_http_server()
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def canvas(w, h):
        bw, bh = bucket_pad(Image.new('RGB', (w, h)), lr_bucket)[0].size
        return 4 * bh, 4 * bw

    forwards = 0
    net_forward = wrapper.net.forward

    def counted(*a, **k):
        nonlocal forwards
        forwards += 1
        return net_forward(*a, **k)

    checks, res = {}, {'phase': 'serve', 'steps': steps, 'port': port,
                       'card': _nvidia_smi() if on_card else None}
    try:
        traffic = ('served', 'errors', 'mpix')
        before = {k: server.stats[k] for k in traffic}
        server.warmup()
        checks['warmup_keeps_counters'] = before == {
            k: server.stats[k] for k in traffic}
        res['net'] = {'dtype': str(wrapper.net.dtype),
                      'sampler': wrapper.sampler, 'ddim_eta': wrapper.ddim_eta,
                      'model_info': server.model_info}
        checks['bf16_default_net'] = (
            wrapper.net.dtype == torch.bfloat16
            and server.model_info['precision'] == 'bf16'
            and not wrapper.net.downs[0][2].use_pallas)

        wrapper.net.forward = counted
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        want = []   # (canvases, height, width) of every sample run

        def timed(fn):
            f0, t0 = forwards, time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3, forwards - f0

        # same seed, same label: the same bytes (re-seeded per request)
        body = _png(*seeded, seed=1)
        path = '/v1/sr?seed=5&label=1'
        first, first_ms, _ = timed(lambda: _http(port, 'POST', path, body))
        mem_first = memory()
        second, alone_ms, alone_fw = timed(
            lambda: _http(port, 'POST', path, body))
        want += [(1, *canvas(*seeded))] * 2
        sr_size = (4 * seeded[0], 4 * seeded[1])
        checks['seeded_png_4x'] = all(
            r[0] == 200 and r[1] == 'image/png'
            and _decoded(r[2]).shape[1::-1] == sr_size for r in (first, second))
        checks['seeded_same_bytes'] = first[2] == second[2]

        # two seedless requests with labels 0 and 1 at once: one batch
        b0 = dict(server.batcher.stats)
        pair = [None, None]
        sq = [_png(square, square, seed=2 + i) for i in range(2)]

        def send(i):
            pair[i] = _http(port, 'POST', f'/v1/sr?label={i}', sq[i])

        def both():
            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        _, pair_ms, pair_fw = timed(both)
        want.append((2, *canvas(square, square)))
        checks['coalesced_one_batch'] = (
            server.batcher.stats['batches'] - b0['batches'] == 1
            and server.batcher.stats['batched_images']
            - b0['batched_images'] == 2)
        checks['coalesced_png_4x'] = all(
            r is not None and r[0] == 200
            and _decoded(r[2]).shape[:2] == (4 * square, 4 * square)
            for r in pair)
        checks['coalesced_outputs_differ'] = pair[0][2] != pair[1][2]

        # guidance steers the pixels; both axes and garbage are refused
        guided = _http(port, 'POST', path + '&class_cond_scale=2', body)
        want.append((1, *canvas(*seeded)))
        checks['guided_changes_pixels'] = guided[0] == 200 and not (
            np.array_equal(_decoded(guided[2]), _decoded(first[2])))
        both_axes = _http(port, 'POST',
                          '/v1/sr?cond_scale=1.5&class_cond_scale=1.5', body)
        garbage = _http(port, 'POST', '/v1/sr', b'garbage')
        checks['both_axes_400'] = both_axes[0] == 400
        checks['garbage_400'] = garbage[0] == 400

        # health while a seeded request samples (the third one)
        third = []
        busy = threading.Thread(
            target=lambda: third.append(_http(port, 'POST', path, body)))
        busy.start()
        deadline = time.time() + 60
        while not server.lock.locked() and time.time() < deadline:
            time.sleep(0.001)
        health, health_ms, _ = timed(lambda: _http(port, 'GET', '/healthz'))
        busy.join(timeout=600)
        want.append((1, *canvas(*seeded)))
        health_json = json.loads(health[2])
        checks['healthz_busy_within_2s'] = (
            health[0] == 200 and health_json['busy'] is True
            and health_ms < 2000)
        checks['third_seeded_same_bytes'] = bool(third) and third[0][2] == first[2]
        mem_third = memory()
        checks['no_memory_growth'] = mem_third[1] == mem_first[1]

        # the counters: 6 images served, 2 requests refused
        stats = json.loads(_http(port, 'GET', '/stats')[2])
        metrics = {line.split()[0]: float(line.split()[1])
                   for line in _http(port, 'GET', '/metrics')[2].decode()
                   .splitlines() if not line.startswith('#')}
        checks['counters_agree'] = (
            stats['served'] == metrics['srgd_served'] == 6
            and stats['errors'] == metrics['srgd_errors'] == 2
            and stats['batches'] == metrics['srgd_batches']
            and stats['sample_inflight_seconds']
            == metrics['srgd_sample_inflight_seconds'] == 0
            and metrics['srgd_busy'] == 0)

        # one watch pass over two same-geometry files: one batch
        for i in range(2):
            with open(os.path.join(in_dir, f'w{i}.png'), 'wb') as fp:
                fp.write(_png(*watch, seed=5 + i))
        written, watch_ms, watch_fw = timed(server.process_dir_once)
        want.append((2, *canvas(*watch)))
        outs = sorted(os.listdir(out_dir))
        checks['watch_one_batch'] = (
            written == 2 and server.stats.get('watch_batches') == 1
            and outs == ['w0_out.png', 'w1_out.png']
            and all(Image.open(os.path.join(out_dir, o)).size
                    == (4 * watch[0], 4 * watch[1]) for o in outs))

        if on_card:
            torch.cuda.synchronize()
        launches = read_counts()
    finally:
        wrapper.net.forward = net_forward
        httpd.shutdown()
        httpd.server_close()
        server.batcher.shutdown()
        work.cleanup()

    mask = np.ones(steps, bool)
    expected_forwards = sum(
        _expected_forwards(s, tile_size, batch_size, steps, mask)[0]
        for s in want)
    expected, per_forward = _expected_launches(wrapper.net,
                                               forwards * on_card)
    checks['forwards_follow_geometry'] = forwards == expected_forwards
    for name in KERNELS:
        checks[f'{name}_launches'] = launches[name] == expected[name]
    out_mpix = (sr_size[0] * sr_size[1]) / 1e6
    res.update({
        'ok': all(checks.values()), 'checks': checks,
        'forwards': forwards, 'expected_forwards': expected_forwards,
        'launches': launches, 'per_forward': per_forward,
        'first_request_ms': first_ms,
        'alone': {'ms_per_request': alone_ms, 'forwards_per_request': alone_fw,
                  'canvas': list(canvas(*seeded)),
                  'out_mpix_per_s': out_mpix / alone_ms * 1e3},
        'coalesced': {'ms_per_request': pair_ms / 2,
                      'forwards_per_request': pair_fw / 2,
                      'canvas': list(canvas(square, square)),
                      'out_mpix_per_s': 2 * (4 * square) ** 2 / 1e6
                      / pair_ms * 1e3},
        'watch': {'ms': watch_ms, 'forwards': watch_fw,
                  'canvas': list(canvas(*watch))},
        'healthz_ms_while_busy': health_ms,
        'memory_allocated_before_server': mem_start,
        'memory_allocated_after_first': mem_first,
        'memory_allocated_after_third': mem_third,
        'max_memory_allocated': (torch.cuda.max_memory_allocated()
                                 if on_card else None),
        'stats': stats})
    return res


def _int8_wrapper(torch, device, conf, quantize, min_channels, seed):
    """The serving YAML through the port's factory, bf16, random weights
    from ``seed``: quantize 'none' or 'w8a8' at ``min_channels``."""
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.factory import get_model
    c = load_config(conf)
    c.seed, c.compute_dtype = seed, 'bfloat16'
    c.quantize, c.quantize_min_channels = quantize, min_channels
    return get_model(c, ckpt_path='', device=device)[0]


def _conv_shapes(torch, net, run):
    """((b, h, w, cin, cout, ks), calls) of every QuantConv call in ``run()``,
    in first-call order."""
    from srgd_tpu_torch.nn.quant import quant_convs
    calls = {}

    def hook(m, inputs, _):
        b, c, h, w = inputs[0].shape
        key = (b, h, w, c, m.out_channels, m.kernel_size[0])
        calls[key] = calls.get(key, 0) + 1

    handles = [m.register_forward_hook(hook) for _, m in quant_convs(net)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return list(calls.items())


# (b, h, w, cin, cout, ks) of int8_conv beside the net's shapes: ragged M,
# Cout and K tails, a Cin under one 16-byte piece, image widths that do not
# divide a 128-pixel tile; both kernels are held to the plain version here
RAGGED_INT8_SHAPES = ((3, 7, 9, 40, 200, 3), (2, 5, 11, 48, 130, 1),
                      (1, 3, 3, 3, 5, 3), (2, 6, 10, 32, 72, 3))
# ((b, h, w, cin, cout, ks), calls) of the 25 QuantConvs of one int8 forward
# of the serving YAML at 512 channels, b = 8 tiles of 256 px (phase int8
# reads them off the net; kernel_ab.py times them)
INT8_NET_SHAPES = (
    ((8, 32, 32, 512, 512, 3), 4), ((8, 32, 32, 512, 1024, 3), 1),
    ((8, 32, 32, 1024, 1024, 3), 6), ((8, 32, 32, 1536, 1024, 3), 2),
    ((8, 32, 32, 1536, 1024, 1), 2), ((8, 32, 32, 1024, 2048, 1), 1),
    ((8, 64, 64, 768, 512, 3), 2), ((8, 64, 64, 512, 512, 3), 2),
    ((8, 64, 64, 768, 512, 1), 2), ((8, 64, 64, 512, 384, 1), 1),
    ((8, 64, 64, 128, 512, 1), 1), ((8, 64, 64, 512, 1024, 1), 1))


def int8_case(torch, device, shape, gen):
    """int8_conv at one shape (bf16 output, as in the net) against its plain
    version: the calls by route ('kern' the one the shape takes, 'mma' the
    first, ``mma.sync`` kernel), the int32 accumulators, a bf16 conv of the
    same shape, and the bytes and operations of the function."""
    import torch.nn.functional as F

    from srgd_tpu_torch.kernels import int8_conv as ic
    b, h, w, cin, cout, ks = shape
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                       device=device, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, ks, ks, cin), generator=gen,
                       device=device, dtype=torch.int8)
    scale = torch.rand(cout, generator=gen, device=device) * 1e-4
    bias = torch.randn(cout, generator=gen, device=device)
    kw = dict(padding=ks // 2, out_dtype=torch.bfloat16)
    acc = dict(padding=ks // 2, out_dtype=torch.int32)
    # a bf16 convolution of the same shape: another function, for scale
    xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
    wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    m, k = b * h * w, ks * ks * cin
    return {
        # (a checkout from before the Hopper kernel has one route)
        'route': (ic.route(cin, ks, xq.data_ptr(), wq.data_ptr())
                  if hasattr(ic, 'route') else 'mma'),
        'kern': lambda: ic.int8_conv(xq, wq, scale, bias, **kw),
        'mma': lambda: ic.int8_conv(xq, wq, scale, bias, kernel='mma', **kw),
        'plain': lambda: ic.int8_conv_plain(xq, wq, scale, bias, **kw),
        'acc': lambda: ic.int8_conv(xq, wq, **acc),
        'acc_mma': lambda: ic.int8_conv(xq, wq, kernel='mma', **acc),
        'acc_plain': lambda: ic.int8_conv_plain(xq, wq, **acc),
        'bf16_conv': lambda: F.conv2d(xb, wb, bias.to(torch.bfloat16),
                                      padding=ks // 2),
        # xq and wq read once, scale and bias, the bf16 output written once
        'bytes': m * cin + cout * k + 8 * cout + 2 * m * cout,
        'ops': 2 * m * cout * k,
    }


def quant_case(torch, device, shape, gen):
    """``act_amax`` and ``quantize_act`` on one bf16 activation (b, h, w, c)
    NHWC, a few channels 30x the others (SmoothQuant's outliers), against
    their plain versions: the divisors of a dynamic scale, of a calibrated
    one half as large (so that codes clip) and of a smoothed per-channel one
    (s_c * s_x with alpha 0.5); the PyTorch-op chain the kernels replace;
    ``torch.linalg.vector_norm`` at ord inf, the one library call that
    computes the amax; and the bytes of each function."""
    from srgd_tpu_torch.kernels import quant_act as qa
    b, h, w, c = shape
    wide = torch.where(torch.arange(c, device=device) % 97 == 5, 30.0, 1.0)
    x = (torch.randn((b, h, w, c), generator=gen, device=device)
         * wide).to(torch.bfloat16)
    s_dyn = qa.act_amax_plain(x) / 127.0 + 1e-12
    a_c = qa.act_amax_plain(x, per_channel=True)
    w_c = torch.rand(c, generator=gen, device=device) + 0.1
    s_c = a_c ** 0.5 * w_c ** -0.5
    div_ch = s_c * (torch.amax(a_c / s_c) / 127.0 + 1e-12)
    xc = x.permute(0, 3, 1, 2)      # the net's NCHW view, channels_last

    def chain():
        # QuantConv's dynamic quantize before the kernels, op for op
        xf = xc.float()
        s = torch.amax(torch.abs(xf)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8)
        return q.contiguous(memory_format=torch.channels_last)

    n = x.numel()
    return {
        'amax': (lambda: qa.act_amax(x), lambda: qa.act_amax_plain(x)),
        'amax_per_channel': (lambda: qa.act_amax(x, per_channel=True),
                             lambda: qa.act_amax_plain(x, per_channel=True)),
        'library_amax': lambda: torch.linalg.vector_norm(
            x, float('inf'), dtype=torch.float32),
        'quantize': {name: (lambda d=d: qa.quantize_act(x, d),
                            lambda d=d: qa.quantize_act_plain(x, d))
                     for name, d in (('dynamic', s_dyn),
                                     ('calibrated', s_dyn * 0.5),
                                     ('smoothed', div_ch))},
        'dynamic_pair': lambda: qa.quantize_act(
            x, qa.act_amax(x) / 127.0 + 1e-12),
        'chain': chain,
        # bf16 read once; the amax's one float written, the codes' int8
        'bytes_amax': 2 * n + 4, 'bytes_quantize': 3 * n + 4,
    }


def phase_int8(torch, device, *, conf=SERVING_YAML, min_channels=512,
               batch_size=8, tile_size=256, cal_batch=4, cli_size=128,
               cli_steps=2, serve_size=64, serve_steps=4, iters=5,
               forward_iters=3, ragged_shapes=RAGGED_INT8_SHAPES, seed=0):
    """W8A8 int8 inference on the serving YAML at full width (bf16, random
    weights from ``seed``, ``quantize: w8a8`` at ``min_channels``):

    - one forward each of the bf16 net, the int8 net with dynamic scales and
      with calibrated ones (``calibrate_sampler``, ``cal_batch`` tiles):
      their ms, their launches (every QuantConv's conv, all on the Hopper
      kernel, and quantize, its amax where the scale is dynamic; the linear
      attentions but the quantized one, the full attentions, the quantized
      one's core), and max|y_int8 - y_bf16| / max|y_bf16| < 0.10, the bar of
      tests/test_quant.py:77;
    - ``int8_conv`` at every distinct shape of that forward against its
      plain version, bit for bit (the bf16 output and the int32
      accumulators) by both kernels, with the ms of each and of the plain
      version (L2 flushed), the bound, and the ms of a bf16 ``F.conv2d`` of
      the same shape (a different function, for scale); the same bits at
      ``ragged_shapes``; the kernel's ms per forward;
    - ``act_amax`` and ``quantize_act`` at every distinct activation of that
      forward against their plain versions, bit for bit (``quant_case``),
      with their ms, bounds, and the PyTorch-op chain they replace;
    - ``srgd_tpu_torch.infer`` with ``--precision int8 --quant_calibrate
      --quant_calibrate_cache`` twice on a ``cli_size`` input: finite
      outputs in [0, 1] of 4x the size, the first run calibrating and
      writing the cache, the second loading it;
    - one ``--precision int8`` request through ``srgd_tpu_torch.serve``.

    The launches of the forwards, both CLI runs and the request are the
    phase's ``launches``."""
    import os
    import tempfile

    import numpy as np
    from PIL import Image

    from srgd_tpu_torch import infer
    from srgd_tpu_torch.kernels import int8_conv as ic
    from srgd_tpu_torch.nn import quant
    from srgd_tpu_torch.serve import Server, parse_args
    on_card = device.type == 'cuda'
    here = os.path.dirname(os.path.abspath(__file__))
    conf = os.path.join(here, conf)
    checks = {}
    res = {'phase': 'int8', 'min_channels': min_channels,
           'batch_size': batch_size, 'tile_size': tile_size}
    total = dict.fromkeys(KERNELS, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # -- one forward of each net ---------------------------------------------
    bf16 = _int8_wrapper(torch, device, conf, 'none', min_channels, seed)
    int8 = _int8_wrapper(torch, device, conf, 'w8a8', min_channels, seed)
    checks['same_weights'] = all(
        torch.equal(a, b) for a, b in zip(bf16.net.state_dict().values(),
                                          int8.net.state_dict().values()))
    x, t, fwd = _forward_inputs(torch, device, batch_size, tile_size, seed)

    def forward(net):
        def run():
            with torch.inference_mode():
                return net(x, t, **fwd)
        return run

    y_bf16 = forward(bf16.net)()
    ref_max = y_bf16.float().abs().max().item()
    shapes = _conv_shapes(torch, int8.net, forward(int8.net))
    nets = {}
    for name in ('dynamic', 'calibrated'):
        if name == 'calibrated':
            t0 = time.perf_counter()
            checks['calibrated'] = quant.calibrate_sampler(
                int8, generator=torch.Generator().manual_seed(seed),
                tile_size=tile_size, batch=cal_batch)
            if on_card:
                torch.cuda.synchronize()
            res['calibrate_seconds'] = time.perf_counter() - t0
        # dynamic: every QuantConv takes its amax; calibrated: none does
        expected, per_forward = _expected_launches(int8.net, on_card)
        res['per_forward' if name == 'dynamic'
            else 'per_forward_calibrated'] = per_forward
        reset_counts()
        y = forward(int8.net)()
        if on_card:
            torch.cuda.synchronize()
        launches = read_counts()
        add(launches)
        rel = (y.float() - y_bf16.float()).abs().max().item() / ref_max
        checks[f'{name}_within_0.10_of_bf16'] = rel < 0.10
        checks[f'{name}_finite'] = bool(torch.isfinite(y).all())
        for k in KERNELS:
            checks[f'{name}_{k}_launches'] = launches[k] == expected[k]
        # every conv of the net takes the Hopper kernel
        checks[f'{name}_int8_conv_took_wgmma'] = (
            ic.launches_wgmma == expected['int8_conv']
            and ic.launches_mma == 0)
        nets[name] = {'rel_err_vs_bf16': rel, 'launches': launches,
                      'launches_wgmma': ic.launches_wgmma,
                      'ms': time_ms(torch, forward(int8.net), device,
                                    forward_iters)}
    nets['bf16'] = {'ms': time_ms(torch, forward(bf16.net), device,
                                  forward_iters)}
    res['forwards'] = nets
    del bf16

    # -- the kernels at the forward's shapes ---------------------------------
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    flush = (torch.empty(64 << 20, dtype=torch.uint8, device=device)
             if on_card else None)

    def timed(fn):
        return time_ms(torch, fn, device, iters, flush)

    def bound(nbytes, ops=0):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_FLOPS['int8'] * 1e3
        return {'bound_ms': max(by_bytes, by_ops),
                'bound_by': 'bytes' if by_bytes >= by_ops else 'operations'}

    cases, ragged = [], []
    for shape, calls in [*shapes, *((s, 0) for s in ragged_shapes)]:
        case = int8_case(torch, device, shape, gen)
        got, want, got_mma = case['kern'](), case['plain'](), case['mma']()
        acc_plain = case['acc_plain']()
        acc_equal = (torch.equal(case['acc'](), acc_plain)
                     and torch.equal(case['acc_mma'](), acc_plain))
        if on_card:
            torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        b, h, w, cin, cout, ks = shape
        row = {
            'kernel': 'int8_conv', 'b': b, 'n': h * w, 'h': h, 'w': w,
            'c': cin, 'cout': cout, 'ks': ks, 'calls_per_forward': calls,
            'route': case['route'], 'dtype': 'bfloat16', 'max_abs_err': err,
            'rms_err': (got.float() - want.float()).square().mean().sqrt()
            .item(),
            'bitwise': bool(torch.equal(got, want)),
            'mma_bitwise': bool(torch.equal(got_mma, want)),
            'accumulators_bitwise': acc_equal}
        if calls:
            row.update({
                'ms': timed(case['kern']), 'mma_ms': timed(case['mma']),
                'plain_ms': timed(case['plain']), 'library_ms': None,
                'bf16_conv2d_ms': timed(case['bf16_conv']),
                'bytes': case['bytes'], 'ops': case['ops'],
                **bound(case['bytes'], case['ops'])})
            cases.append(row)
        else:
            ragged.append(row)
        del got, want, got_mma, acc_plain, case
    checks['kernel_bitwise'] = all(
        c['bitwise'] and c['mma_bitwise'] and c['accumulators_bitwise']
        for c in cases + ragged)
    # the net's shapes take the Hopper kernel; its first version keeps the
    # widths that are no multiple of 16
    checks['net_shapes_route_wgmma'] = all(c['route'] == 'wgmma'
                                           for c in cases)
    checks['ragged_cin_routes_mma'] = all(
        c['route'] == ('wgmma' if c['c'] % 16 == 0 else 'mma')
        for c in ragged)
    res['kernel_cases'] = cases
    res['ragged_int8_cases'] = ragged
    res['int8_conv_per_forward'] = {
        key: sum(c[key] * c['calls_per_forward'] for c in cases)
        for key in ('ms', 'mma_ms', 'bound_ms', 'bf16_conv2d_ms')}
    res['int8_conv_per_forward']['launches'] = sum(
        c['calls_per_forward'] for c in cases)

    # -- the activation quantize at the forward's activations -----------------
    acts = {}
    for (b, h, w, cin, _, _), calls in shapes:
        acts[(b, h, w, cin)] = acts.get((b, h, w, cin), 0) + calls
    quant_rows = []
    for shape, calls in acts.items():
        q = quant_case(torch, device, shape, gen)
        exact = {}
        for name, (kern, plain) in (('amax', q['amax']),
                                    ('amax_per_channel',
                                     q['amax_per_channel']),
                                    *q['quantize'].items()):
            exact[name] = bool(torch.equal(kern(), plain()))
        if on_card:
            torch.cuda.synchronize()
        b, h, w, c = shape
        common = {'b': b, 'n': h * w, 'c': c, 'calls_per_forward': calls,
                  'dtype': 'bfloat16', 'bitwise': exact,
                  'max_abs_err': 0.0 if all(exact.values()) else math.inf,
                  'rms_err': 0.0 if all(exact.values()) else math.inf}
        quant_rows.append({
            'kernel': 'act_amax', **common,
            'ms': timed(q['amax'][0]), 'plain_ms': timed(q['amax'][1]),
            'per_channel_ms': timed(q['amax_per_channel'][0]),
            'library_ms': timed(q['library_amax']),
            'bytes': q['bytes_amax'], **bound(q['bytes_amax'])})
        quant_rows.append({
            'kernel': 'quantize_act', **common,
            'ms': timed(q['quantize']['dynamic'][0]),
            'plain_ms': timed(q['quantize']['dynamic'][1]),
            'library_ms': None,
            # the dynamic pair (amax, then quantize) against QuantConv's
            # chain of PyTorch ops it replaces
            'dynamic_pair_ms': timed(q['dynamic_pair']),
            'op_chain_ms': timed(q['chain']),
            'bytes': q['bytes_quantize'], **bound(q['bytes_quantize'])})
        del q
    checks['quant_bitwise'] = all(all(r['bitwise'].values())
                                  for r in quant_rows)
    res['kernel_cases'] += quant_rows
    res['quantize_per_forward'] = {
        key: sum(r[key] * r['calls_per_forward'] for r in quant_rows
                 if r['kernel'] == 'quantize_act')
        for key in ('ms', 'dynamic_pair_ms', 'op_chain_ms', 'bound_ms')}
    res['quantize_per_forward']['amax_ms'] = sum(
        r['ms'] * r['calls_per_forward'] for r in quant_rows
        if r['kernel'] == 'act_amax')
    res['quantize_per_forward']['amax_bound_ms'] = sum(
        r['bound_ms'] * r['calls_per_forward'] for r in quant_rows
        if r['kernel'] == 'act_amax')
    del int8

    # -- the CLI, twice: calibrate and write the cache, then load it ----------
    work = tempfile.TemporaryDirectory()
    in_dir = os.path.join(work.name, 'in')
    os.makedirs(in_dir)
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, size=(cli_size, cli_size, 3), dtype=np.uint8)).save(
            os.path.join(in_dir, 'a.png'))
    cache = os.path.join(work.name, 'cal.npz')
    calibrations = []
    real_calibrate = quant.calibrate_sampler

    def calibrate(*a, **k):
        calibrations.append(1)
        return real_calibrate(*a, **k)

    quant.calibrate_sampler = calibrate
    cli = []
    try:
        for attempt in range(2):
            out_dir = os.path.join(work.name, f'out{attempt}')
            args = infer.parse_args([
                '-c', conf, '-m', '', '--input_dir', in_dir, '--output_dir',
                out_dir, '--precision', 'int8', '--quantize_min_channels',
                str(min_channels), '--quant_calibrate',
                '--quant_calibrate_cache', cache, '--num_sample_steps',
                str(cli_steps), '--tile_size', str(tile_size), '--batch_size',
                str(batch_size), '--test_label', '1', '--seed', str(seed),
                '--device', device.type])
            reset_counts()
            t0 = time.perf_counter()
            sampler = infer.build_sampler(args)
            build_s = time.perf_counter() - t0
            outs, sample = [], sampler.sample

            def kept(*a, **k):
                outs.append(sample(*a, **k))
                return outs[-1]

            sampler.sample = kept
            t0 = time.perf_counter()
            infer.run(args, sampler)
            if on_card:
                torch.cuda.synchronize()
            launches = read_counts()
            add(launches)
            out = outs[0] if outs else np.zeros(0)
            png = os.path.join(out_dir, 'a_out.png')
            cli.append({
                'build_and_calibrate_seconds': build_s,
                'sample_seconds': time.perf_counter() - t0,
                'calibrated': len(calibrations), 'launches': launches,
                'shape': list(out.shape),
                'ok': bool(out.shape == (1, 4 * cli_size, 4 * cli_size, 3)
                           and np.isfinite(out).all() and out.min() >= 0
                           and out.max() <= 1 and os.path.exists(png)
                           and Image.open(png).size == (4 * cli_size,) * 2
                           and os.path.exists(cache)
                           and quant.has_calibration(sampler.wrapper.net))})
            del sampler
    finally:
        quant.calibrate_sampler = real_calibrate
        work.cleanup()
    checks['cli_outputs'] = all(r['ok'] for r in cli)
    checks['cli_first_calibrates_second_loads'] = [
        r['calibrated'] for r in cli] == [1, 1]
    checks['cli_launched_int8_conv'] = all(
        r['launches']['int8_conv'] > 0 for r in cli) or not on_card
    res['cli'] = cli

    # -- one --precision int8 request through the daemon ----------------------
    server = Server(parse_args([
        '-c', conf, '-m', '', '--mode', 'http', '--device', device.type,
        '--precision', 'int8', '--quantize_min_channels', str(min_channels),
        '--continuous_sampler', 'ddim', '--ddim_eta',
        '1.0', '--num_sample_steps', str(serve_steps), '--tile_size',
        str(tile_size), '--batch_size', str(batch_size), '--test_label', '0',
        '--lr_bucket', '64']))
    img = Image.fromarray(np.random.default_rng(seed + 1).integers(
        0, 255, size=(serve_size, serve_size, 3), dtype=np.uint8))
    reset_counts()
    t0 = time.perf_counter()
    sr = server.super_resolve(img, seed=5)
    if on_card:
        torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    add(launches)
    checks['serve_int8_request'] = (
        sr.size == (4 * serve_size,) * 2
        and server.model_info['precision'] == 'int8'
        and (launches['int8_conv'] > 0 or not on_card))
    res['serve'] = {'ms': serve_ms, 'launches': launches,
                    'model_info': server.model_info}
    del server

    res.update({'ok': all(checks.values()), 'checks': checks,
                'launches': total})
    return res


TRAIN_YAML = 'conf/trained_evidence_dim128_synth.yaml'
# (n, c) of the flagship's linear- and full-attention blocks at which the
# train phase holds each Function's gradients to the plain version's
TRAIN_GRAD_LIN_SHAPES = ((65536, 128), (4096, 512))
TRAIN_GRAD_ATTN_SHAPES = ((1024, 512), (1024, 1024))


def _synth_pngs(path, n, size, seed):
    """``n`` procedural ``size``-px RGB PNGs from ``seed``: a colour ramp,
    rectangles, ellipses and fine noise, the statistics an SR degradation
    pipeline needs; numpy and PIL only."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        img = (rng.uniform(0, 1, 3) * xx[..., None]
               + rng.uniform(0, 1, 3) * yy[..., None]) / 2
        for _ in range(16):
            cy, cx = rng.uniform(0, 1, 2)
            ry, rx = rng.uniform(0.02, 0.2, 2)
            if rng.uniform() < 0.5:
                mask = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
            else:
                mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
            img[mask] = rng.uniform(0, 1, 3)
        img = img + rng.normal(0, 0.03, img.shape)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(path, f'{i:03d}.png'))


def _grad_case(torch, device, kind, b, n, c, dtype, gen):
    """One Function's gradients against ``torch.autograd`` of its plain
    version on the same inputs: x in ``dtype``, the gains, weights and
    bias float32, as the layers pass them. Returns the case's record."""
    from srgd_tpu_torch.kernels import attn_block as ab
    from srgd_tpu_torch.kernels import linattn_block as lb

    def rand(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(
            dt).requires_grad_()

    gains = [1 + rand(c, scale=0.1).detach() for _ in range(2)]
    if kind == 'linattn_block':
        inputs = [rand(b, n, c, dt=dtype), gains[0].requires_grad_(),
                  *(rand(c, 128, scale=c ** -0.5) for _ in range(3)),
                  rand(128, c, scale=128 ** -0.5), rand(c, scale=0.1),
                  gains[1].requires_grad_()]
        fn = lambda *a: lb.linattn_block(*a, dim_head=32)        # noqa: E731
        plain = lambda *a: lb.linattn_block_plain(*a, dim_head=32)  # noqa
    else:
        inputs = [rand(b, n, c, dt=dtype), gains[0].requires_grad_(),
                  rand(c, 384, scale=c ** -0.5),
                  rand(128, c, scale=128 ** -0.5), rand(c, scale=0.1)]
        fn = lambda *a: ab.attn_block(*a, heads=4, dim_head=32)      # noqa
        plain = lambda *a: ab.attn_block_plain(*a, heads=4, dim_head=32)  # noqa
    ct = torch.randn((b, n, c), generator=gen, device=device).to(dtype)
    got = torch.autograd.grad(fn(*inputs), inputs, ct)
    want = torch.autograd.grad(plain(*inputs), inputs, ct)
    rel = max(float((g.float() - w.float()).abs().max())
              / max(float(w.float().abs().max()), 1e-30)
              for g, w in zip(got, want))
    return {'kernel': kind, 'b': b, 'n': n, 'c': c,
            'dtype': str(dtype).split('.')[-1],
            'bitwise': all(torch.equal(g, w) for g, w in zip(got, want)),
            'dtypes_kept': all(g.dtype == t.dtype
                               for g, t in zip(got, inputs)),
            'max_rel_err': rel,
            'ok': rel <= TRAIN_GRAD_RTOL and all(
                g.dtype == t.dtype for g, t in zip(got, inputs))}


# the Functions' gradients against the plain version's on the card: the
# backward is that very recompute, so bit for bit is expected; more than
# this fraction of the largest gradient entry fails
TRAIN_GRAD_RTOL = 1e-6


class _Records:
    """Captures the training logger's messages."""

    def __init__(self, name):
        import logging
        self.messages = []
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.messages.append(r.getMessage())

    def __enter__(self):
        import logging
        self.level = self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)
        return False


def _peak_bytes(torch, device):
    return torch.cuda.max_memory_allocated(device) if device.type == 'cuda' \
        else 0


def _reset_peak(torch, device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def phase_train(torch, device, *, conf=TRAIN_YAML, images=40, image_size=320,
                steps=6, save_every=3, resume_to=8, remat_steps=2,
                grad_b=8, grad_lin_shapes=TRAIN_GRAD_LIN_SHAPES,
                grad_attn_shapes=TRAIN_GRAD_ATTN_SHAPES, pallas_size=64,
                seed=0):
    """Training through ``srgd_tpu_torch.train.loop.main``: the training
    YAML at full width (dim 128, mults 1,2,4,8, 256-px HR and 64-px LR
    crops, batch 8, bf16 over float32 parameters, AdamW, cosine with
    warmup, EMA 0.999) on ``images`` procedural ``image_size``-px PNGs made
    here from ``seed``; ``steps`` steps with a checkpoint every
    ``save_every``, then a second call resumes to ``resume_to``. Checks:
    every loss finite; the last step's gradient of the first linear
    attention's ``to_qkv`` weight and of ``init_conv`` finite and not zero;
    each train forward launched what the net routes to (6 / 3) and the
    backward none; the step counter, the optimizer state and best_score
    come back on resume; the checkpoint loads through ``factory.get_model``
    and one EMA forward is finite; a ``use_pallas`` net's backward raises
    the named error; both Functions' gradients equal the plain version's
    at their flagship shapes (b = ``grad_b``, bf16 and f32); and
    ``remat_steps`` steps with ``remat_unet`` on the same batch give the
    same first loss with a lower peak of device memory. Reports ms per
    train step (mean of steps 3 to ``steps``), the loop's phase breakdown,
    the ms of each Function's backward recompute per step (profiler ranges
    of the resumed run), peak device memory and the data path."""
    import copy
    import gc
    import shutil
    import tempfile

    from srgd_tpu_torch.checkpoint import restore_params
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.factory import build_wrapper, get_model
    from srgd_tpu_torch.kernels._autograd import recompute_range
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    from srgd_tpu_torch.train import data as data_mod
    from srgd_tpu_torch.train import loop, native, trainer
    on_card = device.type == 'cuda'
    here = os.path.dirname(os.path.abspath(__file__))
    conf_path = os.path.join(here, conf)
    cfg = load_config(conf_path)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_train_')
    t_phase = time.perf_counter()
    try:
        data_dir, out_dir = (os.path.join(tmp, d) for d in ('data', 'run'))
        os.makedirs(data_dir)
        _synth_pngs(data_dir, images, image_size, seed)
        # card 0 alone, however many cards the machine has
        argv = ['-c', conf_path, '--data_dir', data_dir, '--out_dir',
                out_dir, '--save_every', str(save_every), '--log_every', '1',
                '--device', 'cuda:0' if on_card else 'cpu']
        per_forward = _per_forward(list(build_unet_from_config(
            cfg, device='meta').modules()))
        checks = {}

        # the main path: `steps` steps from scratch
        _reset_peak(torch, device)
        reset_counts()
        state = loop.main(argv + ['--steps', str(steps)])
        if on_card:
            torch.cuda.synchronize(device)
        launches = read_counts()
        peak_main = _peak_bytes(torch, device)
        losses = list(state.losses)
        step_ms = [t * 1e3 for t in state.timer.durations['step']]
        breakdown = {k: {'seconds': v, 'calls': state.timer.counts[k]}
                     for k, v in state.timer.totals.items()}
        grads = {k: state.params[k].grad for k in
                 ('downs.0.2.to_qkv.weight', 'init_conv.weight')}
        checks['steps'] = state.step == steps
        for k, g in grads.items():
            checks[f'grad_{k}'] = g is not None and bool(
                torch.isfinite(g).all()) and float(g.abs().max()) > 0
        grad_max = {k: None if g is None else float(g.abs().max())
                    for k, g in grads.items()}
        # one forward a step; the backward launches nothing
        for name in KERNELS:
            checks[f'{name}_launches'] = (launches[name]
                                          == per_forward[name] * steps * on_card)
        del state, grads

        ckpt = os.path.join(out_dir, cfg.prefix)
        saved = restore_params(ckpt)
        best_saved = saved['best_score']
        checks['saved_step'] = saved['step'] == steps
        del saved

        # the resume, profiled for the backward recompute's ranges
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        reset_counts()
        with _Records('srgd_tpu_torch.train') as rec, \
                profile(activities=acts) as prof:
            state = loop.main(argv + ['--steps', str(resume_to)])
            if on_card:
                torch.cuda.synchronize(device)
        resume_launches = read_counts()
        losses += list(state.losses)
        checks['resumed'] = any(
            m.startswith('resumed from') and m.endswith(
                f'at step {steps}, best_score {best_saved!r}')
            for m in rec.messages)
        checks['resume_steps'] = state.step == resume_to
        # AdamW's step count in each parameter's state (``trainer.Adam``)
        counts = {s['count'] for s in state.optimizer.state.values()}
        checks['optimizer_state_restored'] = counts == {resume_to}
        for name in KERNELS:
            checks[f'{name}_resume_launches'] = (
                resume_launches[name]
                == per_forward[name] * (resume_to - steps) * on_card)
        launches = {k: launches[k] + resume_launches[k] for k in launches}
        # the range appears twice on the card: on the host, whose device
        # time is that of the kernels launched inside it, and as the
        # device-side annotation, whose time is its span on the card
        from torch.autograd import DeviceType
        recompute = {}
        for name in ('linattn_block', 'attn_block'):
            rows = [e for e in prof.key_averages()
                    if e.key == recompute_range(name)]
            host = [e for e in rows if e.device_type == DeviceType.CPU]
            span = [e for e in rows if e.device_type != DeviceType.CPU]
            per_step = 1e3 * (resume_to - steps)

            def device_us(e):
                return getattr(e, 'device_time_total',
                               getattr(e, 'cuda_time_total', 0))
            recompute[name] = {
                'kernel_ms_per_step': sum(map(device_us, host)) / per_step,
                'span_ms_per_step': sum(map(device_us, span)) / per_step,
                'host_ms_per_step': sum(e.cpu_time_total for e in host)
                / per_step,
                'calls_per_step': sum(e.count for e in host)
                / (resume_to - steps)}
        checks['recompute_ranges'] = all(
            r['calls_per_step'] == per_forward[k]
            for k, r in recompute.items())
        del state, prof
        checks['losses_finite'] = all(math.isfinite(x) for x in losses)

        # the trained checkpoint samples: its EMA through the factory
        wrapper, net = get_model(load_config(conf_path), ckpt, device=device)
        ema = restore_params(ckpt)['ema_params']
        checks['ema_loaded'] = all(torch.equal(v.cpu(), ema[k])
                                   for k, v in net.state_dict().items())
        gen = torch.Generator(device=device).manual_seed(seed)
        s = cfg.hr_image_size
        with torch.inference_mode():
            out = net(torch.randn((1, 3, s, s), generator=gen, device=device),
                      torch.rand(1, generator=gen, device=device),
                      cond=torch.rand((1, 3, s, s), generator=gen,
                                      device=device),
                      class_label=torch.tensor([1], device=device))
        checks['ema_forward_finite'] = bool(torch.isfinite(out).all())
        del wrapper, net, ema, out

        # a use_pallas net cannot be trained, in either package
        c = copy.deepcopy(cfg)
        c.use_pallas_kernels = True
        pallas = build_unet_from_config(c, device=device)
        pallas.init_weights(torch.Generator().manual_seed(seed))
        x = torch.randn((1, 3, pallas_size, pallas_size), generator=gen,
                        device=device)
        try:
            pallas(x, torch.rand(1, generator=gen, device=device)).sum() \
                .backward()
            checks['use_pallas_backward_raises'] = False
        except RuntimeError as e:
            checks['use_pallas_backward_raises'] = 'has no gradient' in str(e)
        del pallas, x

        # remat: the same first loss on one batch, less memory
        batch = next(iter(data_mod.DegradationDataset(
            data_dir, crop_size=cfg.hr_image_size, batch_size=cfg.batch_size,
            num_classes=cfg.num_classes, seed=cfg.seed, num_workers=1,
            degrade_cfg=data_mod.DegradeConfig.from_conf(cfg),
            scale=cfg.hr_image_size // cfg.lr_image_size, as_uint8=True)))
        batch = [torch.from_numpy(a).to(device) for a in batch]
        remat = {}
        for on in (False, True):
            c = copy.deepcopy(cfg)
            c.remat_unet = on
            net = build_unet_from_config(c, device=device).train()
            loop._init_weights(net, None, c)
            wrapper = build_wrapper(c, net)
            params = trainer.trainable_params(wrapper)
            st = trainer.create_train_state(params, trainer.make_optimizer(
                c, params, steps_per_epoch=1))
            step = trainer.make_train_step(wrapper, c.ema_decay,
                                           'conditional' in c.model, c.seed)
            gc.collect()
            _reset_peak(torch, device)
            rl = [float(step(st, *batch)) for _ in range(remat_steps)]
            remat['remat' if on else 'plain'] = {
                'losses': rl, 'peak_gb': _peak_bytes(torch, device) / 1e9}
            del net, wrapper, params, st, step
        checks['remat_first_loss_equal'] = (remat['plain']['losses'][0]
                                            == remat['remat']['losses'][0])
        checks['remat_lowers_peak_memory'] = (
            not on_card or remat['remat']['peak_gb'] < remat['plain']['peak_gb'])

        # the Functions' gradients against the plain version's
        grad_cases = []
        for dtype in (torch.bfloat16, torch.float32):
            for kind, shapes in (('linattn_block', grad_lin_shapes),
                                 ('attn_block', grad_attn_shapes)):
                for n, c in shapes:
                    grad_cases.append(_grad_case(torch, device, kind, grad_b,
                                                 n, c, dtype, gen))
        checks['function_gradients'] = all(g['ok'] for g in grad_cases)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    timed = step_ms[2:steps] or step_ms
    return {'phase': 'train', 'ok': all(checks.values()), 'checks': checks,
            'config': conf, 'steps': steps, 'resume_to': resume_to,
            'launches': launches, 'per_forward': per_forward,
            'losses': losses, 'step_ms': step_ms,
            'ms_per_step': sum(timed) / len(timed),
            'phase_breakdown': breakdown,
            'recompute_per_step': recompute,
            'peak_memory_gb': peak_main / 1e9, 'remat': remat,
            'grad_max': grad_max, 'grad_cases': grad_cases,
            'data_path': native.backend(),
            'seconds': time.perf_counter() - t_phase}


def _bench_net(torch, device, wrapper, cond, *, tile_size, batch_size, seed,
               forward_iters):
    """ms of one forward on a tile batch, and of one even and one odd sampler
    step: the last two of 250 steps run (248 even, 249 odd) and then the last
    alone, each after a warm-up, timed on the host clock around a synchronised
    call; the even step is their difference."""
    from srgd_tpu_torch.diffusion.base import GeneratorNoise

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


MESH_TRAIN_RTOL = 1e-4
# relative L2 gap of Adam's first moment after a mesh step, by compute dtype
MESH_MU_RTOL = {'bfloat16': BF16_RTOL, 'float32': MESH_TRAIN_RTOL}


def _first_step_gap(torch, plain, params: dict, opt_state: dict) -> dict:
    """One device's live state after a step (``plain``) against a mesh
    run's whole ``params`` and its checkpoint's ``opt_state``: Adam's first
    moment (a tenth of the step's gradient), its relative L2 gap and how
    many entries changed sign; the parameters' largest gap, and how many of
    their bf16 casts (the weights a bf16 forward uses) differ."""
    d2 = n2 = 0.0
    sign_flips = 0
    for idx, st in plain.optimizer.state_dict()['state'].items():
        a = st['mu'].detach().double().cpu()
        b = opt_state['state'][idx]['mu'].double()
        d2 += float((a - b).pow(2).sum())
        n2 += float(a.pow(2).sum())
        sign_flips += int((torch.sign(a) != torch.sign(b)).sum())
    gap, casts, total = 0.0, 0, 0
    for k, v in plain.params.items():
        a, b = v.detach().float().cpu(), params[k].float()
        gap = max(gap, float((a - b).abs().max()))
        casts += int((a.bfloat16() != b.bfloat16()).sum())
        total += a.numel()
    return {'mu_rel_l2': math.sqrt(d2 / n2), 'mu_sign_flips': sign_flips,
            'param_max_abs': gap, 'param_bf16_casts_changed': casts,
            'param_count': total}


def _mesh_sample_rank(mesh, size, tile_size, steps, batch_size, seed, net_kw):
    """One rank of the mesh phase: the flagship sampler on this rank's card,
    plainly (the reference, and again to time it) and through the mesh
    (``tiled_sample(mesh=...)``; checked, and again to time it), each
    counted. Rank 0's result goes home."""
    import torch

    from srgd_tpu_torch.diffusion.base import GeneratorNoise
    device = mesh.device
    wrapper = build_flagship(torch, device, seed=seed, **net_kw)
    cond, label = _slice_inputs(torch, device, size, seed)

    def sample(m):
        return _counted(torch, device, wrapper, lambda: wrapper.tiled_sample(
            cond, label, batch_size=batch_size, tile_size=tile_size,
            class_cond_scale=2.0, num_sample_steps=steps,
            noise=GeneratorNoise(seed + 2, device), mesh=m))

    plain, _, _, _, _ = sample(None)
    # the first mesh run also sets up the data group's communicator: it is
    # checked and counted, the second one timed
    out, forwards, _, launches, _ = sample(mesh)
    _, _, _, _, mesh_s = sample(mesh)
    _, _, _, _, plain_s = sample(None)
    checks, per_forward = _slice_checks(torch, device, wrapper, out, size,
                                        forwards, launches)
    diff = (out.float() - plain.float()).abs().max().item()
    # every chunk keeps its world-1 batch: every world gives world 1's bits
    bit_equal = checks['bit_equal_to_plain'] = bool(torch.equal(out, plain))
    return {'checks': checks, 'forwards': forwards, 'launches': launches,
            'per_forward': per_forward, 'bit_equal': bit_equal,
            'max_abs_diff': diff, 'ms_per_step_plain': plain_s / steps * 1e3,
            'ms_per_step_mesh': mesh_s / steps * 1e3}


def phase_mesh(torch, device, *, size=512, tile_size=256, steps=2,
               batch_size=8, seed=0, train_conf=TRAIN_YAML, images=8,
               image_size=320, cli_conf=SHIPPED_YAML,
               cli_size=64, cli_steps=2, **net_kw):
    """The device mesh (``srgd_tpu_torch.parallel``, ``--mesh``) on every
    visible card: one rank per card through NCCL, in this process at world
    1 (a CPU rehearsal: one gloo rank).

    - sampling: the flagship sampler of phase ``slice`` through the mesh
      (the data ranks split the tile chunks and all-gather them) against the
      plain sampler on the same seed: bit-equal at every world; every
      forward of the mesh run launched 6 / 3; the ms per step of both (at
      world 1, where no collective runs, the difference is the mesh path's
      own cost);
    - training: one step of ``train.loop.train`` with ``mesh_shape`` (N, 1)
      against one step on one device (``train.loop.train_on``), on
      ``images`` procedural PNGs, then each resumed to step 2
      (``_first_step_gap`` and ``MESH_TRAIN_RTOL``, ``MESH_MU_RTOL``): step
      1's loss, Adam's first moment and the parameters; step 2's loss at
      ``MESH_TRAIN_RTOL`` at world 1 (finite at world N); whether losses and
      parameters matched bit for bit. At world N the same again with
      float32 compute;
    - the CLI: one ``python -m srgd_tpu_torch.infer --mesh N,1`` subprocess
      (it spawns its ranks itself at N > 1) writes its PNG at 4x a
      ``cli_size`` input;
    - the daemon: one ``python -m srgd_tpu_torch.serve --mesh N,1``
      subprocess reports the mesh on /healthz, answers one seeded request
      at 4x and exits 0 on SIGTERM.

    The mesh runs' launches (rank 0's), sampling and training, are the
    phase's ``launches``."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from srgd_tpu_torch.checkpoint import restore_params
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.parallel.mesh import launch
    from srgd_tpu_torch.train import loop
    on_card = device.type == 'cuda'
    world = torch.cuda.device_count() if on_card else 1
    here = os.path.dirname(os.path.abspath(__file__))
    res = {'phase': 'mesh', 'world': world, 'shape': [world, 1],
           'size': size, 'steps': steps}
    t0 = time.perf_counter()
    sampled = launch(_mesh_sample_rank, (world, 1), device.type,
                     (size, tile_size, steps, batch_size, seed, net_kw))
    checks = {f'sample_{k}': v for k, v in sampled.pop('checks').items()}
    res.update(sampled)
    if world == 1:   # the mesh path's own cost: no collective runs
        res['mesh_overhead_ms_per_step'] = (
            sampled['ms_per_step_mesh'] - sampled['ms_per_step_plain'])
    res['mesh_speedup'] = (sampled['ms_per_step_plain']
                           / sampled['ms_per_step_mesh'])
    res['sample_seconds'] = time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix='chip_smoke_mesh_')
    try:
        t0 = time.perf_counter()
        data_dir = os.path.join(tmp, 'data')
        os.makedirs(data_dir)
        _synth_pngs(data_dir, images, image_size, seed)
        cfg = load_config(os.path.join(here, train_conf))
        res['train'] = train = {}
        res['train_launches'] = dict.fromkeys(KERNELS, 0)
        # at world N also in float32: what the bf16 rounding of the split
        # batch's gradients does (spawned ranks take this process's float32
        # settings)
        for dtype in [cfg.compute_dtype] + (['float32'] if world > 1 else []):
            c = copy.deepcopy(cfg)
            c.compute_dtype = dtype
            r = train[dtype] = {}
            plain_dir, mesh_dir = (os.path.join(tmp, f'{w}_{dtype}')
                                   for w in ('plain', 'mesh'))
            for steps in (1, 2):    # one step, then each resumed to step 2
                plain = loop.train_on(None, copy.deepcopy(c), data_dir,
                                      plain_dir, steps, 1, 10 ** 6, steps > 1,
                                      None, device)
                reset_counts()
                meshed = loop.train(copy.deepcopy(c), data_dir, mesh_dir,
                                    total_steps=steps, log_every=1,
                                    save_every=10 ** 6, mesh_shape=(world, 1),
                                    device=device.type)
                if dtype == cfg.compute_dtype:
                    for k, v in read_counts().items():
                        res['train_launches'][k] += v
                r[f'steps_{steps}'] = meshed.step
                r[f'loss_{steps}'] = {'plain': plain.losses[-1],
                                      'mesh': meshed.losses[-1]}
                if steps == 1:
                    saved = restore_params(os.path.join(
                        mesh_dir, c.prefix or 'ckpt'))['opt_state']
                    r.update(_first_step_gap(torch, plain, meshed.params,
                                             saved))
                    del saved
                else:
                    r['params_bit_equal'] = all(
                        torch.equal(v.detach().cpu(), meshed.params[k])
                        for k, v in plain.params.items())
                del plain, meshed

            def close(losses):
                return math.isfinite(losses['mesh']) and abs(
                    losses['mesh'] - losses['plain']) <= (
                        MESH_TRAIN_RTOL * abs(losses['plain']))
            tag = f'train_{dtype}'
            checks[f'{tag}_steps'] = (r['steps_1'], r['steps_2']) == (1, 2)
            # step 1: the same parameters and global batch, so the loss is
            # one device's up to the order of its mean, and Adam's first
            # moment is a tenth of the all-reduced gradient: a gradient that
            # missed the all-reduce, or one rank's rows, is off by its size
            checks[f'{tag}_loss_1'] = close(r['loss_1'])
            checks[f'{tag}_mu_1'] = r['mu_rel_l2'] <= MESH_MU_RTOL[dtype]
            # Adam moves each parameter about lr, either way
            checks[f'{tag}_params_1'] = r['param_max_abs'] <= 2 * cfg.lr
            checks[f'{tag}_loss_2'] = (close(r['loss_2']) if world == 1
                                       else math.isfinite(r['loss_2']['mesh']))
        res['launches'] = {k: v + res['train_launches'][k]
                           for k, v in res['launches'].items()}
        main = train[cfg.compute_dtype]
        res['train_losses'] = {w: [main['loss_1'][w], main['loss_2'][w]]
                               for w in ('plain', 'mesh')}
        res['train_losses_bit_equal'] = (res['train_losses']['plain']
                                         == res['train_losses']['mesh'])
        res['train_params_bit_equal'] = main['params_bit_equal']
        res['train_seconds'] = time.perf_counter() - t0

        # the CLI, with its own launcher
        t0 = time.perf_counter()
        in_dir, out_dir = (os.path.join(tmp, d) for d in ('in', 'out'))
        os.makedirs(in_dir)
        rng = np.random.default_rng(seed)
        Image.fromarray(rng.integers(0, 255, (cli_size, cli_size, 3),
                                     dtype=np.uint8)).save(
            os.path.join(in_dir, 'a.png'))
        cmd = [sys.executable, '-m', 'srgd_tpu_torch.infer', '-c',
               os.path.join(here, cli_conf), '-m', '', '--input_dir', in_dir,
               '--output_dir', out_dir, '--num_sample_steps', str(cli_steps),
               '--tile_size', str(tile_size), '--batch_size',
               str(batch_size), '--precision', 'bf16', '--test_label', '1',
               '--mesh', f'{world},1', '--device', device.type]
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=here))
        out_png = os.path.join(out_dir, 'a_out.png')
        checks['cli_exit'] = proc.returncode == 0
        checks['cli_png'] = (os.path.exists(out_png) and Image.open(
            out_png).size == (4 * cli_size, 4 * cli_size))
        if proc.returncode:
            res['cli_stderr'] = proc.stderr[-2000:]
        res['cli_seconds'] = time.perf_counter() - t0

        # the daemon, with its own launcher: /healthz, one seeded request,
        # then SIGTERM (rank 0 drains and stops the others)
        t0 = time.perf_counter()
        port = _free_port()
        cmd = [sys.executable, '-m', 'srgd_tpu_torch.serve', '-c',
               os.path.join(here, cli_conf), '-m', '', '--mode', 'http',
               '--port', str(port), '--num_sample_steps', str(cli_steps),
               '--tile_size', str(tile_size), '--batch_size', str(batch_size),
               '--test_label', '1', '--mesh', f'{world},1', '--device',
               device.type]
        daemon = subprocess.Popen(cmd, cwd=here, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True,
                                  env=dict(os.environ, PYTHONPATH=here),
                                  start_new_session=True)
        try:
            health, deadline = None, time.time() + 600
            while health is None and daemon.poll() is None \
                    and time.time() < deadline:
                try:
                    health = json.loads(_http(port, 'GET', '/healthz')[2])
                except OSError:
                    time.sleep(0.5)
            checks['serve_health_mesh'] = (health or {}).get('mesh') == [
                world, 1]
            if health is not None:
                status, _, body = _http(port, 'POST', '/v1/sr?seed=3',
                                        _png(cli_size, cli_size, seed))
                checks['serve_png'] = status == 200 and _decoded(
                    body).shape[:2] == (4 * cli_size, 4 * cli_size)
            daemon.send_signal(signal.SIGTERM)
            err = daemon.communicate(timeout=600)[1]
            checks['serve_exit'] = daemon.returncode == 0
            if daemon.returncode or health is None:
                res['serve_stderr'] = err[-2000:]
        finally:
            if daemon.poll() is None:
                os.killpg(daemon.pid, signal.SIGKILL)
                daemon.communicate()
        res['serve_seconds'] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res['checks'] = checks
    res['ok'] = all(checks.values())
    return res


QUALITY_MODES = 'float32,bfloat16,w8a8dyn,w8a8,bfloat16+dc2.2'


class _ForwardLedger:
    """Every ``SRUnet`` forward while active (the class's ``forward``
    wrapped): the launches it made (counts read before and after, never
    reset) against what its net routes to, ``_per_forward`` of the whole
    net or ``_cached_per_forward`` on a DeepCache cache, times 0 on the
    CPU. Calibration forwards (a QuantConv recording) are counted apart and
    not held. ``records``: per net, in the order they first ran, its
    forwards, cached forwards, launches and one full forward's routing."""

    def __init__(self, device):
        import weakref
        self.scale = int(device.type == 'cuda')
        self.records, self.mismatched, self.calibration = [], 0, 0
        # a freed net's id can come back for the next one: key by the net
        self._of = weakref.WeakKeyDictionary()

    def __enter__(self):
        from srgd_tpu_torch.nn.quant import quant_convs
        from srgd_tpu_torch.nn.unet import SRUnet
        self._cls, self._real = SRUnet, SRUnet.forward
        ledger, real = self, SRUnet.forward

        def forward(net, *args, **kw):
            before = read_counts()
            out = real(net, *args, **kw)
            got = {k: v - before[k] for k, v in read_counts().items()}
            if any(m.calibrating for _, m in quant_convs(net)):
                ledger.calibration += 1
                return out
            cached = kw.get('deep_cache') is not None
            want = (_cached_per_forward(net, kw['cache_depth']) if cached
                    else _per_forward(list(net.modules())))
            rec = ledger._of.get(net)
            if rec is None:
                rec = ledger._of[net] = {
                    'forwards': 0, 'cached_forwards': 0,
                    'launches': dict.fromkeys(KERNELS, 0),
                    'per_forward': _per_forward(list(net.modules()))}
                ledger.records.append(rec)
            rec['forwards'] += 1
            rec['cached_forwards'] += cached
            for k in KERNELS:
                rec['launches'][k] += got[k]
            ledger.mismatched += got != {k: v * ledger.scale
                                         for k, v in want.items()}
            return out

        SRUnet.forward = forward
        return self

    def __exit__(self, *exc):
        self._cls.forward = self._real
        return False

    @property
    def ok(self) -> bool:
        return bool(self.records) and self.mismatched == 0

    def runs(self) -> list:
        return list(self.records)


def _with_env(env: dict, fn):
    """``fn()`` with ``env`` set in ``os.environ`` and its stdout captured:
    (result, stdout)."""
    import contextlib
    import io
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            result = fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return result, text.getvalue()


def _quality_probe(torch, device, *, lr, steps, dim, modes):
    """Section (a): ``quality_probe.main`` at QP_QMIN 0 on seeded random
    weights; per mode its net's forwards and launches, the output checks,
    its seconds and its PSNR line against the first mode."""
    import numpy as np

    from srgd_tpu_torch.tools import quality_probe as probe
    env = dict(QP_LR=str(lr), QP_STEPS=str(steps), QP_DIM=str(dim),
               QP_MODES=modes, QP_QMIN='0', QP_WSEED='0', QP_CSEED='1',
               QP_DEVICE=str(device))
    with _ForwardLedger(device) as ledger:
        (outs, seconds), text = _with_env(env, probe.main)
    lines = probe.parse_lines(text)
    names = modes.split(',')
    runs = ledger.runs()
    hr = 4 * lr
    per_mode, checks = {}, {'forwards_route': ledger.ok,
                            'one_net_per_mode': len(runs) == len(names)}
    for name, run in zip(names, runs):
        out = outs[name]
        checks[f'{name}_output'] = bool(
            out.shape == (1, hr, hr, 3) and np.isfinite(out).all()
            and out.min() >= 0 and out.max() <= 1)
        checks[f'{name}_sampled_line'] = name in lines['sampled']
        if name != names[0]:
            checks[f'{name}_psnr_line'] = name in lines['psnr']
        per_mode[name] = {**run, 'seconds': seconds[name],
                          **lines['psnr'].get(name, {})}
    # the attention kernels run in every dtype: 6 / 3 a full forward in
    # float32 as in bf16, 4 / 0 a cached one at depth 2
    for name in ('float32', 'bfloat16'):
        if name in per_mode:
            pf = per_mode[name]['per_forward']
            checks[f'{name}_routes_6_3'] = (pf['linattn_block'],
                                            pf['attn_block']) == (6, 3)
    return {'lines': text.splitlines(), 'modes': per_mode,
            'calibration_forwards': ledger.calibration,
            'checks': checks}


def _quality_evidence(torch, device, tmp, *, conf, hr, base_steps, tile_size,
                      seed):
    """Section (b): ``evidence_eval.main`` from a trainer checkpoint of
    seeded weights (``save_params``: ``ema_params``, ``step``); the three
    tables, every number finite, every forward routed."""
    import numpy as np

    from srgd_tpu_torch.checkpoint import save_params
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.tools import evidence_eval, quality_probe
    weights = quality_probe.random_weights(load_config(conf), seed, device)
    ckpt = os.path.join(tmp, 'evidence_ckpt')
    save_params(ckpt, {'ema_params': {k: v.cpu() for k, v in weights.items()},
                       'step': 0})
    del weights
    env = dict(EV_CKPT=ckpt, EV_CONF=conf, EV_HR=str(hr), EV_TILE=str(tile_size),
               EV_IMAGES='1', EV_BASE_STEPS=str(base_steps),
               EV_LADDER_CLASSES='0,1,2', EV_LADDER_IMAGES='1',
               EV_LADDER_MODES=f'ddim-{base_steps},dpmpp-{base_steps},'
                               f'ddim:1.0-{base_steps}',
               EV_CFG='1', EV_CFG_IMAGES='1',
               EV_CFG_MODE=f'ddim:1.0-{base_steps}', EV_DEVICE=str(device))
    t0 = time.perf_counter()
    with _ForwardLedger(device) as ledger:
        _, text = _with_env(env, evidence_eval.main)
    seconds = time.perf_counter() - t0
    tables = evidence_eval.parse_tables(text)
    numbers = [v for rows in tables.values() for r in rows
               for v in r.values() if isinstance(v, float)]
    numbers += [x for r in tables['cfg'] for pair in r['classes'].values()
                for x in pair]
    runs = ledger.runs()
    checks = {
        'per_class_table': [r['label'] for r in tables['per_class']]
        == [0, 1, 2],
        'ladder_table': len(tables['ladder']) == 4,
        'cfg_table': len(tables['cfg']) == 9,
        'finite': bool(numbers) and bool(np.isfinite(numbers).all()),
        'forwards_route': ledger.ok,
        'one_net': len(runs) == 1}
    return {'tables': tables, 'seconds': seconds, 'net': runs[:1],
            'lines': len(text.splitlines()), 'checks': checks}


def _quality_captures(torch, device, *, size, tile_size, batch_size, seed,
                      dpmpp_size, net_kw, conf_kw):
    """Section (c): each sampler once with both captures and once without:
    the same bits, 1 + steps - start frames, the last frame unnormalizing
    to the output; the frames' device bytes."""
    from srgd_tpu_torch.diffusion.base import GeneratorNoise
    cond, label = _slice_inputs(torch, device, size, seed)
    small, _ = _slice_inputs(torch, device, dpmpp_size, seed + 7)
    # (name, wrapper builder, steps, generation_start_steps, tiled)
    cases = (
        ('slice', lambda: build_flagship(torch, device, seed=seed, **net_kw),
         2, 0, True),
        ('gaussian_ddim_tiled', lambda: build_family(
            torch, device, 'conditional_gaussian', seed=seed,
            learned_sinusoidal_cond=False, **conf_kw), 4, 1, True),
        ('elucidated_heun_tiled', lambda: build_family(
            torch, device, 'conditional_elucidated', seed=seed, **conf_kw),
         4, 0, True),
        ('elucidated_dpmpp', lambda: build_family(
            torch, device, 'conditional_elucidated', seed=seed, **conf_kw),
         4, 0, False),
        ('continuous_learned_tiled', lambda: build_family(
            torch, device, 'conditional_continuous', seed=seed,
            noise_schedule='learned', **conf_kw), 2, 0, True))
    res, checks = {}, {}
    for name, build, steps, start, tiled in cases:
        wrapper = build()

        def run(**capture):
            noise = GeneratorNoise(seed + 2, device)
            kw = dict(class_cond_scale=2.0, num_sample_steps=steps,
                      generation_start_steps=start, noise=noise, **capture)
            if tiled:
                return wrapper.tiled_sample(cond, label, batch_size=batch_size,
                                            tile_size=tile_size, **kw)
            return wrapper.sample(small, label, **kw)

        with torch.inference_mode():
            plain = run()
            out, traj, x0 = run(capture_trajectory=True, capture_x0=True)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        frames = 1 + steps - start
        c = {'bit_equal': bool(torch.equal(plain, out)),
             'frames': traj.shape[0] == x0.shape[0] == frames
             and traj.shape[1:] == out.shape,
             'last_frame_is_output': bool(torch.equal(
                 (torch.clamp(traj[-1], -1.0, 1.0) + 1.0) * 0.5, out)),
             'float32_finite': traj.dtype == x0.dtype == torch.float32
             and bool(torch.isfinite(traj).all() and torch.isfinite(x0).all())}
        checks.update({f'{name}_{k}': v for k, v in c.items()})
        res[name] = {'steps': steps, 'start': start, 'tiled': tiled,
                     'frame_shape': list(traj.shape),
                     'frame_bytes': traj.numel() * traj.element_size()
                     + x0.numel() * x0.element_size(),
                     'device': str(traj.device), **c}
        del wrapper, plain, out, traj, x0
    return {'runs': res, 'checks': checks}


def _quality_pth(torch, device, tmp, *, conf, dim):
    """Section (d): ``tools.flagship_ckpt`` (the reference-format ``.pth``
    written, loaded with ``load_strict`` and sampled through ``python -m
    srgd_tpu_torch.infer``), then the same ``.pth`` through the CLI's
    ``build_sampler`` (``factory.get_model``) in this process with the
    CLI's seed, options and float32 settings: the same PNG bits."""
    import numpy as np
    from PIL import Image

    from srgd_tpu_torch import infer
    from srgd_tpu_torch.tools import flagship_ckpt
    rec, text = _with_env({}, lambda: flagship_ckpt.run(
        os.path.join(tmp, 'flagship'), conf_path=conf, device=str(device),
        dim=dim))
    cli = rec['cli']
    args = infer.parse_args(['-c', conf, '-m', rec['pth'], '--input_dir',
                             os.path.dirname(cli['input']), '--output_dir',
                             os.path.join(tmp, 'unused'),
                             *flagship_ckpt.CLI_ARGS, '--device', str(device)])
    # the CLI's process keeps PyTorch's float32 defaults, TF32 convolutions
    # and full-precision matmuls, which phase_device switched off here
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    try:
        with _ForwardLedger(device) as ledger:
            sampler = infer.build_sampler(args)
            image = infer.try_open_image(cli['input'])
            mine = np.asarray(infer.sr_target_image(
                image, sampler, test_label=args.test_label, seed=args.seed))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    seconds = time.perf_counter() - t0
    with Image.open(cli['output']) as im:
        theirs = np.asarray(im.convert('RGB'))
    checks = {
        'params': rec['saved']['params'] == (flagship_ckpt.FLAGSHIP_PARAMS
                                             if dim == 128
                                             else rec['loaded']['params']),
        'no_missing_keys': rec['loaded']['missing'] == [],
        'no_unexpected_keys': rec['loaded']['unexpected'] == [],
        'png_x4': tuple(cli['size']) == (64, 64),
        'in_process_png_equal': mine.shape == theirs.shape
        and bool((mine == theirs).all()),
        'forwards_route': ledger.ok}
    return {'params': rec['saved']['params'], 'bytes': rec['saved']['bytes'],
            'keys': rec['saved']['keys'],
            'missing': len(rec['loaded']['missing']),
            'unexpected': len(rec['loaded']['unexpected']),
            'save_seconds': rec['saved']['seconds'],
            'load_seconds': rec['loaded']['seconds'],
            'cli_seconds': cli['seconds'], 'in_process_seconds': seconds,
            'max_abs_png_diff': int(np.abs(mine.astype(int)
                                           - theirs.astype(int)).max()),
            'net': ledger.runs(), 'lines': text.splitlines(),
            'checks': checks}


def phase_quality(torch, device, *, lr=128, steps=4, dim=128,
                  modes=QUALITY_MODES, evidence_conf=TRAIN_YAML,
                  evidence_hr=256, evidence_steps=4, evidence_tile=256,
                  size=512, tile_size=256, batch_size=8, dpmpp_size=256,
                  pth_conf=SHIPPED_YAML, pth_dim=128, seed=0, net_kw=None,
                  conf_kw=None):
    """The evaluation entry points at full width: (a) the quality probe in
    ``modes`` on a ``4 lr`` canvas, (b) the evidence eval from a trainer
    checkpoint, (c) the samplers' debug captures in every family and (d)
    the flagship ``.pth`` through the CLI. ``net_kw`` / ``conf_kw`` shrink
    the nets of (c) for the tests' rehearsal, as the other phases' do."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    evidence_conf = os.path.join(here, evidence_conf)
    pth_conf = os.path.join(here, pth_conf)
    res = {'phase': 'quality'}
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_quality_') as tmp:
        res['probe'] = _quality_probe(torch, device, lr=lr, steps=steps,
                                      dim=dim, modes=modes)
        res['evidence'] = _quality_evidence(
            torch, device, tmp, conf=evidence_conf, hr=evidence_hr,
            base_steps=evidence_steps, tile_size=evidence_tile, seed=seed)
        res['captures'] = _quality_captures(
            torch, device, size=size, tile_size=tile_size,
            batch_size=batch_size, seed=seed, dpmpp_size=dpmpp_size,
            net_kw=net_kw or {}, conf_kw=conf_kw or {})
        res['pth'] = _quality_pth(torch, device, tmp, conf=pth_conf,
                                  dim=pth_dim)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    res['launches'] = read_counts()
    res['seconds'] = time.perf_counter() - t0
    res['ok'] = all(all(res[k]['checks'].values())
                    for k in ('probe', 'evidence', 'captures', 'pth'))
    return res


def phase_convert(torch, device, *, conf=SHIPPED_YAML, dim=128,
                  train_conf=TRAIN_YAML, images=8, image_size=320,
                  train_steps=2, seed=0):
    """Checkpoint conversion (``srgd_tpu_torch.checkpoint.convert``) at full
    width: the flagship ``.pth`` (``tools.flagship_ckpt.write_pth``)
    converted forward to a float32 and a bfloat16 directory; the CLI
    (``srgd_tpu_torch.infer.main``, in this process so that its launches
    count: 2 steps, one 16-px PNG, the default net) on the ``.pth``, on each
    directory and on the ``.pth`` under ``param_dtype: bfloat16``: the
    float32 directory must give the ``.pth``'s PNG bit for bit, the
    bfloat16 one the bfloat16 ``.pth`` run's. Then a ``train_steps``-step
    ``train.loop.main`` run of the training YAML, its trainer directory
    exported with ``--reverse`` (float32, ``model.`` keys, the EMA weights
    bit for bit) and both sampled through the CLI: the same PNG. Every
    forward must launch what the net routes to. Reports each step's
    seconds and the files' bytes."""
    import tempfile

    import numpy as np

    from srgd_tpu_torch import infer
    from srgd_tpu_torch.checkpoint import (convert, load_reference_checkpoint,
                                           load_trained_checkpoint,
                                           restore_params)
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.tools import flagship_ckpt
    from srgd_tpu_torch.train import loop
    here = os.path.dirname(os.path.abspath(__file__))
    conf, train_conf = (os.path.join(here, c) for c in (conf, train_conf))
    res = {'phase': 'convert', 'seconds': {}}
    secs, checks = res['seconds'], {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    reset_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_convert_') as tmp:
        path = lambda *p: os.path.join(tmp, *p)
        pth = path('flagship.pth')
        saved = timed('write_pth', lambda: flagship_ckpt.write_pth(
            pth, dim, seed))
        res['pth'] = {k: saved[k] for k in ('keys', 'params', 'bytes')}
        checks['pth_params'] = (
            dim != 128 or saved['params'] == flagship_ckpt.FLAGSHIP_PARAMS)
        dirs = {'float32': path('dir_float32'), 'bfloat16': path('dir_bf16')}
        for dtype, d in dirs.items():
            timed(f'forward_{dtype}', lambda: convert.main(
                ['-c', conf, '-m', pth, '-o', d, '--param_dtype', dtype]))
        ref = load_reference_checkpoint(pth)
        for dtype, d in dirs.items():
            got = load_trained_checkpoint(d)
            want = {k: v.to(getattr(torch, dtype)) for k, v in ref.items()}
            checks[f'dir_{dtype}_weights'] = (sorted(got) == sorted(want)
                                              and all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want))
        bf16_conf = path('conf_bf16.yaml')
        with open(conf) as f, open(bf16_conf, 'w') as g:
            g.write(f.read() + '\nparam_dtype: bfloat16\n')

        in_dir = path('in')
        os.makedirs(in_dir)
        with open(os.path.join(in_dir, 'x.png'), 'wb') as f:
            f.write(_png(16, 16, seed))
        pngs = {}

        def cli(name, conf_path, ckpt):
            out_dir = path('out', name)
            argv = ['-c', conf_path, '-m', ckpt, '--input_dir', in_dir,
                    '--output_dir', out_dir, *flagship_ckpt.CLI_ARGS,
                    '--device', str(device)]
            timed(f'cli_{name}',
                  lambda: _with_env({}, lambda: infer.main(argv)))
            with open(os.path.join(out_dir, 'x_out.png'), 'rb') as f:
                pngs[name] = _decoded(f.read())

        with _ForwardLedger(device) as ledger:
            cli('pth', conf, pth)
            cli('dir_float32', conf, dirs['float32'])
            cli('pth_bf16', bf16_conf, pth)
            cli('dir_bfloat16', conf, dirs['bfloat16'])
        run_dir = path('run')
        data_dir = path('data')
        os.makedirs(data_dir)
        _synth_pngs(data_dir, images, image_size, seed)
        state = timed('train', lambda: loop.main(
            ['-c', train_conf, '--data_dir', data_dir, '--out_dir', run_dir,
             '--steps', str(train_steps), '--save_every', str(train_steps),
             '--log_every', '1', '--device',
             'cuda:0' if device.type == 'cuda' else 'cpu']))
        trained = os.path.join(run_dir, load_config(train_conf).prefix)
        exported = path('exported.pth')
        timed('reverse', lambda: convert.main(
            ['-c', train_conf, '--reverse', '-m', trained, '-o', exported]))
        res['exported_bytes'] = os.path.getsize(exported)
        ema = restore_params(trained)['ema_params']
        back = torch.load(exported, map_location='cpu',
                          weights_only=True)['ema_model']
        checks['reverse_keys'] = sorted(back) == sorted(
            f'model.{k}' for k in ema)
        checks['reverse_float32_bits'] = all(
            v.dtype == torch.float32 and torch.equal(v, ema[k[len('model.'):]])
            for k, v in back.items())
        del ema, back, state
        with _ForwardLedger(device) as train_ledger:
            cli('trained_dir', train_conf, trained)
            cli('exported_pth', train_conf, exported)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    res['launches'] = read_counts()
    res['seconds']['phase'] = time.perf_counter() - t_phase
    res['nets'] = ledger.runs() + train_ledger.runs()
    for a, b in (('pth', 'dir_float32'), ('pth_bf16', 'dir_bfloat16'),
                 ('exported_pth', 'trained_dir')):
        checks[f'{b}_png_equal'] = (pngs[a].shape == pngs[b].shape
                                    and bool((pngs[a] == pngs[b]).all()))
    checks['png_x4'] = all(p.shape == (64, 64, 3) for p in pngs.values())
    res['bf16_vs_f32_max_png_diff'] = int(np.abs(
        pngs['pth'].astype(int) - pngs['pth_bf16'].astype(int)).max())
    checks['forwards_route'] = ledger.ok and train_ledger.ok
    res['checks'] = checks
    res['ok'] = all(checks.values())
    return res


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
    'groupnorm_silu_fused': 'groupnorm_silu', 'flash': 'attention',
    'flash_mma': 'attention', 'kv_partials': 'linear_attention_qkv',
    'out_rows': 'linear_attention_qkv',
    'kv_partials_mma': 'linear_attention_qkv',
    'out_rows_mma': 'linear_attention_qkv', 'int8_conv_kernel': 'int8_conv',
    'int8_conv_wgmma': 'int8_conv', 'act_amax_partial': 'act_amax',
    'act_amax_final': 'act_amax', 'quantize_act_kernel': 'quantize_act'}
# PyTorch's device kernels that mark QuantConv's activation quantize in
# PyTorch ops (abs before the amax, round before the clip; the clip's clamp
# kernel is RMSNorm's too): an int8 forward on the card must launch none
QUANTIZE_CHAIN = ('abs_kernel', 'round_kernel')
# the float32 device kernels: a bfloat16 net must spend no time in them
F32_ONLY_KERNELS = ('phase_a', 'phase_b', 'flash', 'qkv_proj', 'attend',
                    'kv_partials', 'out_rows')


# spin kernels (``torch.cuda._sleep``) that open every profiler session on
# the card: the profiler drops the records of a session's first device
# kernels, more of them the more device work the process has done
PROFILE_PAD = 64
PAD_KERNEL = 'spin_kernel'


def _device_rows(torch, run, calls: int, on_card: bool, lost=None):
    """(ms per call, launches per call, name) of every device kernel that
    ``run()`` (``calls`` calls of something) launches, largest first. On
    the card the session opens with ``PROFILE_PAD`` spin kernels, left out
    of the rows, to take the records the profiler drops at its start; the
    number it dropped is appended to ``lost`` (a list) and must stay under
    ``PROFILE_PAD`` for ``run()``'s records to be whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        if on_card:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        run()
    attr = 'self_device_time_total' if on_card else 'self_cpu_time_total'
    # on the card kernels only, not the operators over them
    events = [e for e in prof.key_averages() if getattr(e, attr) > 0
              and (not on_card or e.device_type == DeviceType.CUDA)]
    if on_card and lost is not None:
        lost.append(PROFILE_PAD - sum(e.count for e in events
                                      if _function(e.key) == PAD_KERNEL))
    return sorted(((getattr(e, attr) / 1e3 / calls, e.count / calls, e.key)
                   for e in events if _function(e.key) != PAD_KERNEL),
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


def _owner(fn: str, merge_owner: str):
    """The port's kernel a device kernel belongs to, or None; the partial
    merge that two of them share goes to ``merge_owner``, the one the
    profiled net routes to."""
    return merge_owner if fn == 'merge_kv_partials' else DEVICE_KERNELS.get(fn)


def _launches_by_kernel(rows, merge_owner: str) -> dict:
    """Device kernels per call (per forward) of each of the port's kernels."""
    out = {}
    for _, calls, key in rows:
        owner = _owner(_function(key), merge_owner)
        if owner is not None:
            out[owner] = out.get(owner, 0) + calls
    return out


def _by_kernel(rows, merge_owner: str) -> dict:
    """ms per call of each of the port's kernels, summed over its device
    kernels by function name."""
    out = {}
    for ms, calls, key in rows:
        fn = _function(key)
        owner = _owner(fn, merge_owner)
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
                  attn_shapes=ATTN_SHAPES, gn_shapes=GN_SHAPES,
                  linear_shapes=LINEAR_SHAPES, flash_shapes=FLASH_SHAPES,
                  int8_conf=SERVING_YAML, int8_min_channels=512, **net_kw):
    """``torch.profiler`` over ``forwards`` U-Net forwards of the default and
    of the ``use_pallas`` net (b = 8 tiles of 256 px, bf16): self device time
    per kernel name, in ms per forward, largest first, with the sum over all
    kernels beside the host-clock time of a forward, ``by_kernel``: each of
    the port's kernels' time per forward summed over all its launches and
    shapes, ``device_launches_per_forward``: each of the port's kernels'
    device kernels per forward, and ``by_group``: every device kernel's time
    by what it does. A bfloat16 net must spend no time in the float32 device
    kernels. Then ``standalone``: the device time (no host latency, L2 warm)
    of one call of the four tensor-core kernels and of ``groupnorm_silu``
    (with FiLM) at the flagship shapes, ``attention`` beside
    ``F.scaled_dot_product_attention``, of ``attn_block``,
    ``linear_attention_qkv`` and ``groupnorm_silu`` by device kernel, and
    their ``standalone_device_kernels_per_call``, which must be 1 for
    ``groupnorm_silu``. The same breakdown for the int8 net of the serving
    YAML (``quantize: w8a8`` at ``int8_min_channels``, dynamic scales),
    which must launch none of PyTorch's abs or round kernels
    (``QUANTIZE_CHAIN``): its activations are quantized by the port's
    kernels. Not part of the default run: ``python3 chip_smoke.py
    --profile`` adds it."""
    import torch.nn.functional as F

    from srgd_tpu_torch.kernels import attention as at
    from srgd_tpu_torch.kernels import attn_block as ab
    from srgd_tpu_torch.kernels import groupnorm_silu as gs
    from srgd_tpu_torch.kernels import linattn_block as lb
    from srgd_tpu_torch.kernels import linear_attention as la
    on_card = device.type == 'cuda'
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    x = torch.randn((batch_size, 3, tile_size, tile_size), generator=gen,
                    device=device)
    t = torch.zeros(batch_size, device=device)
    res = {'phase': 'profile', 'forwards': forwards, 'nets': {}}
    ok = True
    lost = []   # records the profiler dropped at each session's start
    here = os.path.dirname(os.path.abspath(__file__))
    for name, flags, merge_owner in (
            ('default', {}, 'linattn_block'),
            ('use_pallas', PALLAS_FLAGS, 'linear_attention_qkv'),
            ('int8', None, 'linattn_block')):
        if flags is None:
            net = _int8_wrapper(torch, device, os.path.join(here, int8_conf),
                                'w8a8', int8_min_channels, seed).net
            args = _forward_inputs(torch, device, batch_size, tile_size, seed)
        else:
            net = build_flagship(torch, device, seed=seed, **flags,
                                 **net_kw).net
            args = (x, t, {'cond': x})

        def run(n):
            with torch.inference_mode():
                for _ in range(n):
                    net(args[0], args[1], **args[2])
            if on_card:
                torch.cuda.synchronize()

        run(2)
        t0 = time.perf_counter()
        run(forwards)
        host_ms = (time.perf_counter() - t0) * 1e3 / forwards
        rows = _device_rows(torch, lambda: run(forwards), forwards, on_card,
                            lost)
        by_kernel = _by_kernel(rows, merge_owner)
        f32_ms = sum(ms for k in by_kernel.values()
                     for fn, ms in k['device_kernels'].items()
                     if fn in F32_ONLY_KERNELS)
        res['nets'][name] = {
            'host_ms_per_forward': host_ms,
            'kernel_ms_per_forward': sum(r[0] for r in rows),
            'by_kernel': by_kernel,
            'device_launches_per_forward': _launches_by_kernel(rows,
                                                               merge_owner),
            'by_group': _by_group(rows),
            'ms_in_float32_kernels': f32_ms,
            'top': [{'ms': ms, 'calls': calls, 'name': key[:200]}
                    for ms, calls, key in rows[:top]]}
        ok = ok and sum(r[0] for r in rows) > 0 and f32_ms == 0
        if flags is None:
            chain = [key[:200] for _, _, key in rows
                     if any(s in key for s in QUANTIZE_CHAIN)]
            res['nets'][name]['quantize_chain_kernels'] = chain
            ok = ok and (not on_card or not chain)
        del net

    def device_rows(fn, calls=5):
        def run():
            for _ in range(calls):
                fn()
            if on_card:
                torch.cuda.synchronize()
        run()
        return _device_rows(torch, run, calls, on_card, lost)

    def device_ms(fn):
        return sum(r[0] for r in device_rows(fn))

    def device_split(name, fn):
        """The call's device time, by device kernel in ``split``, and the
        device kernels it launched in ``per_call``."""
        rows = device_rows(fn)
        standalone[name] = sum(r[0] for r in rows)
        split[name] = _by_function(rows)
        per_call[name] = sum(r[1] for r in rows)

    standalone, split, per_call = {}, {}, {}
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
    for rows, c in gn_shapes:
        xs = torch.randn((batch_size, rows, c), generator=gen,
                         device=device).to(torch.bfloat16)
        film = torch.randn((batch_size, 2, c), generator=gen,
                           device=device) * 0.2
        g, z = torch.ones(c, device=device), torch.zeros(c, device=device)
        name = f'groupnorm_silu_{rows}_{c}'
        device_split(name, lambda: gs.groupnorm_silu(xs, g, z, film))
    res['standalone_device_ms'] = standalone
    res['standalone_by_device_kernel'] = split
    res['standalone_device_kernels_per_call'] = per_call
    res['records_lost_at_session_start'] = lost
    # one device kernel a groupnorm_silu call (the CPU runs plain ops), and
    # every session's dropped records inside its padding
    res['ok'] = ok and (not on_card or (all(
        n == 1 for name, n in per_call.items()
        if name.startswith('groupnorm_silu')) and max(lost) < PROFILE_PAD))
    return res


def phase_profile_child(torch, device, timeout_s=900):
    """``phase_profile`` in a fresh child process of this script
    (``--profile-only``), whose failure fails the phase. The profiler drops
    the records of the first device kernels of every session, any kernel's,
    and the more device work the process has done the more of them (PERF.md
    section 7): after the other phases, more than a short session holds.
    ``_device_rows`` opens each session with ``PROFILE_PAD`` spin kernels
    to take the drop; a fresh process keeps the drop well inside them."""
    torch.cuda.empty_cache()    # the child's memory, not this one's cache
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--profile-only'],
        capture_output=True, text=True, timeout=timeout_s,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        res = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        res = {'phase': 'profile', 'ok': False}
    res['child_exit'] = proc.returncode
    if proc.returncode or res.get('phase') != 'profile':
        res['ok'] = False
        res['child_stderr'] = proc.stderr[-3000:]
    return res


def summary(kernels, *paths):
    """One entry per kernel: ``launches``, its launches on the main paths
    (``slice``, ``slice_pallas``, ``deep_cache``, ``families``, ``serve``,
    ``train``, ``int8``, ``mesh``, ``quality``, ``convert``; each run
    counted from 0 around that run alone), the largest error over its
    cases (``int8_conv``'s are the int8 phase's), and the times and bound of
    its first bfloat16 case.
    ``drive_launches`` counts launches outside any path: no module calls
    ``linear_attention``, so its ``launches`` is 0 and the one direct call of
    ``slice_pallas`` stands there."""
    launches = {name: sum(p['launches'][name] for p in paths)
                for name in KERNELS}
    slice_pallas = next(p for p in paths if p['phase'] == 'slice_pallas')
    drive = {**dict.fromkeys(KERNELS, 0),
             'linear_attention': slice_pallas['entry_pair']['drive_launches']}
    cases = kernels['cases'] + [c for p in paths
                                for c in p.get('kernel_cases', ())]
    out = []
    for name, (replaces, source, _, _) in KERNELS.items():
        mine = [c for c in cases if c['kernel'] == name]
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
    if '--profile-only' in sys.argv[1:]:       # phase_profile_child's child
        phase_build()
        res = phase_profile(torch, device)
        emit(res)
        return 0 if res['ok'] else 1
    emit(dev)
    emit(phase_build())
    todo = [phase_kernels, phase_slice, phase_slice_pallas, phase_deep_cache,
            phase_families, phase_serve, phase_train, phase_int8, phase_mesh,
            phase_quality, phase_convert, phase_bench]
    if '--profile' in sys.argv[1:]:
        todo.append(phase_profile_child)
    phases = []
    for phase in todo:
        phases.append(phase(torch, device))
        emit(phases[-1])
        torch.cuda.synchronize()
    table = summary(phases[0], *[p for p in phases
                                 if p['phase'] in MAIN_PATHS])
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
