"""Offline tiled sampling, the batch CLI's work: ``infer.Sampler.sample``
over one photo, call after call, each call the last ``steps_per_call``
steps of the schedule (``generation_start_steps``) with its own noise.

Set-up: the benchmark's weights made on the device from the seed, the
port's model through ``factory.get_model``, the photo made from the seed and
pre-upscaled by the CLI's ``upscale_bicubic``, one warm call of two steps
(one on each grid). Window: calls
until ``seconds`` have passed, closing on a call boundary (each call ends in
its copy to the host). End to end: ``sample_step_ms``, the window's wall
time over the steps it completed. Check: a call drawn from the seed, run
again by the reference (float32, TF32 off) from the same inputs and noise.
A traced run profiles one extra call before the window and times every
forward of the window with CUDA events."""

from __future__ import annotations

import gc
import time

import numpy as np

from perfbench import harness, program, tracing
from perfbench.reference import inputs as ref_inputs
from perfbench.reference.sampler import geometry, grid, tiled_sample
from perfbench.reference.unet import Precision, RefUNet
from perfbench.reference.weights import make_weights


def tiles_per_call(tr: dict, h: int, w: int) -> list:
    """Tiles each step of a call denoises (one canvas)."""
    ph, pw, _, interior = geometry(h, w, tr['tile'])
    n = tr['num_sample_steps']
    return [len(grid(i % 2, ph, pw, interior, tr['tile']))
            for i in range(n - tr['steps_per_call'], n)]


def setup(cell: dict, opts: dict):
    """(sampler, cond_np, lr photo, cfg) on ``opts['device']``."""
    import torch
    from PIL import Image
    from srgd_tpu_torch.factory import get_model
    from srgd_tpu_torch.infer import Sampler, upscale_bicubic
    tr = cell['traffic_data']
    cfg = program.apply_overrides(cell['config_data'], opts.get('overrides'))
    device = torch.device(opts['device'])
    n = tr['num_sample_steps']
    harness.note(opts, 'program imported')
    conf = program.port_config(cfg, continuous_sampler=tr['sampler'],
                               ddim_eta=tr['ddim_eta'], num_sample_steps=n,
                               tile_size=tr['tile'])
    sd = make_weights(cfg['reference'], harness.seed_of(opts['seed'], 'w'),
                      device)
    wrapper, _ = get_model(conf, device=device, state_dict=sd)
    del sd
    harness.note(opts, 'model built with the weights')
    lr = harness.photo(harness.seed_of(opts['seed'], 'photo'),
                       *tr['lr_size'])
    cond_np = np.asarray(upscale_bicubic(Image.fromarray(lr)),
                         np.float32)[None] / 255.0
    sopts = dict(batch_size=tr['batch_size'], tile_size=tr['tile'],
                 tile_stride=None, cond_scale=1.0, guidance_start_steps=0,
                 class_cond_scale=1.0, class_guidance_start_steps=0,
                 generation_start_steps=n - tr['steps_per_call'],
                 num_sample_steps=n, model=conf.model)
    sampler = Sampler(wrapper, sopts, device,
                      noise_for_seed=harness.SeededNoise)
    return sampler, cond_np, lr, cfg


def call_seed(seed: int, k: int) -> int:
    return harness.seed_of(seed, 'call', k)


def reference_call(cfg: dict, tr: dict, lr: np.ndarray, seed: int, k: int,
                   device, precision: Precision | None = None):
    """The reference's output of call ``k`` of a run of ``seed``: its own
    weights, upscale and noise. (1, H, W, C) float32 numpy in [0, 1]."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = make_weights(cfg['reference'], harness.seed_of(seed, 'w'), device)
    net = RefUNet(cfg['reference'], sd, precision)
    cond = torch.from_numpy(ref_inputs.upscale(lr))[None].to(device)
    label = torch.tensor([tr['label']], device=device)
    n = tr['num_sample_steps']
    with torch.no_grad():
        out = tiled_sample(net, cond, label,
                           harness.SeededNoise(call_seed(seed, k), device),
                           n_steps=n, start=n - tr['steps_per_call'],
                           tile=tr['tile'], sampler=tr['sampler'],
                           eta=tr['ddim_eta'], chunk=tr['batch_size'])
    return out.cpu().numpy()


def gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers compared: the RMS and the widest gap between the
    program's output and the reference's, in [0, 1] pixel units (inf where
    the shapes differ or the program's output is not finite)."""
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return {'rms_gap': float('inf'), 'max_gap': float('inf')}
    d = prog.astype(np.float64) - ref.astype(np.float64)
    return {'rms_gap': float(np.sqrt(np.mean(d * d))),
            'max_gap': float(np.max(np.abs(d)))}


def release(wrapper) -> None:
    """Free the program's model on the device before the reference runs."""
    import torch
    wrapper.net = wrapper.net_apply = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: dict, opts: dict) -> dict:
    import torch
    tr = cell['traffic_data']
    seed, trace = opts['seed'], opts['trace']
    sampler, cond_np, lr, cfg = setup(cell, opts)
    if opts.get('fault'):
        from perfbench.tests import faults
        faults.apply(opts['fault'], sampler)
    cuda = sampler.device.type == 'cuda'

    def call(k):
        return sampler.sample(cond_np, tr['label'], call_seed(seed, k))

    # warm: every shape and the build, in two steps (one on each grid)
    full = sampler.opts
    sampler.opts = dict(full, generation_start_steps=tr['num_sample_steps']
                        - min(2, tr['steps_per_call']))
    call(-1)
    sampler.opts = full
    harness.note(opts, 'warm')
    if cuda:
        torch.cuda.synchronize()
    record = harness.Record()
    per_call = tiles_per_call(tr, *cond_np.shape[1:3])
    if trace:
        wrapper = sampler.wrapper
        plain = wrapper.net_apply
        wrapper.net_apply = tracing.ForwardMarks(torch, sampler.device).wrap(
            plain)
        tracing.profiled(torch, lambda: call(-2), record)
        record.counters['profiled_tiles'] = sum(per_call)
        spans = harness.CudaSpans(torch, record)
        wrapper.net_apply = spans.wrap(plain, 'forward',
                                       lambda x, *a, **k: x.shape[0])
    setup_s = time.perf_counter() - opts['t_start']

    outs, k = [], 0
    t0 = time.perf_counter()
    while True:
        outs.append(call(k))
        k += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= opts['seconds']:
            break
    steps = k * tr['steps_per_call']
    if trace:
        spans.flush()
        record.counters.update(steps=steps, window_s=elapsed,
                               real_tiles=k * sum(per_call),
                               chips=cell['chips'])
    device = harness.device_info(torch, 1) if cuda else None

    pick = [harness.seed_of(seed, 'check', j) % k
            for j in range(tr['checked_calls'])]
    kept = {j: outs[j] for j in pick}
    del outs
    release(sampler.wrapper)
    worst = {'rms_gap': 0.0, 'max_gap': 0.0}
    for j, out in kept.items():
        ref = reference_call(cfg, tr, lr, seed, j, opts['device'])
        for name, v in gaps(out, ref).items():
            worst[name] = max(worst[name], v)
    return {'attempted': k, 'failed': 0, 'setup_s': setup_s,
            'e2e': {'sample_step_ms': elapsed * 1e3 / steps},
            'checks': worst, 'record': record, 'device': device}


def readings(cell: dict, opts: dict, control: bool) -> dict:
    """The numbers compared, for setting limits: the program's (one call of
    a fresh set-up on ``opts['seed']``) against the reference, and with
    ``control`` the control's (the reference in fp8, in the program's
    place) against the same reference."""
    tr = cell['traffic_data']
    seed = opts['seed']
    sampler, cond_np, lr, cfg = setup(cell, opts)
    if opts.get('fault'):
        from perfbench.tests import faults
        faults.apply(opts['fault'], sampler)
    out = sampler.sample(cond_np, tr['label'], call_seed(seed, 0))
    release(sampler.wrapper)
    ref = reference_call(cfg, tr, lr, seed, 0, opts['device'])
    res = {'program': gaps(out, ref)}
    if control:
        low = reference_call(cfg, tr, lr, seed, 0, opts['device'],
                             Precision('fp8'))
        res['control'] = gaps(low, ref)
    return res
