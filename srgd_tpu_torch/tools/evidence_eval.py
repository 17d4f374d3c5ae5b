"""End-to-end SR quality of a trained checkpoint through the port: the
counterpart of ``tools/evidence_eval.py``.

    python -m srgd_tpu_torch.tools.evidence_eval

The real tiled sampler runs on held-out procedural images (``synth``)
degraded by the training pipeline (``train.data.degrade``), and prints the
JAX tool's three tables:

1. PSNR(SR, HR) against PSNR(condition, HR) for each degradation class: the
   model must beat its own input;
2. the few-step ladder (``EV_LADDER_MODES``, sampler[:eta]-steps) against
   the ancestral baseline at ``EV_BASE_STEPS``, per canvas and summarised
   over canvases;
3. with ``EV_CFG=1``, the classifier-free guidance ladder (``run_cfg_ladder``):
   class scales, guidance warm-up, the condition axis, and wrong-label
   controls.

Env: EV_CKPT (a checkpoint directory the port's trainer wrote; its EMA
weights are sampled), EV_CONF (conf/trained_evidence_dim64_synth.yaml),
EV_HR (512: HR eval size), EV_IMAGES (2), EV_SEED (12345: held-out
generator seed), EV_BASE_STEPS (250), EV_TILE (256), EV_LADDER_CLASSES
('0,1,2'), EV_LADDER_IMAGES (2), EV_LADDER_MODES, EV_CFG and the EV_CFG_*
knobs of ``run_cfg_ladder``; and EV_DEVICE (cuda; ``cpu`` runs the kernels'
plain versions). Computes in bf16 with bf16 weights, as the JAX tool casts
its params; every sample draws from ``GeneratorNoise(71)``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

import numpy as np
import torch

from srgd_tpu_torch.checkpoint import restore_params
from srgd_tpu_torch.config import load_config
from srgd_tpu_torch.diffusion.base import GeneratorNoise
from srgd_tpu_torch.factory import build_wrapper, get_model
from srgd_tpu_torch.infer import resolve_device
from srgd_tpu_torch.tools.synth import make_image
from srgd_tpu_torch.train.data import DegradeConfig, degrade

NOISE_SEED = 71
SAMPLERS = (('ancestral', 0.0), ('ddim', 0.0), ('ddim:0.3', 0.3),
            ('ddim:1.0', 1.0), ('dpmpp', 0.0))


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return -10 * np.log10(max(mse, 1e-20))


def build_wrappers(conf, weights: dict, device) -> dict:
    """One wrapper per sampler name of ``SAMPLERS`` around one bf16 net
    holding ``weights``."""
    conf = dataclasses.replace(conf, compute_dtype='bfloat16',
                               param_dtype='bfloat16')
    wrapper, net = get_model(conf, '', device=device, state_dict=weights)
    log_snr = getattr(wrapper, 'log_snr', None)
    return {name: build_wrapper(dataclasses.replace(
                conf, continuous_sampler=name.split(':')[0], ddim_eta=eta),
                net, log_snr)
            for name, eta in SAMPLERS}


def make_sampler(wrappers: dict, device, tile: int,
                 noise_for_seed=GeneratorNoise):
    """``sample(cond01, label, steps, sampler, **guidance)`` -> (HR output
    (H, W, 3) float32 numpy, seconds): one tiled run on one canvas, its
    noise from ``noise_for_seed(71, device)``."""
    def sample(cond01, label, steps, sampler, **guidance):
        t0 = time.perf_counter()
        out = wrappers[sampler].tiled_sample(
            torch.from_numpy(np.ascontiguousarray(cond01))[None].to(device),
            torch.tensor([label], device=device), batch_size=8,
            tile_size=tile, num_sample_steps=steps,
            noise=noise_for_seed(NOISE_SEED, device), **guidance)
        out = out[0].float().cpu().numpy()
        return out, time.perf_counter() - t0
    return sample


def main(noise_for_seed=GeneratorNoise):
    env = os.environ.get
    ckpt = env('EV_CKPT', '')
    conf = load_config(env('EV_CONF', 'conf/trained_evidence_dim64_synth.yaml'))
    hr_size = int(env('EV_HR', 512))
    n_images = int(env('EV_IMAGES', 2))
    seed = int(env('EV_SEED', 12345))
    # the reference's default step count; lower for quick checks
    base_steps = int(env('EV_BASE_STEPS', 250))
    tile = int(env('EV_TILE', 256))
    device = resolve_device(env('EV_DEVICE', 'cuda'))

    if not ckpt:
        raise SystemExit('EV_CKPT must name a checkpoint directory of the '
                         "port's trainer")
    raw = restore_params(ckpt)
    step = int(np.asarray(raw.get('step', 0)))
    wrappers = build_wrappers(conf, dict(raw['ema_params']), device)
    print(f'loaded EMA weights at train step {step} from {ckpt}', flush=True)

    gen = np.random.default_rng(seed)
    dcfg = DegradeConfig.from_conf(conf)
    sample = make_sampler(wrappers, device, tile, noise_for_seed)

    # -- 1. SR beats its degraded input, per class -------------------------
    classes = {0: 'realsr', 1: 'denoise', 2: 'sr'}
    if n_images <= 0:
        classes = {}
        print('per-class input-vs-SR section skipped (EV_IMAGES=0)',
              flush=True)
    for label, cname in classes.items():
        d_in, d_sr = [], []
        for i in range(n_images):
            hr = make_image(gen, hr_size)              # uint8 HxWx3
            cond = degrade(hr, label, gen, cfg=dcfg)    # degraded, HR-sized
            hr01 = hr.astype(np.float32) / 255.0
            cond01 = cond.astype(np.float32) / 255.0
            out, dt = sample(cond01, label, base_steps, 'ancestral')
            d_in.append(psnr(cond01, hr01))
            d_sr.append(psnr(out, hr01))
        print(f'class {label} ({cname}): input {np.mean(d_in):.2f} dB -> '
              f'SR {np.mean(d_sr):.2f} dB over {n_images} held-out images '
              f'({hr_size}px, {base_steps} ancestral steps)', flush=True)

    # -- 2. The few-step sampler ladder: per (class, canvas) an ancestral
    # baseline at base_steps and every ladder mode; the summary gives the
    # mean and the min-max spread over canvases.
    ladder_classes = [int(c) for c in env(
        'EV_LADDER_CLASSES', '0,1,2').split(',') if c != '']
    ladder_images = int(env('EV_LADDER_IMAGES', 2))
    ladder = [tuple(m.rsplit('-', 1)) for m in env(
        'EV_LADDER_MODES',
        'ddim-250,ddim-25,dpmpp-25,ddim:0.3-25,'
        'ddim:1.0-50,ddim:1.0-25').split(',')]
    ladder = [(m, int(s)) for m, s in ladder]
    # the baseline runs anyway: a ladder entry equal to it would reset its
    # bucket and sample every canvas twice
    ladder = [k for k in ladder if k != ('ancestral', base_steps)]
    if not ladder_classes or ladder_images <= 0:
        print('few-step ladder skipped (EV_LADDER_CLASSES/EV_LADDER_IMAGES)',
              flush=True)
        return run_cfg_ladder(sample, hr_size, gen, dcfg)
    # rows[(mode, steps)] = list of (dB vs HR, dB vs baseline, seconds)
    rows = {('ancestral', base_steps): []}
    rows.update({k: [] for k in ladder})
    # per-class input PSNR and per-mode SR PSNR: "SR beats its input" per
    # mode, not only for the baseline
    inp_by_class = {c: [] for c in ladder_classes}
    mode_by_class = {}
    for label in ladder_classes:
        for i in range(ladder_images):
            hr = make_image(gen, hr_size)
            cond = degrade(hr, label, gen, cfg=dcfg)
            hr01 = hr.astype(np.float32) / 255.0
            cond01 = cond.astype(np.float32) / 255.0
            inp_by_class[label].append(psnr(cond01, hr01))
            base, dt = sample(cond01, label, base_steps, 'ancestral')
            rows[('ancestral', base_steps)].append((psnr(base, hr01), np.inf,
                                                    dt))
            mode_by_class.setdefault(
                ('ancestral', base_steps), {}).setdefault(label, []).append(
                    psnr(base, hr01))
            print(f'class {label} canvas {i}: input {psnr(cond01, hr01):.2f} '
                  f'dB; ancestral {base_steps} '
                  f'{psnr(base, hr01):.2f} dB vs HR ({dt:.0f}s)', flush=True)
            for mode, steps in ladder:
                out, dt = sample(cond01, label, steps, mode)
                rows[(mode, steps)].append(
                    (psnr(out, hr01), psnr(out, base), dt))
                mode_by_class.setdefault(
                    (mode, steps), {}).setdefault(label, []).append(
                        psnr(out, hr01))
                print(f'  {mode} {steps:3d}: {psnr(out, hr01):.2f} dB vs '
                      f'HR, {psnr(out, base):.2f} dB vs ancestral-{base_steps} '
                      f'({dt:.0f}s)', flush=True)
    n = len(rows[('ancestral', base_steps)])
    print(f'\nfew-step summary over {n} canvases '
          f'({len(ladder_classes)} classes x {ladder_images}):', flush=True)
    base_hr = np.mean([r[0] for r in rows[('ancestral', base_steps)]])
    for (mode, steps), vals in rows.items():
        vs_hr = [v[0] for v in vals]
        secs = [v[2] for v in vals]
        d = np.mean(vs_hr) - base_hr
        beats = sum(
            np.mean(mode_by_class[(mode, steps)][c])
            > np.mean(inp_by_class[c]) for c in ladder_classes)
        print(f'  {mode:10s} {steps:3d}: {np.mean(vs_hr):6.2f} dB vs HR '
              f'(min {np.min(vs_hr):.2f} max {np.max(vs_hr):.2f}, '
              f'{d:+.2f} vs anc{base_steps} mean), beats input on {beats}/'
              f'{len(ladder_classes)} classes, {np.mean(secs):5.1f} s/image',
              flush=True)
    run_cfg_ladder(sample, hr_size, gen, dcfg)


# the lines of the three tables: section 1's per class, the few-step
# summary's per mode and the CFG summary's per variant
PER_CLASS_RE = re.compile(
    r'^class (?P<label>\d) \((?P<name>\w+)\): input (?P<input>\S+) dB -> '
    r'SR (?P<sr>\S+) dB over (?P<images>\d+) held-out images', re.M)
LADDER_RE = re.compile(
    r'^  (?P<mode>\S+)\s+(?P<steps>\d+): +(?P<vs_hr>\S+) dB vs HR \(min '
    r'(?P<min>\S+) max (?P<max>\S+), (?P<delta>\S+) vs anc\d+ mean\), beats '
    r'input on (?P<beats>\d+)/\d+ classes, +(?P<seconds>\S+) s/image', re.M)
CFG_RE = re.compile(
    r'^  (?P<tag>.+?)\s*: (?P<classes>class\d.+?) \| beats input '
    r'(?P<beats>\d+)/\d+, +(?P<seconds>\S+) s/image', re.M)


def parse_tables(text: str) -> dict:
    """The rows of the three tables in either tool's output: 'per_class',
    'ladder' (the few-step summary) and 'cfg' (the CFG summary), each a
    list of dicts of the row's fields, numbers as floats; a CFG row's
    'classes' maps each class to (dB vs HR, delta)."""
    def rows(pattern, part):
        out = []
        for m in pattern.finditer(part):
            row = {}
            for k, v in m.groupdict().items():
                try:
                    row[k] = float(v)
                except ValueError:
                    row[k] = v
            out.append(row)
        return out
    ladder = text.partition('few-step summary')[2].partition('CFG ladder')[0]
    cfg = rows(CFG_RE, text.partition('CFG summary')[2])
    for row in cfg:
        row['classes'] = {
            int(c): (float(db), float(d)) for c, db, d in re.findall(
                r'class(\d) +(\S+) dB \((\S+)\)', row['classes'])}
    return {'per_class': rows(PER_CLASS_RE, text),
            'ladder': rows(LADDER_RE, ladder), 'cfg': cfg}


def run_cfg_ladder(sample, hr_size, gen, dcfg):
    """Section 3: the classifier-free guidance ladder.

    Per (class, canvas): a baseline without guidance (every scale 1.0),
    then each guidance variant, with PSNR against HR, its difference from
    the baseline, and its time (guidance doubles the net's batch). The
    wrong-label runs (label (l + 1) % 3) show whether the class embedding
    carries class-specific signal at all: if they tie the right label, a
    sweep of the class scale means nothing.

    Env: EV_CFG=1 enables; EV_CFG_CLASSES ('0,2'), EV_CFG_IMAGES (2),
    EV_CFG_MODE ('ddim:1.0-50'), EV_CFG_CLASS_SCALES ('1.5,2,3'),
    EV_CFG_WARM ('2@10': scale@class_guidance_start_steps points),
    EV_CFG_COND_SCALES ('1.5,2': the LR-condition axis), EV_CFG_WRONG ('1,2':
    class scales run with the wrong label). No variant sets both axes:
    the samplers refuse it, as the reference does.
    """
    env = os.environ.get
    if env('EV_CFG', '') != '1':
        return
    cfg_classes = [int(c) for c in env('EV_CFG_CLASSES', '0,2').split(',')
                   if c != '']
    cfg_images = int(env('EV_CFG_IMAGES', 2))
    mode, _, s = env('EV_CFG_MODE', 'ddim:1.0-50').rpartition('-')
    steps = int(s)
    class_scales = [float(v) for v in env(
        'EV_CFG_CLASS_SCALES', '1.5,2,3').split(',') if v]
    warm = [tuple(map(float, v.split('@'))) for v in env(
        'EV_CFG_WARM', '2@10').split(',') if v]
    cond_scales = [float(v) for v in env(
        'EV_CFG_COND_SCALES', '1.5,2').split(',') if v]
    wrong = [float(v) for v in env('EV_CFG_WRONG', '1,2').split(',') if v]

    # (tag, label_permute, guidance kwargs); baseline first
    variants = [('base s=1', False, {})]
    variants += [(f'class s={v:g}', False, {'class_cond_scale': v})
                 for v in class_scales]
    variants += [(f'class s={v:g}@w{int(w)}', False,
                  {'class_cond_scale': v, 'class_guidance_start_steps': int(w)})
                 for v, w in warm]
    variants += [(f'cond s={v:g}', False, {'cond_scale': v})
                 for v in cond_scales]
    variants += [(f'WRONG-label s={v:g}', True,
                  {'class_cond_scale': v} if v != 1.0 else {})
                 for v in wrong]

    print(f'\nCFG ladder ({mode}-{steps}, classes {cfg_classes}, '
          f'{cfg_images} canvases each):', flush=True)
    # res[tag][class] = list of dB vs HR
    res = {tag: {} for tag, _, _ in variants}
    secs = {tag: [] for tag, _, _ in variants}
    inp = {c: [] for c in cfg_classes}
    for label in cfg_classes:
        for i in range(cfg_images):
            hr = make_image(gen, hr_size)
            cond = degrade(hr, label, gen, cfg=dcfg)
            hr01 = hr.astype(np.float32) / 255.0
            cond01 = cond.astype(np.float32) / 255.0
            inp[label].append(psnr(cond01, hr01))
            print(f'class {label} canvas {i}: input '
                  f'{inp[label][-1]:.2f} dB', flush=True)
            for tag, permute, gk in variants:
                lbl = (label + 1) % 3 if permute else label
                out, dt = sample(cond01, lbl, steps, mode, **gk)
                res[tag].setdefault(label, []).append(psnr(out, hr01))
                secs[tag].append(dt)
                print(f'  {tag:18s}: {res[tag][label][-1]:.2f} dB vs HR '
                      f'({dt:.0f}s)', flush=True)
    print(f'\nCFG summary ({mode}-{steps}; delta vs the same-canvas '
          f'no-guidance baseline):', flush=True)
    base = res['base s=1']
    for tag, _, _ in variants:
        per_cls = []
        for c in cfg_classes:
            d = np.mean(res[tag][c]) - np.mean(base[c])
            per_cls.append(f'class{c} {np.mean(res[tag][c]):6.2f} dB '
                           f'({d:+.2f})')
        beats = sum(np.mean(res[tag][c]) > np.mean(inp[c])
                    for c in cfg_classes)
        print(f'  {tag:18s}: ' + ' | '.join(per_cls) +
              f' | beats input {beats}/{len(cfg_classes)}, '
              f'{np.mean(secs[tag]):5.1f} s/image', flush=True)


if __name__ == '__main__':
    main()
