"""Training steps, the trainer's work: ``train.trainer.make_train_step``'s
step fed as ``train.loop.train`` feeds it (``train.data``'s Real-ESRGAN
degradation on the configuration's data threads, ``ordered_batches``, the
device prefetcher), the loss read back every step as the loop does.

Set-up: synthetic photos made from the seed, written as PNGs into a fresh
directory under ``TMPDIR`` (removed at the end); the net with the
benchmark's weights, the optimizer and its schedule, the EMA and the step,
built once; the first ``checked_steps`` steps, which warm every shape,
taken from the same feed through the same call, their batches and the
optimizer state they leave kept on the device for the check. Window: steps
until ``seconds`` have passed (a traced run profiles two more after it).
End to end: ``train_step_ms``, the window's wall time over its steps, the
wait for data included.

Check: the reference follows the first steps from the batches the feed
produced (the program's state at the data boundary): its own draws (the
step's documented generator and order), loss, gradients in float32 and
AdamW with its schedule, from the same weights; it compares the first
gradient as the optimizer got it (Adam's first moment after one step over
1 - b1) and the parameters' change after the checked steps, leaf by
leaf. One step inside the window, drawn from the seed, is followed from
the program's own state before it (parameters, Adam's moments, the step
count, the batch), all kept on the device around that step: its change,
compared the same way (its gradient is read, not compared). The kept batches are judged on
their own against the benchmark's photos and the classes
(``reference.data``).
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np

from perfbench import harness, program, tracing
from perfbench.reference import data as ref_data
from perfbench.reference.unet import Precision, RefUNet
from perfbench.reference.weights import make_weights


def write_photos(seed: int, n: int, size: int) -> str:
    from PIL import Image
    root = tempfile.mkdtemp(prefix='perfbench_train_')
    for i in range(n):
        Image.fromarray(harness.photo(harness.seed_of(seed, 'photo', i),
                                      size, size)).save(
            os.path.join(root, f'{i:04d}.png'))
    return root


def setup(cell: dict, opts: dict):
    import torch
    from srgd_tpu_torch.factory import build_wrapper
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    from srgd_tpu_torch.train import data as data_mod
    from srgd_tpu_torch.train.loop import _DevicePrefetcher, ordered_batches
    from srgd_tpu_torch.train.trainer import (
        create_train_state, make_optimizer, make_train_step,
        trainable_params)
    tr = cell['traffic_data']
    cfg = program.apply_overrides(cell['config_data'], opts.get('overrides'))
    seed = opts['seed']
    device = torch.device(opts['device'])
    harness.note(opts, 'program imported')
    root = write_photos(seed, tr['images'], tr['image_size'])
    harness.note(opts, 'photos written')
    conf = program.port_config(cfg, **tr.get('conf', {}))
    net = build_unet_from_config(conf, device=device).train()
    wrapper = build_wrapper(conf, net)
    sd = make_weights(cfg['reference'], harness.seed_of(seed, 'w'), device)
    net.load_state_dict(sd)
    del sd
    params = trainable_params(wrapper)
    optimizer = make_optimizer(conf, params,
                               steps_per_epoch=tr['steps_per_epoch'])
    state = create_train_state(params, optimizer)
    step_fn = make_train_step(wrapper, conf.ema_decay, True,
                              train_seed(seed))
    scale = conf.hr_image_size // conf.lr_image_size
    ds = data_mod.DegradationDataset(
        root, crop_size=conf.hr_image_size, batch_size=conf.batch_size,
        num_classes=conf.num_classes, hflip=conf.hflip, rotate=conf.rotate,
        seed=harness.seed_of(seed, 'data') % 2 ** 31,
        num_workers=conf.num_workers,
        degrade_cfg=data_mod.DegradeConfig.from_conf(conf),
        preprocess=conf.train_preprocess, scale_size=conf.scale_size,
        scale=scale, crop_rate=conf.crop_rate,
        crop_size_limit=conf.crop_size_limit, n_fold=conf.n_fold,
        fold=conf.train_fold, fold_role='train', shuffle=conf.shuffle,
        as_uint8=True)
    # the degradation imports scipy inside its data threads, and two first
    # imports racing each other leave scipy half initialised: every data
    # thread then dies and the feed waits for ever. Imported here first.
    import scipy.signal   # noqa: F401
    import scipy.special  # noqa: F401
    batches = ordered_batches(ds)
    feed = _DevicePrefetcher(batches, device)
    harness.note(opts, 'trainer built')
    return dict(conf=conf, cfg=cfg, wrapper=wrapper, state=state,
                step_fn=step_fn, feed=feed, batches=batches, root=root,
                device=device)


def train_seed(seed: int) -> int:
    """The step's draw seed: below 2^31, so (seed << 32) + step fits."""
    return harness.seed_of(seed, 'draws') % 2 ** 31


def release(t: dict) -> None:
    """Stop the feed (its thread first, then the data threads) and free
    the program's model and state on the device."""
    import torch
    t['feed'].close()
    t['feed']._thread.join(timeout=30)
    try:
        t['batches'].close()
    except ValueError:          # still running in a thread that outlived
        pass                    # the join: its data threads are daemons
    shutil.rmtree(t['root'], ignore_errors=True)
    for k in ('wrapper', 'state', 'step_fn', 'feed', 'batches'):
        t.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def window_step(seed: int, tr: dict) -> int:
    """The window's step whose state is kept for the check (from 0)."""
    return harness.seed_of(seed, 'window_step') % tr['window_check_span']


def take_step(t: dict, span=None, keep: dict | None = None) -> None:
    """One step through the feed and the step, as the window takes them,
    the loss read back; with ``keep``, the program's state around it (see
    ``snapshot``)."""
    t0 = time.perf_counter()
    hr, cond, label = next(t['feed'])
    if span is not None:
        span('data_wait', (time.perf_counter() - t0) * 1e3)
    if keep is not None:
        snapshot(t['state'], (hr, cond, label), keep)
    float(t['step_fn'](t['state'], hr, cond, label))
    if keep is not None:
        snapshot_after(t['state'], keep)


def snapshot(state, batch, keep: dict) -> None:
    """The state a step starts from, on the device: its batch, step count,
    float32 parameters and Adam's moments and count."""
    import torch
    opt = state.optimizer
    keep.update(step=state.step, count=0, params={}, mu={}, nu={},
                batch=tuple(a.clone() for a in batch))
    for name, p in state.params.items():
        keep['params'][name] = p.detach().float().clone()
        st = opt.state.get(p) or {}
        keep['mu'][name] = (st['mu'].float().clone() if 'mu' in st
                            else torch.zeros_like(keep['params'][name]))
        keep['nu'][name] = (st['nu'].float().clone() if 'nu' in st
                            else torch.zeros_like(keep['params'][name]))
        keep['count'] = max(keep['count'], st.get('count', 0))


def snapshot_after(state, keep: dict) -> None:
    """The step's gradient as the optimizer got it ((mu' - b1 mu) / (1 -
    b1)) and the parameters' change, for the leaves it moved."""
    opt = state.optimizer
    b1 = opt.param_groups[0]['b1']
    keep['grad'], keep['change'] = {}, {}
    for name, p in state.params.items():
        st = opt.state.get(p) or {}
        if 'mu' in st:
            keep['grad'][name] = (st['mu'].float() - b1 * keep['mu'][name]) \
                / (1 - b1)
        keep['change'][name] = p.detach().float() - keep['params'][name]


def first_steps(t: dict, n: int) -> dict:
    """The first ``n`` steps through the feed and the step: their batches,
    losses, the first gradient as Adam's first moment after step 1 holds
    it, and the parameters after step n."""
    state, opt = t['state'], t['state'].optimizer
    kept = {'batches': [], 'losses': []}
    for k in range(n):
        hr, cond, label = next(t['feed'])
        kept['batches'].append((hr.clone(), cond.clone(), label.clone()))
        kept['losses'].append(float(t['step_fn'](state, hr, cond, label)))
        if k == 0:
            b1 = opt.param_groups[0]['b1']
            kept['grad'] = {name: opt.state[p]['mu'].detach().float()
                            / (1 - b1) for name, p in state.params.items()
                            if p in opt.state}
    kept['params'] = {name: p.detach().float().clone()
                      for name, p in state.params.items()}
    return kept


def run(cell: dict, opts: dict) -> dict:
    import torch
    tr = cell['traffic_data']
    seed, trace = opts['seed'], opts['trace']
    t = setup(cell, opts)
    if opts.get('fault'):
        from perfbench.tests import faults
        faults.apply_train(opts['fault'], t)
    cuda = t['device'].type == 'cuda'
    try:
        kept = first_steps(t, tr['checked_steps'])
        harness.note(opts, 'first steps')
        record = harness.Record()
        checked, snap = window_step(seed, tr), {}
        setup_s = time.perf_counter() - opts['t_start']
        steps, t0 = 0, time.perf_counter()
        while True:
            take_step(t, record.span if trace else None,
                      snap if steps == checked else None)
            steps += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= opts['seconds'] and steps > checked:
                break
        if trace:
            # after the window: the allocator still grows in the steps
            # right after the first ones (cudaMalloc gaps of 17-58 ms)
            tracing.profiled(torch, lambda: [take_step(t) for _ in
                                             range(tr['profile_steps'])],
                             record)
        record.counters.update(
            steps=steps, window_s=elapsed, chips=cell['chips'],
            real_tiles=steps * t['conf'].batch_size * 3)
        device = harness.device_info(torch, 1) if cuda else None
    finally:
        conf, cfg, dev = t['conf'], t['cfg'], t['device']
        release(t)
    checks = readings_of(cfg, conf, tr, seed, kept, snap, dev)['program']
    return {'attempted': steps, 'failed': 0, 'setup_s': setup_s,
            'e2e': {'train_step_ms': elapsed * 1e3 / steps},
            'checks': checks, 'record': record, 'device': device}


class Draws:
    """The step's draws as the trainer documents them: one generator on the
    device seeded (seed << 32) + step, drawn in the loss's order: times
    (B,) uniform, noise (B, H, W, C) normal, then the whole-batch condition
    and class dropout uniforms."""

    def __init__(self, seed: int, step: int, device):
        import torch
        self.gen = torch.Generator(device=device).manual_seed(
            (seed << 32) + step)
        self.device = device

    def uniform(self, shape):
        import torch
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device, dtype=torch.float32)

    def normal(self, shape):
        import torch
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.float32)


def lr_at(conf, steps_per_epoch: int, count: int) -> float:
    """The cosine schedule with linear warm-up (optax's formulas, float32)
    at step ``count``; only the warm-up and its end are reached here."""
    f32 = np.float32
    warmup = max(conf.warmup_epochs * steps_per_epoch, 1)
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float(f32(conf.warmup_lr_init - conf.lr) * frac + f32(conf.lr))
    raise ValueError('the check reaches only the warm-up')


def reference_steps(cfg: dict, conf, tr: dict, seed: int, kept: dict,
                    device, precision=None) -> dict:
    """The reference's losses, first gradient and parameters after the
    checked steps, from the benchmark's weights and the kept batches."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              make_weights(cfg['reference'], harness.seed_of(seed, 'w'),
                           device).items()}
    net = RefUNet(cfg['reference'], params, precision)
    net.p = params                      # keep the leaves, not float() copies
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {'losses': []}
    for step, batch in enumerate(kept['batches']):
        out['losses'].append(loss_backward(net, params, conf, tr, seed, step,
                                           batch, device))
        if step == 0:
            out['grad'] = {k: v.grad.detach().clone()
                           for k, v in params.items()}
        adamw(params, mu, nu, step + 1,
              lr_at(conf, tr['steps_per_epoch'], step), conf.weight_decay)
    out['params'] = {k: v.detach() for k, v in params.items()}
    return out


def reference_window_step(cfg: dict, conf, tr: dict, seed: int, snap: dict,
                          device, precision=None) -> dict:
    """The reference's gradient and change of the window's kept step,
    from the program's state before it: its parameters, Adam's moments and
    count, its batch and step index."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.clone().requires_grad_(True)
              for k, v in snap['params'].items()}
    net = RefUNet(cfg['reference'], params, precision)
    net.p = params
    loss = loss_backward(net, params, conf, tr, seed, snap['step'],
                         snap['batch'], device)
    grad = {k: v.grad.detach().clone() for k, v in params.items()}
    mu = {k: v.clone() for k, v in snap['mu'].items()}
    nu = {k: v.clone() for k, v in snap['nu'].items()}
    adamw(params, mu, nu, snap['count'] + 1,
          lr_at(conf, tr['steps_per_epoch'], snap['step']),
          conf.weight_decay)
    return {'loss': loss, 'grad': grad,
            'change': {k: v.detach() - snap['params'][k]
                       for k, v in params.items()}}


def loss_backward(net, params: dict, conf, tr: dict, seed: int, step: int,
                  batch, device) -> float:
    """Step ``step``'s loss on ``batch`` with its own draws, its gradients
    left in ``params``' ``.grad`` (micro-batches, float32)."""
    import torch
    import torch.nn.functional as F
    hr, cond, label = batch
    b = hr.shape[0]
    draws = Draws(train_seed(seed), step, device)
    times = draws.uniform((b,))
    noise = draws.normal(hr.shape)
    drop_cond = draws.uniform(()) < conf.cond_drop_prob
    drop_class = draws.uniform(()) < conf.class_cond_drop_prob
    x0 = hr.float() / 255.0 * 2 - 1
    c = cond.float() / 255.0 * 2 - 1
    c = torch.where(drop_cond, torch.zeros_like(c), c)
    mask = torch.where(drop_class, 0.0, 1.0) * torch.ones(b, device=device)
    log_snr = -torch.log(torch.clamp_min(
        torch.expm1(1e-4 + 10 * times ** 2), 1e-20))
    s = log_snr[:, None, None, None]
    x = x0 * torch.sqrt(torch.sigmoid(s)) + noise * torch.sqrt(
        torch.sigmoid(-s))
    for v in params.values():
        v.grad = None
    total, mb = 0.0, tr['micro_batch']
    for lo in range(0, b, mb):
        sl = slice(lo, lo + mb)

        def nchw(a):
            return a[sl].permute(0, 3, 1, 2).contiguous()
        eps_hat = net(nchw(x), log_snr[sl], nchw(c), label[sl].long(),
                      mask[sl])
        per = F.mse_loss(eps_hat, nchw(noise), reduction='none').mean(
            dim=(1, 2, 3))
        part = per.sum() / b
        part.backward()
        total += float(part.detach())
    return total


def adamw(params: dict, mu: dict, nu: dict, n: int, lr: float,
          weight_decay: float) -> None:
    """AdamW's n-th update of ``params`` from their ``.grad``, in place,
    with its moments ``mu`` and ``nu``."""
    import torch
    b1, b2, eps = 0.9, 0.999, 1e-8
    with torch.no_grad():
        for k, p in params.items():
            g = p.grad
            mu[k] = (1 - b1) * g + b1 * mu[k]
            nu[k] = (1 - b2) * g * g + b2 * nu[k]
            mh = mu[k] / (1 - b1 ** n)
            vh = nu[k] / (1 - b2 ** n)
            p.add_(-lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p))


def leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's (inf
    for a leaf the program lacks)."""
    import torch
    norms = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keep}
    med = float(np.median(list(norms.values())))
    return [abs(float(torch.linalg.vector_norm(prog[k].float())) - norms[k])
            / max(norms[k], med) if k in prog else math.inf for k in keep]


def leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keep))


def moved_leaves(grad: dict) -> list:
    """The leaves compared: leaves whose reference gradient is nought to
    rounding (a bias under a softmax) move by round-off alone and are left
    out, by the rule of under a thousandth of the median leaf's norm."""
    import torch
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in grad.items()}
    med = float(np.median(list(gnorm.values())))
    return [k for k, v in gnorm.items() if v >= 1e-3 * med]


def compare(prog: dict, ref: dict, weights: dict) -> dict:
    keep = moved_leaves(ref['grad'])
    if len(prog['losses']) != len(ref['losses']) or not all(
            math.isfinite(x) for x in prog['losses']):
        return {'grad_gap': math.inf, 'change_gap': math.inf}
    change_p = {k: prog['params'][k] - weights[k] for k in keep}
    change_r = {k: ref['params'][k] - weights[k] for k in keep}
    return {'grad_gap': leaf_gap(prog['grad'], ref['grad'], keep),
            'change_gap': leaf_gap(change_p, change_r, keep)}


def compare_window(prog: dict, ref: dict) -> dict:
    """The window's kept step: the parameters' change by the worst leaf as
    ``compare``'s (inf where the program kept no step)."""
    if 'change' not in prog:
        return {'window_change_gap': math.inf}
    return {'window_change_gap': leaf_gap(
        prog['change'], ref['change'], moved_leaves(ref['grad']))}


def window_grad_gaps(prog: dict, ref: dict) -> dict:
    """The kept step's gradient by the worst and by the median leaf: read,
    not compared. Its worst leaf is an output layer's bias, whose gradient
    is the batch's residual summed per channel and nearly cancels; the
    median leaf reads from seed to seed as far apart as the control does
    (PERF.md section 4)."""
    if 'grad' not in prog:
        return {}
    gaps = leaf_gaps(prog['grad'], ref['grad'], moved_leaves(ref['grad']))
    return {'window_grad_worst_gap': max(gaps),
            'window_grad_median_gap': float(np.median(gaps))}


def data_faults(conf, tr: dict, seed: int, batches) -> float:
    """The kept batches' samples that the data stage got wrong, judged by
    ``reference.data`` against the benchmark's own photos."""
    photos = np.stack([harness.photo(harness.seed_of(seed, 'photo', i),
                                     tr['image_size'], tr['image_size'])
                       for i in range(tr['images'])])
    lr = conf.hr_image_size // (conf.hr_image_size // conf.lr_image_size)
    return ref_data.faults(
        [tuple(a.cpu().numpy() for a in b) for b in batches], photos,
        conf.hr_image_size, lr, conf.num_classes, conf.batch_size)


def loss_gap(prog: dict, ref: dict) -> float:
    """The worst step's relative loss gap: read for the record, not
    compared (neither the control nor a fault separates it from sound
    runs; PERF.md section 4)."""
    return max(abs(a - b) / abs(b) for a, b in
               zip(prog['losses'], ref['losses']))


def readings_of(cfg, conf, tr, seed, kept, snap, device,
                control: bool = False) -> dict:
    """The numbers compared: the first steps', the window's kept step's
    and the data stage's; with ``control`` the same of the reference in
    fp8 in the program's place, against the same reference."""
    ref = reference_steps(cfg, conf, tr, seed, kept, device)
    weights = make_weights(cfg['reference'], harness.seed_of(seed, 'w'),
                           device)
    out = {'program': compare(kept, ref, weights),
           'loss_gap': loss_gap(kept, ref)}
    if control:
        low = reference_steps(cfg, conf, tr, seed, kept, device,
                              Precision('fp8'))
        out['control'] = compare(low, ref, weights)
        out['control_loss_gap'] = loss_gap(low, ref)
    del ref, weights
    if 'params' in snap:
        ref_w = reference_window_step(cfg, conf, tr, seed, snap, device)
        out['program'].update(compare_window(snap, ref_w))
        out.update(window_grad_gaps(snap, ref_w))
        if control:
            low = reference_window_step(cfg, conf, tr, seed, snap, device,
                                        Precision('fp8'))
            out['control'].update(compare_window(low, ref_w))
            out.update({f'control_{k}': v for k, v in
                        window_grad_gaps(low, ref_w).items()})
    else:
        out['program'].update(compare_window({}, {}))
    out['program']['data_faults'] = data_faults(
        conf, tr, seed, kept['batches'] + ([snap['batch']]
                                           if 'batch' in snap else []))
    return out


def readings(cell: dict, opts: dict, control: bool) -> dict:
    """The numbers compared, for setting limits: the program's first steps
    and its step at the window's kept index after them, on a fresh set-up,
    against the reference, and with ``control`` the reference in fp8 in the
    program's place against the same reference."""
    tr = cell['traffic_data']
    seed = opts['seed']
    t = setup(cell, dict(opts, t_start=time.perf_counter()))
    if opts.get('fault'):
        from perfbench.tests import faults
        faults.apply_train(opts['fault'], t)
    try:
        kept = first_steps(t, tr['checked_steps'])
        snap, checked = {}, window_step(seed, tr)
        for k in range(checked + 1):
            take_step(t, keep=snap if k == checked else None)
    finally:
        conf, cfg, dev = t['conf'], t['cfg'], t['device']
        release(t)
    return readings_of(cfg, conf, tr, seed, kept, snap, dev, control)
