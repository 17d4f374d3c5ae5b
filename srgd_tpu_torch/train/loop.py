"""Full training loop: data -> train steps -> EMA -> checkpoints.

Counterpart of ``srgd_tpu/train/loop.py``: the training capability the
reference's config describes (epochs/warmup/cosine/EMA/save_every_epoch/
best-loss checkpointing), on the card unless the caller asks for ``--device
cpu``. Checkpoints hold {params, ema_params, opt_state, step, best_score}
(``srgd_tpu_torch/checkpoint/``) and a resumed run reproduces an
uninterrupted one bit for bit.

``--mesh D,M`` trains over D x M ranks, one process per device
(``parallel.mesh``, ``train.sharded``): ``batch_size`` is the global batch,
split over the data axis, and the model axis shards the master copy, the
optimizer state and the EMA of the weights JAX's rule shards. Without
``--mesh`` a ``--device cuda`` run uses gcd(batch_size, visible GPUs) data
ranks, as the JAX loop does; ``--device cuda:K`` trains on card K alone and
a CPU run on one process. Rank 0 validates and writes the same single-file
checkpoint a one-device run writes, which a one-device run or a mesh of any
shape resumes.

CLI: python -m srgd_tpu_torch.train.loop -c conf.yaml --data_dir D --out_dir D
     [--steps N --log_every N --save_every N --val_dir D --mesh D,M
      --device cuda|cuda:K|cpu]

Exits 75 when a SIGTERM/SIGINT stopped the run before ``--steps``.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import signal
import sys
import time
from contextlib import closing as _closing

import numpy as np
import torch

from srgd_tpu_torch.utils.profiling import SPANS, PhaseTimer

logger = logging.getLogger('srgd_tpu_torch.train')


class _GracefulStop:
    """Stop the training loop cleanly on SIGTERM/SIGINT.

    The first signal sets ``triggered`` so the loop finishes its in-flight
    step and saves a final checkpoint; a second signal falls through to the
    previous disposition (hard kill). Previous handlers are restored on
    exit, and installation is skipped off the main thread."""

    def __init__(self):
        self._signals = []
        self._prev = {}

    def _request(self, signum, frame):
        self._signals.append(signum)
        signal.signal(signum, self._prev[signum])

    @property
    def triggered(self) -> bool:
        return bool(self._signals)

    def __enter__(self):
        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                self._prev[s] = signal.signal(s, self._request)
        except ValueError:  # not the main thread; run unguarded
            # restore any handler installed before the failing call so a
            # partial install never leaves _request live with an empty _prev
            for s, h in self._prev.items():
                signal.signal(s, h)
            self._prev = {}
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            # the handler swaps itself out on first delivery; only restore
            # what is still ours
            if signal.getsignal(s) == self._request:
                signal.signal(s, h)
        return False


class _DevicePrefetcher:
    """Overlaps batch production and the host-to-device copy with the step.

    One worker thread pulls host batches and, on a card, copies them from
    pinned memory to the device on a side stream, ``depth`` batches ahead,
    recording an event after each copy. The consumer makes the current
    stream wait on that event before the batch is used, and marks the
    tensors as used by that stream (``record_stream``), so the allocator
    does not hand their memory out while the step still reads it. On the
    CPU the batches pass through as tensors.

    The consumer's wait for each batch is the span ``train.data_wait`` in
    ``spans``, under the index of the step it feeds (from ``first_step``).
    """

    def __init__(self, it, device, depth: int = 2, spans=SPANS,
                 first_step: int = 0):
        import queue
        import threading

        self.device = device
        self.spans, self.index = spans, first_step
        self._q: 'queue.Queue' = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc = None
        cuda = device.type == 'cuda'

        def run():
            try:
                stream = torch.cuda.Stream(device) if cuda else None
                for batch in it:
                    host = tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in batch)
                    if cuda:
                        with torch.cuda.stream(stream):
                            out = tuple(t.pin_memory().to(device,
                                                          non_blocking=True)
                                        for t in host)
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        item = (out, ready)
                    else:
                        item = (host, None)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # surface in the consumer
                self._exc = e
                self._q.put(None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with self.spans.span('train.data_wait', self.index):
            item = self._q.get()
            if item is None and self._exc is not None:
                raise self._exc
            out, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(ready)
                for t in out:
                    t.record_stream(current)
        self.index += 1
        return out

    def close(self):
        self._stop.set()


def ordered_batches(ds):
    """``ds``'s batches in one sequence for its seed. The iterator of
    ``train.data.DegradationDataset`` (the JAX package's, kept as it is)
    queues its workers' batches in the order their threads finish them and
    drops a batch its consumer is slow to take, so two runs of one seed, or
    two ranks of a mesh, could train on different batches. Here each
    worker's generator, seeded as that iterator seeds it (``seed * 1000 +
    worker``), is taken in turn and each batch waits until it is taken. An
    iterable without ``_make_batch`` (a stand-in) is iterated as it is."""
    import itertools
    import queue
    import threading

    make = getattr(ds, '_make_batch', None)
    if make is None:
        yield from ds
        return
    queues = [queue.Queue(maxsize=2) for _ in range(ds.num_workers)]
    stop = threading.Event()

    def worker(wid):
        rng = np.random.default_rng(ds.seed * 1000 + wid)
        while not stop.is_set():
            batch = make(rng)
            while not stop.is_set():
                try:
                    queues[wid].put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    for w in range(ds.num_workers):
        threading.Thread(target=worker, args=(w,), daemon=True).start()
    try:
        for q in itertools.cycle(queues):
            yield q.get()
    finally:
        stop.set()


def _conf_scale(conf) -> int:
    """SR factor from the config's image-size pair (config.py:80-83): the
    degradation pipeline downsamples HR crops by hr_image_size /
    lr_image_size (4 for the shipped 256/64 flagship)."""
    if conf.lr_image_size <= 0 or conf.hr_image_size % conf.lr_image_size:
        raise ValueError(
            f'hr_image_size {conf.hr_image_size} must be an integer multiple '
            f'of lr_image_size {conf.lr_image_size}')
    return conf.hr_image_size // conf.lr_image_size


@torch.no_grad()
def _load_into(params: dict, values: dict) -> None:
    for name, p in params.items():
        p.copy_(values[name])


def validate(conf, wrapper, params, val_dir: str, noise_seed: int,
             num_images: int = 4, lpips_params=None, sample_dir: str = None,
             step: int = 0, fold_role=None):
    """Sample with ``params`` (a state dict, the EMA weights; None keeps the
    net's own) on degraded val crops and score PSNR/SSIM (+ LPIPS when
    weights are given). The net's parameters are restored afterwards.

    Honors valid_preprocess / valid_trans_mode and the
    save_validation_sample / save_validation_hr_sample switches when
    sample_dir is given; skip_sample suppresses the sample PNGs while
    keeping the metrics. fold_role='val' restricts val_dir to the held-out
    folds (n_fold/train_fold, validation_ratio)."""
    from srgd_tpu_torch.diffusion.base import GeneratorNoise
    from srgd_tpu_torch.train import data as data_mod
    from srgd_tpu_torch.train.trainer import trainable_params
    from srgd_tpu_torch.utils.metrics import psnr, ssim

    conditional = 'conditional' in conf.model
    val_cfg = data_mod.DegradeConfig.from_conf(conf)
    val_cfg.trans_mode = conf.valid_trans_mode
    val_cfg.__post_init__()  # re-validate the overridden mode
    ds = data_mod.DegradationDataset(
        val_dir, crop_size=conf.hr_image_size, batch_size=num_images,
        num_workers=1, seed=conf.seed + 1, num_classes=conf.num_classes,
        degrade_cfg=val_cfg, preprocess=conf.valid_preprocess,
        scale_size=conf.scale_size, scale=_conf_scale(conf),
        crop_size_limit=conf.crop_size_limit, n_fold=conf.n_fold,
        fold=conf.train_fold, fold_role=fold_role,
        validation_ratio=conf.validation_ratio, hflip=False, rotate=False)
    hr, cond, label = next(iter(ds))
    live = trainable_params(wrapper)
    device = next(iter(live.values())).device
    hr = torch.from_numpy(hr).to(device)
    cond = torch.from_numpy(cond).to(device)
    label = torch.from_numpy(label).to(device) if conditional else None
    saved = None
    if params is not None:
        saved = {k: v.detach().clone() for k, v in live.items()}
        _load_into(live, params)
    try:
        out = wrapper.sample(cond, label,
                             num_sample_steps=conf.val_num_sample_steps,
                             noise=GeneratorNoise(noise_seed, device))
    finally:
        if saved is not None:
            _load_into(live, saved)
    metrics = {'psnr': float(psnr(out, hr)), 'ssim': float(ssim(out, hr))}
    if lpips_params is not None:
        from srgd_tpu_torch.utils.lpips import lpips
        metrics['lpips'] = float(torch.mean(lpips(out, hr, lpips_params)))

    if sample_dir and not conf.skip_sample and (
            conf.save_validation_sample or conf.save_validation_hr_sample):
        from PIL import Image
        os.makedirs(sample_dir, exist_ok=True)

        def save(arr, name):
            png = (np.clip(arr.float().cpu().numpy(), 0, 1) * 255).astype(
                np.uint8)
            for i, im in enumerate(png):
                Image.fromarray(im).save(
                    os.path.join(sample_dir, f'{name}_{step:06d}_{i}.png'))

        if conf.save_validation_sample:
            save(out, 'sample')
        if conf.save_validation_hr_sample:
            save(hr, 'hr')
    return metrics


def _load_lpips_or_raise(conf, device):
    """test_target: best_lpips needs VGG16+LPIPS weights, which are not in
    the repository and cannot be downloaded (utils/lpips.py)."""
    if not conf.lpips_weights_path:
        raise NotImplementedError(
            "test_target: best_lpips requires conf.lpips_weights_path (a "
            ".npz of the official torchvision VGG16 + lpips linear weights, "
            "written by srgd_tpu_torch.utils.lpips.save_lpips_params from "
            "params_from_torch_state_dicts); LPIPS is otherwise unsupported "
            "because pretrained weights cannot be downloaded here.")
    from srgd_tpu_torch.utils.lpips import load_lpips_params
    return load_lpips_params(conf.lpips_weights_path, device)


def _init_weights(net, log_snr, conf) -> None:
    """Random weights from ``conf.seed``, the net's first, as ``get_model``
    draws them."""
    gen = torch.Generator().manual_seed(conf.seed)
    net.init_weights(gen)
    if log_snr is not None:
        log_snr.init_weights(gen)


def train(conf, data_dir: str, out_dir: str, total_steps: int = 1000,
          log_every: int = 50, save_every: int = 500, mesh_shape=None,
          resume: bool = True, val_dir: str = None, device='cuda'):
    """Train for ``total_steps`` steps (resuming from ``out_dir`` when a
    checkpoint is there) and return the ``TrainState``: on one device, the
    live one; under a mesh, rank 0's, with whole parameters and EMA on the
    CPU and no optimizer (its whole state is in the checkpoint the run
    ends with). ``device`` 'cuda' without ``mesh_shape`` trains over
    gcd(batch, visible GPUs) data ranks; 'cuda:K' on card K alone."""
    from srgd_tpu_torch.infer import resolve_device
    from srgd_tpu_torch.parallel.mesh import launch
    device = resolve_device(device)
    n_devices = None
    if mesh_shape is None and device.type == 'cuda' and device.index is None:
        dp = math.gcd(conf.batch_size, torch.cuda.device_count())
        if dp > 1:
            mesh_shape, n_devices = (dp, 1), dp
    run = (conf, data_dir, out_dir, total_steps, log_every, save_every,
           resume, val_dir)
    if mesh_shape is None:
        return train_on(None, *run, device)
    return launch(_train_rank, tuple(mesh_shape), device.type, (run,),
                  n_devices=n_devices)


def _train_rank(mesh, run):
    """One rank of a mesh run: its state with whole tensors on the CPU
    (every rank gathers its shards) and no optimizer."""
    from srgd_tpu_torch.train.sharded import full_state
    from srgd_tpu_torch.train.trainer import TrainState
    if not mesh.is_writer:
        logger.setLevel(logging.WARNING)
    state = train_on(mesh, *run, mesh.device)
    return TrainState(params=full_state(state.params), optimizer=None,
                      ema_params=full_state(state.ema_params),
                      step=state.step, losses=state.losses, timer=state.timer)


def train_on(mesh, conf, data_dir, out_dir, total_steps, log_every,
             save_every, resume, val_dir, device):
    """``train``'s body on one device, or on this rank of ``mesh`` (None:
    one device, whatever the card count)."""
    conditional = 'conditional' in conf.model
    args = (conf, data_dir, out_dir, total_steps, log_every, save_every,
            mesh, resume, val_dir, conditional, device)
    if conf.log_dir and (mesh is None or mesh.is_writer):
        # the reference trainer logs under log_dir; a plain-text run log
        # alongside stdout. A relative log_dir lands inside out_dir.
        ldir = (conf.log_dir if os.path.isabs(conf.log_dir)
                else os.path.join(out_dir, conf.log_dir))
        os.makedirs(ldir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(ldir, 'train.log'))
        fh.setFormatter(logging.Formatter('%(asctime)s %(name)s %(message)s'))
        logger.addHandler(fh)
        if logger.getEffectiveLevel() > logging.INFO:
            logger.setLevel(logging.INFO)  # progress lines reach the file
        try:
            return _train_inner(*args)
        finally:
            logger.removeHandler(fh)
            fh.close()
    return _train_inner(*args)


def _train_inner(conf, data_dir, out_dir, total_steps, log_every, save_every,
                 mesh, resume, val_dir, conditional, device):
    from srgd_tpu_torch.checkpoint import (
        checkpoint_exists, copy_checkpoint, restore_params, save_params)
    from srgd_tpu_torch.diffusion.schedules import LearnedLogSNR
    from srgd_tpu_torch.factory import CONTINUOUS_MODELS, build_wrapper
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    from srgd_tpu_torch.train import data as data_mod
    from srgd_tpu_torch.train import native
    from srgd_tpu_torch.train.sharded import (
        MeshParams, full_state, local_rows)
    from srgd_tpu_torch.train.trainer import (
        create_train_state, make_optimizer, make_train_step,
        trainable_params)
    if conf.quantize != 'none':
        # QuantConv rounds with no straight-through estimator, so training a
        # quantized net gets ~zero conv gradients and silently fails to learn
        raise ValueError(
            f"quantize: {conf.quantize!r} is inference-only (no STE through "
            "the int8 rounding); train with quantize: 'none' and enable int8 "
            "at serving time via --precision int8.")
    if conditional and conf.conditional_task_type != 'realsr_denoise_sr':
        # the only task recipe the reference defines (config.py:20-21)
        raise ValueError(
            f'conditional_task_type {conf.conditional_task_type!r} is not '
            "supported; the only defined task is 'realsr_denoise_sr'")
    if conf.val_realsrv3 or conf.val_drealsr:
        raise NotImplementedError(
            'val_realsrv3/val_drealsr require the RealSR-V3/DRealSR '
            'benchmark datasets, which cannot be downloaded here; place a '
            'local copy and point --val_dir at it instead')
    rows = None if mesh is None else local_rows(conf.batch_size, mesh)
    if conf.amp and conf.compute_dtype == 'float32':
        # the reference trainer autocasts under amp/amp_dtype; here, as in
        # the JAX package, bfloat16 compute over float32 master parameters
        # (no loss scaling). An explicit compute_dtype wins.
        conf.compute_dtype = 'bfloat16'
        logger.info("amp: true -> bfloat16 compute, float32 master params")
    net = build_unet_from_config(conf, device=device).train()
    log_snr = None
    if conf.model in CONTINUOUS_MODELS and conf.noise_schedule == 'learned':
        log_snr = LearnedLogSNR(conf.learned_schedule_net_hidden_dim,
                                device=device)
    wrapper = build_wrapper(conf, net, log_snr)

    if conf.print_freq:          # reference config.py:188
        log_every = conf.print_freq

    # checkpoint-selection policy (reference config.py:181)
    target = conf.test_target
    if target not in ('best_loss', 'best_psnr', 'best_ssim', 'best_lpips'):
        raise ValueError(f'unknown test_target {target!r}')
    lpips_params = (_load_lpips_or_raise(conf, device)
                    if target == 'best_lpips' else None)

    ds = data_mod.DegradationDataset(
        data_dir, crop_size=conf.hr_image_size, batch_size=conf.batch_size,
        num_classes=conf.num_classes, hflip=conf.hflip, rotate=conf.rotate,
        seed=conf.seed, num_workers=conf.num_workers,
        degrade_cfg=data_mod.DegradeConfig.from_conf(conf),
        preprocess=conf.train_preprocess, scale_size=conf.scale_size,
        scale=_conf_scale(conf), crop_rate=conf.crop_rate,
        crop_size_limit=conf.crop_size_limit,
        n_fold=conf.n_fold, fold=conf.train_fold, fold_role='train',
        shuffle=conf.shuffle, as_uint8=True)
    logger.info('data path: %s', native.backend())

    _init_weights(net, log_snr, conf)
    params = trainable_params(wrapper)
    n_params = sum(p.numel() for p in params.values())
    logger.info('model %s: %.1fM params on %s%s', conf.model, n_params / 1e6,
                device, '' if mesh is None else f', mesh {mesh.shape}')
    mesh_params = None
    if mesh is not None:
        # the optimizer and the EMA take the masters: dim-0 shards over the
        # model axis where param_spec shards, the modules' own elsewhere
        mesh_params = MeshParams(params, mesh)
        params = mesh_params.master

    steps_per_epoch = max(total_steps // max(conf.epochs, 1), 1)
    optimizer = make_optimizer(conf, params, steps_per_epoch=steps_per_epoch)
    state = create_train_state(params, optimizer)
    if conf.save_every_epoch:  # checkpoint policy knob (config.py:179)
        save_every = steps_per_epoch

    # checkpoint naming from config (reference artifact layout:
    # {model_dir}/{save_dir}/{prefix}_... , config.py:7-8, 186)
    ckpt_dir = os.path.join(out_dir, conf.prefix or 'ckpt')
    best_score = -float(np.inf)
    if resume and checkpoint_exists(ckpt_dir):
        raw = restore_params(ckpt_dir)
        opt_state = raw.get('opt_state')
        if mesh_params is not None:
            # a one-device checkpoint, re-sharded for this mesh
            mesh_params.load_full(raw['params'], state.ema_params,
                                  raw['ema_params'], optimizer, opt_state)
        else:
            _load_into(state.params, raw['params'])
            with torch.no_grad():
                for name, e in state.ema_params.items():
                    e.copy_(raw['ema_params'][name])
            if opt_state is not None:
                optimizer.load_state_dict(opt_state)
        if opt_state is not None:
            best_score = float(raw.get('best_score', -np.inf))
        else:  # a checkpoint without optimizer state
            logger.warning('checkpoint has no opt_state; Adam moments reset')
        state.step = int(raw['step'])
        logger.info('resumed from %s at step %d, best_score %r', ckpt_dir,
                    state.step, best_score)

    # the run's phases and its steps' spans, reported at its end
    timer = state.timer = PhaseTimer()
    step_fn = make_train_step(wrapper, conf.ema_decay, conditional, conf.seed,
                              mesh_params=mesh_params, spans=timer)
    writer = mesh is None or mesh.is_writer

    def save_state(path, step):
        # whole tensors: the ranks holding shards gather them, rank 0 writes
        if not writer and not (mesh_params and mesh_params.sharded):
            return
        item = {'params': full_state(state.params),
                'ema_params': full_state(state.ema_params),
                'opt_state': full_state(optimizer.state_dict()),
                'step': step, 'best_score': best_score}
        if writer:
            save_params(path, item)

    def stopping():
        """Whether any rank was asked to stop (SIGTERM/SIGINT)."""
        if mesh is None:
            return stop.triggered
        flag = torch.tensor([float(stop.triggered)], device=device)
        torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    batches = ordered_batches(ds)
    if rows is not None:
        # every rank runs the same seeded pipeline and keeps its rows
        batches = (tuple(a[rows] for a in batch) for batch in batches)

    os.makedirs(out_dir, exist_ok=True)
    losses = state.losses
    # resume-aware: milestones at or before the restored step are presumed
    # already snapshotted by the stint that crossed them
    milestone = int(os.environ.get('TRAIN_MILESTONE_EVERY', 20000))
    last_milestone = state.step // milestone if milestone > 0 else 0
    t0 = time.time()
    it = _DevicePrefetcher(batches, device, spans=timer,
                           first_step=state.step)
    stopped = False
    with _GracefulStop() as stop, _closing(it):
        while state.step < total_steps:
            stopped = stopping()
            if stopped:
                break
            hr, cond, label = next(it)
            with timer.phase('step', id=state.step):
                loss = step_fn(state, hr, cond,
                               label if conditional else None)
                losses.append(float(loss))  # syncs the step
            step = state.step
            if step % log_every == 0:
                dt = time.time() - t0
                logger.info('step %d loss %.4f (%.2f steps/s)',
                            step, float(np.mean(losses[-log_every:])),
                            log_every / max(dt, 1e-9))
                t0 = time.time()
            if step % save_every == 0 or step >= total_steps:
                # score per conf.test_target (higher = better; loss/lpips
                # negated), before the periodic save so the saved
                # best_score is current and the best snapshot is a file
                # copy of the checkpoint just written
                score = None
                # without an explicit val_dir, validation falls back to the
                # held-out folds of the training dir (n_fold/train_fold)
                vdir, vrole = ((val_dir, None) if val_dir else
                               (data_dir, 'val') if conf.n_fold > 1 else
                               (None, None))
                if target == 'best_loss':
                    score = -float(np.mean(losses[-log_every:]))
                elif vdir and not conf.skip_val:
                    with timer.phase('val'):
                        ema = (state.ema_params if mesh is None
                               else full_state(state.ema_params))
                        if writer:
                            m = validate(conf, wrapper, ema, vdir,
                                         (conf.seed << 32) + step,
                                         num_images=conf.sample_size,
                                         lpips_params=lpips_params,
                                         sample_dir=os.path.join(
                                             out_dir, 'val_samples'),
                                         step=step, fold_role=vrole)
                            logger.info('val @%d: %s', step, '  '.join(
                                f'{k} {v:.4f}' for k, v in m.items()))
                            score = {'best_psnr': m['psnr'],
                                     'best_ssim': m['ssim'],
                                     'best_lpips': -m.get('lpips', np.inf)
                                     }[target]
                        if mesh is not None:
                            from srgd_tpu_torch.parallel.mesh import (
                                broadcast_object)
                            score = broadcast_object(score, mesh)
                improved = score is not None and score > best_score
                if improved:
                    best_score = score
                with timer.phase('save'):
                    save_state(ckpt_dir, step)
                logger.info('saved checkpoint at step %d -> %s', step, ckpt_dir)
                if improved and writer:
                    with timer.phase('save_best'):
                        copy_checkpoint(ckpt_dir, os.path.join(
                            out_dir, f'{conf.prefix or "ckpt"}_{target}'))
                # milestone snapshots: an immutable copy at the first save
                # at or past each multiple of TRAIN_MILESTONE_EVERY steps
                # (default 20k), named by its actual step
                if milestone > 0 and step // milestone > last_milestone:
                    last_milestone = step // milestone
                    with timer.phase('save_milestone'):
                        if writer:
                            copy_checkpoint(ckpt_dir,
                                            f'{ckpt_dir}_step{step}')
                    logger.info('milestone snapshot -> %s_step%d',
                                ckpt_dir, step)
    step = state.step
    if stopped and step % save_every != 0 and step < total_steps:
        # signal arrived between periodic saves: persist the stint's tail
        # so the next run resumes from here instead of the last save_every
        save_state(ckpt_dir, step)
        logger.info('stop requested (signal %s): saved checkpoint at step '
                    '%d -> %s', stop._signals, step, ckpt_dir)
    logger.info('phase breakdown:\n%s', timer.report())
    return state


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-c', '--conf', required=True)
    p.add_argument('--data_dir', default='',
                   help='default: {conf.base_dir}/{conf.dataset_name} '
                        '(the reference dataset layout, config.py:10-11)')
    p.add_argument('--out_dir', default='',
                   help='default: {conf.model_dir}/{conf.save_dir} '
                        '(the reference artifact layout)')
    p.add_argument('--steps', type=int, default=1000)
    p.add_argument('--log_every', type=int, default=50)
    p.add_argument('--save_every', type=int, default=500)
    p.add_argument('--mesh', type=str, default='')
    p.add_argument('--val_dir', type=str, default='')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default: every visible card, as "
                        "gcd(batch_size, cards) data ranks without --mesh), "
                        "'cuda:K' (card K alone) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    args = parse_args(argv)
    from srgd_tpu_torch.config import load_config
    conf = load_config(args.conf)
    out_dir = args.out_dir or os.path.join(conf.model_dir, conf.save_dir)
    data_dir = args.data_dir or os.path.join(conf.base_dir, conf.dataset_name)
    from srgd_tpu_torch.parallel.mesh import parse_shape
    mesh_shape = parse_shape(args.mesh)
    state = train(conf, data_dir, out_dir, total_steps=args.steps,
                  log_every=args.log_every, save_every=args.save_every,
                  mesh_shape=mesh_shape, val_dir=args.val_dir or None,
                  device=args.device)
    if state.step < args.steps:
        # graceful SIGTERM/SIGINT stop: the checkpoint is saved but the run
        # is incomplete — exit nonzero so wrappers never mistake a killed
        # stint for a finished run
        logger.info('stopped early at step %d/%d; exiting 75 (incomplete)',
                    state.step, args.steps)
        sys.exit(75)
    return state


if __name__ == '__main__':
    main()
