"""The port's training loop, data pipeline, checkpoints and metrics.

Mirrors every test of tests/test_train.py under the same name, against the
port's copies (the JAX tests marked slow run here unmarked at a tiny
size), and adds:

- the port's ``DegradationDataset`` against the JAX package's: same seed,
  same batches, bit for bit; PSNR/SSIM and LPIPS against the JAX metrics;
- the entry points: ``python -m srgd_tpu_torch.infer`` on a checkpoint the
  port trained, ``python -m srgd_tpu_torch.train.loop --device cpu`` in a
  subprocess, and that process stopped by SIGTERM (exit 75, tail
  checkpoint saved).

Tiny sizes: dim 8, mults 1,2, 16-px HR and 4-px LR crops, batch 2.
"""

import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(model='conditional_continuous', unet_dim=8,
            ddpm_unet_dim_mults='1,2', full_attn='False,True',
            learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
            hr_image_size=16, lr_image_size=4, batch_size=2)
RUN = dict(TINY, num_workers=1, epochs=1, warmup_epochs=0, ema_decay=0.9,
           seed=0)


def _conf(**kw):
    from srgd_tpu_torch.config import Config
    return Config(**kw)


def _train(conf, data_dir, out_dir, **kw):
    from srgd_tpu_torch.train.loop import train
    return train(conf, str(data_dir), str(out_dir), device='cpu', **kw)


@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / 'imgs'
    d.mkdir()
    for i in range(3):
        arr = rng.integers(0, 255, size=(96, 80, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f'im{i}.png')
    return d


def _const_data(monkeypatch, signal_at=None):
    """The port's and the JAX package's DegradationDataset replaced by an
    endless constant batch; ``signal_at``: the batch index at which the
    producer raises SIGTERM."""
    import srgd_tpu.train.data as jdata
    import srgd_tpu_torch.train.data as tdata
    rng = np.random.default_rng(0)
    hr = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    label = np.zeros((2,), np.int64)

    class ConstData:
        def __init__(self, *a, **kw):
            pass

        def __iter__(self):
            n = 0
            while True:
                n += 1
                if n == ConstData.signal_at:
                    # raised from the producer (the loop's prefetch
                    # thread); the handler runs in the main thread, which
                    # finishes its in-flight step, stops and saves
                    signal.raise_signal(signal.SIGTERM)
                yield hr, cond, label

    ConstData.signal_at = signal_at
    monkeypatch.setattr(tdata, 'DegradationDataset', ConstData)
    monkeypatch.setattr(jdata, 'DegradationDataset', ConstData)
    return ConstData


def _same_state(a, b):
    """Two TrainStates bit for bit: parameters, EMA and optimizer state."""
    assert a.step == b.step
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        assert torch.equal(a.ema_params[name], b.ema_params[name]), name
    sa, sb = a.opt_state['state'], b.opt_state['state']
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for key, v in sa[i].items():
            w = sb[i][key]
            assert (torch.equal(v, w) if torch.is_tensor(v) else v == w), key


# ---------------------------------------------------------------------------
# data: the port's copy against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['realesrgan', 'simple', 'aug_v1', 'aug_v2'])
def test_dataset_matches_the_jax_pipeline_bit_for_bit(image_dir, mode):
    from srgd_tpu.train.data import DegradationDataset as JaxDataset
    from srgd_tpu.train.data import DegradeConfig as JaxDegrade
    from srgd_tpu_torch.train.data import DegradationDataset, DegradeConfig
    kw = dict(crop_size=32, batch_size=3, num_workers=1, seed=5,
              as_uint8=True, preprocess='resize_randomcrop', scale_size=48)
    got = iter(DegradationDataset(str(image_dir),
                                  degrade_cfg=DegradeConfig(trans_mode=mode),
                                  **kw))
    want = iter(JaxDataset(str(image_dir),
                           degrade_cfg=JaxDegrade(trans_mode=mode), **kw))
    for _ in range(3):
        for a, b in zip(next(got), next(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_native_helpers_match_the_jax_package():
    from srgd_tpu.train import native as jnative
    from srgd_tpu_torch.train import native
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    assert native.backend() == ('native' if jnative.get_lib() else 'pil')
    if native.get_lib() is None:
        pytest.skip('no C compiler: both packages take the PIL path')
    np.testing.assert_array_equal(native.bicubic_resize(img, 20, 50),
                                  jnative.bicubic_resize(img, 20, 50))
    np.testing.assert_array_equal(native.gaussian_blur(img, 1.3),
                                  jnative.gaussian_blur(img, 1.3))
    # built into the git-ignored build directory, never next to the source
    path = native.library_path()
    assert path.exists() and 'build' in path.parts
    assert not any(p.suffix == '.so' for p in native.SRC.parent.iterdir())


# ---------------------------------------------------------------------------
# mirrors of tests/test_train.py
# ---------------------------------------------------------------------------

def test_degrade_classes(image_dir):
    from srgd_tpu_torch.train.data import (CLASS_DENOISE, CLASS_REALSR,
                                           CLASS_SR, degrade)
    rng = np.random.default_rng(1)
    hr = np.asarray(Image.open(image_dir / 'im0.png'))[:64, :64]
    for label in (CLASS_REALSR, CLASS_DENOISE, CLASS_SR):
        out = degrade(hr, label, rng)
        assert out.shape == hr.shape and out.dtype == np.uint8
    a = degrade(hr, CLASS_SR, np.random.default_rng(2))
    b = degrade(hr, CLASS_SR, np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)


def test_degrade_config_surface(image_dir):
    from srgd_tpu_torch.train.data import (
        DegradeConfig, aniso_gaussian_kernel, degrade, iso_noise,
        multiplicative_noise, sinc_kernel, usm_sharpen)
    rng = np.random.default_rng(0)
    hr = np.asarray(Image.open(image_dir / 'im0.png'))[:64, :64]
    for mode in ('simple', 'aug_v1', 'aug_v2', 'realesrgan'):
        cfg = DegradeConfig(trans_mode=mode)
        out = degrade(hr, 0, np.random.default_rng(1), cfg=cfg)
        assert out.shape == hr.shape and out.dtype == np.uint8, mode
    with pytest.raises(ValueError):
        DegradeConfig(trans_mode='mystery')
    with pytest.raises(ValueError):
        DegradeConfig(interpolation='NEAREST')
    k = sinc_kernel(np.pi / 3, size=21)
    assert k.shape == (21, 21) and abs(float(k.sum()) - 1.0) < 1e-5
    k = aniso_gaussian_kernel(1.0, 3.0, 0.7, size=21)
    assert abs(float(k.sum()) - 1.0) < 1e-5
    assert not np.allclose(k, k.T)
    for op in (lambda im: iso_noise(im, rng),
               lambda im: multiplicative_noise(im, rng)):
        out = op(hr)
        assert out.dtype == np.uint8 and out.shape == hr.shape
        assert not np.array_equal(out, hr)
    sharp = usm_sharpen(hr)
    assert sharp.dtype == np.uint8 and sharp.shape == hr.shape
    assert float(np.std(sharp.astype(np.float32))) >= \
        float(np.std(hr.astype(np.float32))) - 1e-3
    cfg = DegradeConfig(blur_prob=1.0, gaussian_blur_prob=0.0,
                        advance_blur_prob=0.0, sinc_blur_prob=1.0,
                        noise_prob=0.0, image_compression_prob=0.0)
    out = degrade(hr, 0, np.random.default_rng(2), cfg=cfg)
    assert out.shape == hr.shape


def test_dataset_batches(image_dir):
    from srgd_tpu_torch.train.data import DegradationDataset
    ds = DegradationDataset(str(image_dir), crop_size=32, batch_size=4,
                            num_workers=1, seed=0)
    hr, cond, label = next(iter(ds))
    assert hr.shape == (4, 32, 32, 3) and cond.shape == (4, 32, 32, 3)
    assert hr.dtype == np.float32 and hr.min() >= 0 and hr.max() <= 1
    assert label.shape == (4,) and set(label) <= {0, 1, 2}


def test_dataset_uint8_batches(image_dir):
    from srgd_tpu_torch.train.data import DegradationDataset
    ds8 = DegradationDataset(str(image_dir), crop_size=32, batch_size=2,
                             num_workers=1, seed=0, as_uint8=True)
    hr, cond, label = next(iter(ds8))
    assert hr.dtype == np.uint8 and cond.dtype == np.uint8
    dsf = DegradationDataset(str(image_dir), crop_size=32, batch_size=2,
                             num_workers=1, seed=0)
    hrf, condf, labelf = next(iter(dsf))
    np.testing.assert_allclose(hr.astype(np.float32) / 255.0, hrf)
    np.testing.assert_allclose(cond.astype(np.float32) / 255.0, condf)
    np.testing.assert_array_equal(label, labelf)


def test_fft_conv2d_matches_direct():
    from scipy.ndimage import convolve
    from srgd_tpu_torch.train.data import (_conv2d, aniso_gaussian_kernel,
                                           sinc_kernel)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    for k in (sinc_kernel(1.2, 21), aniso_gaussian_kernel(1.5, 0.4, 0.7, 21)):
        got = _conv2d(img, k).astype(np.int32)
        want = np.empty_like(img, dtype=np.float32)
        for ch in range(3):
            want[:, :, ch] = convolve(img[:, :, ch].astype(np.float32), k,
                                      mode='reflect')
        want = np.clip(want, 0, 255).astype(np.uint8).astype(np.int32)
        assert np.abs(got - want).max() <= 1


def test_dataset_missing_dir(tmp_path):
    from srgd_tpu_torch.train.data import DegradationDataset
    with pytest.raises(FileNotFoundError):
        DegradationDataset(str(tmp_path / 'nope'))


def test_fold_split_and_validation_ratio():
    from srgd_tpu_torch.train.data import fold_split
    files = [f'{i}.png' for i in range(10)]
    tr = fold_split(files, 5, '0', 'train')
    va = fold_split(files, 5, '0', 'val')
    assert not set(tr) & set(va)
    assert sorted(tr + va) == files
    assert va == ['0.png', '5.png']
    assert fold_split(files, 5, '0', 'val', validation_ratio=0.5) == ['0.png']
    assert len(fold_split(files, 5, '0,1', 'val')) == 4
    assert fold_split(files, 1, '0', 'train') == files
    assert fold_split(files, 5, '0', None) == files
    with pytest.raises(ValueError, match='out of range'):
        fold_split(files, 5, '7', 'val')


def test_dataset_honors_size_and_fold_knobs(image_dir):
    from srgd_tpu_torch.train.data import DegradationDataset
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
        image_dir / 'aa_small.png')
    ds = DegradationDataset(str(image_dir), crop_size=64, batch_size=2,
                            num_workers=1, crop_size_limit=True)
    assert len(ds.files) == 3 and not any('aa_small' in f for f in ds.files)
    ds_all = DegradationDataset(str(image_dir), crop_size=64, batch_size=2,
                                num_workers=1)
    assert len(ds_all.files) == 4
    with pytest.raises(FileNotFoundError, match='crop_size_limit'):
        DegradationDataset(str(image_dir), crop_size=512,
                           crop_size_limit=True)
    dt = DegradationDataset(str(image_dir), crop_size=32, num_workers=1,
                            n_fold=2, fold='0', fold_role='train')
    dv = DegradationDataset(str(image_dir), crop_size=32, num_workers=1,
                            n_fold=2, fold='0', fold_role='val')
    assert sorted(dt.files + dv.files) == sorted(ds_all.files)
    assert not set(dt.files) & set(dv.files)
    ds3 = DegradationDataset(str(image_dir), crop_size=32, batch_size=2,
                             num_workers=1, crop_rate=2, seed=3,
                             crop_size_limit=True)
    hr, cond, label = next(iter(ds3))
    assert hr.shape == (2, 32, 32, 3) and cond.shape == (2, 32, 32, 3)
    ds4 = DegradationDataset(str(image_dir), crop_size=32, batch_size=2,
                             num_workers=1, scale=2, seed=4,
                             crop_size_limit=True)
    hr, cond, label = next(iter(ds4))
    assert cond.shape == (2, 32, 32, 3)


def test_ordered_batches_give_one_sequence(image_dir):
    """The training loop takes three data workers' batches in turn,
    whatever the threads' timing: two iterations give the same batches,
    those of each worker's seeded generator taken round-robin, so two runs
    of one seed and every rank of a mesh see the same global batches; a
    stand-in iterable passes through."""
    from srgd_tpu_torch.train.data import DegradationDataset
    from srgd_tpu_torch.train.loop import ordered_batches
    ds = DegradationDataset(str(image_dir), crop_size=32, batch_size=2,
                            num_workers=3, seed=2)
    runs = []
    for _ in range(2):
        it = ordered_batches(ds)
        runs.append([next(it) for _ in range(6)])
        it.close()
    rngs = [np.random.default_rng(2 * 1000 + w) for w in range(3)]
    want = [ds._make_batch(rngs[k % 3]) for k in range(6)]
    for got in runs:
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert list(ordered_batches([1, 2])) == [1, 2]


def test_train_rejects_bad_task_valsets_and_sizes(tmp_path, image_dir):
    with pytest.raises(ValueError, match='conditional_task_type'):
        _train(_conf(**{**TINY, 'conditional_task_type': 'faces'}),
               'unused', tmp_path / 'a')
    with pytest.raises(NotImplementedError, match='val_realsrv3'):
        _train(_conf(val_realsrv3=True, **TINY), 'unused', tmp_path / 'b')
    with pytest.raises(NotImplementedError, match='val_realsrv3'):
        _train(_conf(val_drealsr=True, **TINY), 'unused', tmp_path / 'c')
    with pytest.raises(ValueError, match='integer multiple'):
        _train(_conf(**{**TINY, 'lr_image_size': 7}), 'unused',
               tmp_path / 'd')
    # a one-rank mesh trains (the gloo mesh path at world 1)
    state = _train(_conf(**RUN), image_dir, tmp_path / 'e', total_steps=1,
                   log_every=1, save_every=1, mesh_shape=(1, 1))
    assert state.step == 1 and np.isfinite(state.losses[0])


def test_ema_update():
    from srgd_tpu_torch.train.ema import ema_update
    ema = {'w': torch.ones(3)}
    ema_update(ema, {'w': torch.zeros(3)}, 0.9)
    np.testing.assert_allclose(ema['w'].numpy(), 0.9)


def test_lr_schedule():
    from srgd_tpu_torch.train.trainer import make_lr_schedule
    conf = _conf(lr=1e-4, min_lr=1e-7, warmup_epochs=2, epochs=10,
                 warmup_lr_init=1e-6)
    sched = make_lr_schedule(conf, steps_per_epoch=10)
    assert float(sched(0)) == pytest.approx(1e-6, rel=1e-3)
    assert float(sched(20)) == pytest.approx(1e-4, rel=1e-3)
    assert float(sched(100)) == pytest.approx(1e-7, rel=1e-2)


def test_lr_schedule_variants():
    from srgd_tpu_torch.train.trainer import make_lr_schedule
    base = dict(lr=1e-4, min_lr=1e-6, warmup_epochs=2, epochs=10,
                warmup_lr_init=1e-6)
    s = make_lr_schedule(_conf(scheduler='CosineAnnealingLR', **base), 10)
    assert float(s(0)) == pytest.approx(1e-4, rel=1e-3)
    assert float(s(100)) == pytest.approx(1e-6, rel=1e-2)
    s = make_lr_schedule(_conf(scheduler='WarmupLinear', **base), 10)
    assert float(s(0)) == pytest.approx(1e-6, rel=1e-3)
    assert float(s(20)) == pytest.approx(1e-4, rel=1e-3)
    assert float(s(60)) == pytest.approx(5.05e-5, rel=1e-2)
    assert float(s(100)) == pytest.approx(1e-6, rel=1e-2)
    s = make_lr_schedule(_conf(scheduler='ReduceLROnPlateau', **base), 10)
    assert float(s(50)) == pytest.approx(1e-4, rel=1e-3)
    with pytest.raises(ValueError):
        make_lr_schedule(_conf(scheduler='mystery', **base), 10)


def test_epoch_interval_schedule():
    from srgd_tpu_torch.train.trainer import (_maybe_epoch_quantize,
                                              make_lr_schedule)
    conf = _conf(lr=1e-4, min_lr=1e-7, warmup_epochs=0, epochs=10,
                 cosine_interval_type='epoch')
    sched = _maybe_epoch_quantize(make_lr_schedule(conf, 10), conf, 10)
    assert float(sched(10)) == float(sched(19))
    assert float(sched(19)) != float(sched(20))
    conf2 = _conf(cosine_interval_type='weird')
    with pytest.raises(ValueError):
        _maybe_epoch_quantize(make_lr_schedule(conf2, 10), conf2, 10)


def _run_optimizer(conf, grad, steps, value=1.0):
    from srgd_tpu_torch.train.trainer import make_optimizer, set_lr
    w = torch.ones(3)
    opt = make_optimizer(conf, {'w': w}, steps_per_epoch=1)
    for k in range(steps):
        w.grad = grad.clone()
        set_lr(opt, k)
        opt.step(value=torch.tensor(value))
    return w, opt


def test_reduce_on_plateau_optimizer():
    """ReduceLROnPlateau scales the updates, keyed on value=loss."""
    conf = _conf(scheduler='ReduceLROnPlateau', patience=1, lr=1e-2)
    _, opt = _run_optimizer(conf, torch.ones(3), 6)
    assert float(opt.plateau.scale) < 1.0


def test_plateau_honors_factor_and_rejects_max_mode():
    from srgd_tpu_torch.train.trainer import make_optimizer
    conf = _conf(scheduler='ReduceLROnPlateau', patience=1, lr=1e-2,
                 factor=0.5)
    _, opt = _run_optimizer(conf, torch.ones(3), 4)
    scale = float(opt.plateau.scale)
    assert 0 < scale < 1.0
    k = math.log(scale) / math.log(0.5)
    assert abs(k - round(k)) < 1e-5, scale
    conf.plateau_mode = 'max'
    with pytest.raises(ValueError, match='plateau_mode'):
        make_optimizer(conf, {'w': torch.ones(3)})


def test_amsgrad_optimizers_step():
    for name in ('adam', 'adamw'):
        conf = _conf(optimizer=name, amsgrad=True, lr=1e-2, epochs=1,
                     warmup_epochs=0)
        w, opt = _run_optimizer(conf, torch.ones(3), 1)
        assert torch.isfinite(w).all()
        assert 'nu_max' in opt.state[w], name


def test_flash_attn_maps_to_pallas_attention():
    from srgd_tpu_torch.nn.layers import Attention
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    conf = _conf(model='conditional_continuous', unet_dim=8,
                 ddpm_unet_dim_mults='1,2', full_attn='False,True',
                 learned_sinusoidal_cond=True, learned_sinusoidal_dim=4)

    def flags(c):
        return {m.use_pallas for m in build_unet_from_config(
            c, device='meta').modules() if isinstance(m, Attention)}
    assert flags(conf) == {False}
    conf.flash_attn = True
    assert flags(conf) == {True}


def test_shuffle_false_iterates_sequentially(image_dir):
    from srgd_tpu_torch.train.data import DegradationDataset
    ds = DegradationDataset(str(image_dir), crop_size=8, batch_size=2,
                            num_workers=1, seed=0, shuffle=False)
    rng = np.random.default_rng(0)
    n = len(ds.files)
    seen = []
    orig = ds.files
    for _ in range(n):
        before = ds._cursor
        ds._sample(rng)
        seen.append(before % n)
    assert seen == list(range(n))
    assert ds.files == orig


def test_preprocess_modes(image_dir):
    from srgd_tpu_torch.train.data import preprocess_crop
    rng = np.random.default_rng(0)
    img = np.asarray(Image.open(image_dir / 'im0.png'))
    for mode in ('randomcrop', 'centercrop', 'justresize', 'resize_randomcrop'):
        out = preprocess_crop(img, 32, mode, rng, scale_size=48)
        assert out.shape == (32, 32, 3), mode
    with pytest.raises(ValueError):
        preprocess_crop(img, 32, 'mystery', rng)
    a = preprocess_crop(img, 32, 'centercrop', np.random.default_rng(1))
    b = preprocess_crop(img, 32, 'centercrop', np.random.default_rng(2))
    np.testing.assert_array_equal(a, b)


def _validate_setup():
    from srgd_tpu_torch.factory import get_model
    conf = _conf(**TINY, num_sample_steps=2, val_num_sample_steps=2)
    wrapper, net = get_model(conf, ckpt_path='', device='cpu')
    return conf, wrapper, net


def test_validate_saves_samples(image_dir, tmp_path):
    from srgd_tpu_torch.train.loop import validate
    conf, wrapper, net = _validate_setup()
    conf.save_validation_sample = conf.save_validation_hr_sample = True
    conf.valid_preprocess, conf.valid_trans_mode = 'centercrop', 'simple'
    sdir = str(tmp_path / 'samples')
    ema = {k: v.detach() * 0.5 for k, v in net.named_parameters()}
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    m = validate(conf, wrapper, ema, str(image_dir), 0, num_images=2,
                 sample_dir=sdir, step=7)
    assert np.isfinite(m['psnr'])
    # the net's own parameters come back after sampling with the EMA ones
    for k, v in net.named_parameters():
        assert torch.equal(v, before[k]), k
    files = sorted(os.listdir(sdir))
    assert any(f.startswith('sample_000007') for f in files)
    assert any(f.startswith('hr_000007') for f in files)
    conf.skip_sample = True
    sdir2 = str(tmp_path / 'samples2')
    m2 = validate(conf, wrapper, None, str(image_dir), 0, num_images=2,
                  sample_dir=sdir2)
    assert np.isfinite(m2['psnr']) and not os.path.exists(sdir2)


def test_train_loop_end_to_end(image_dir, tmp_path):
    from srgd_tpu_torch.checkpoint import restore_params
    conf = _conf(**RUN)
    out_dir = tmp_path / 'run'
    state = _train(conf, image_dir, out_dir, total_steps=3, log_every=1,
                   save_every=2)
    assert state.step == 3
    assert os.path.isdir(os.path.join(out_dir, conf.prefix))
    state2 = _train(conf, image_dir, out_dir, total_steps=4, log_every=1,
                    save_every=10)
    assert state2.step == 4
    best_dir = os.path.join(out_dir, f'{conf.prefix}_best_loss')
    assert os.path.isdir(best_dir)
    best = restore_params(best_dir)
    assert {'params', 'ema_params', 'opt_state', 'step',
            'best_score'} <= set(best)


def test_copy_checkpoint_crash_safe(tmp_path):
    from srgd_tpu_torch.checkpoint import (copy_checkpoint, restore_params,
                                           save_params)
    src = str(tmp_path / 'src')
    dst = str(tmp_path / 'dst')
    save_params(src, {'a': torch.arange(4), 'step': 7})
    copy_checkpoint(src, dst)
    assert int(restore_params(dst)['step']) == 7
    save_params(src, {'a': torch.arange(4), 'step': 9})
    os.makedirs(dst + '.new', exist_ok=True)   # crash debris
    copy_checkpoint(src, dst)
    assert int(restore_params(dst)['step']) == 9
    assert not os.path.exists(dst + '.new') and not os.path.exists(dst + '.old')
    with pytest.raises(FileNotFoundError):
        copy_checkpoint(str(tmp_path / 'missing'), dst)


def test_train_rejects_quantized_config(tmp_path):
    conf = _conf(**TINY, quantize='w8a8')
    with pytest.raises(ValueError, match='inference-only'):
        _train(conf, 'unused', tmp_path / 'q', total_steps=1)


def test_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """stop at step 2 / resume to 4 reproduces the uninterrupted 4-step run
    bit for bit: Adam moments and the schedule survive the checkpoint."""
    _const_data(monkeypatch)
    conf = _conf(**RUN, scheduler='constant')
    sA = _train(conf, 'unused', tmp_path / 'A', total_steps=4, log_every=10,
                save_every=100)
    _train(conf, 'unused', tmp_path / 'B', total_steps=2, log_every=10,
           save_every=2)
    sB = _train(conf, 'unused', tmp_path / 'B', total_steps=4, log_every=10,
                save_every=100)
    assert sA.step == sB.step == 4
    _same_state(sA, sB)


def test_sigterm_saves_tail_checkpoint_and_resumes(tmp_path, monkeypatch):
    """A SIGTERM mid-stint saves the steps since the last periodic save and
    stops cleanly; the resumed run reproduces the uninterrupted one bit for
    bit, though save_every (100) never fired."""
    data = _const_data(monkeypatch)
    prev_term = signal.getsignal(signal.SIGTERM)
    conf = _conf(**RUN, scheduler='constant')
    sA = _train(conf, 'unused', tmp_path / 'A', total_steps=6, log_every=10,
                save_every=100)
    data.signal_at = 4
    sB1 = _train(conf, 'unused', tmp_path / 'B', total_steps=6,
                 log_every=10, save_every=100)
    data.signal_at = None
    assert 1 <= sB1.step < 6
    assert signal.getsignal(signal.SIGTERM) == prev_term
    sB = _train(conf, 'unused', tmp_path / 'B', total_steps=6, log_every=10,
                save_every=100)
    assert sA.step == sB.step == 6
    _same_state(sA, sB)


def test_metrics():
    from srgd_tpu_torch.utils.metrics import psnr, ssim
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    assert float(psnr(a, a)) > 100
    assert float(ssim(a, a)) == pytest.approx(1.0, abs=1e-5)
    noisy = torch.clamp(a + 0.1 * torch.from_numpy(
        rng.normal(size=a.shape).astype(np.float32)), 0, 1)
    p = float(psnr(a, noisy))
    assert 15 < p < 25
    assert 0 < float(ssim(a, noisy)) < 1


def test_metrics_match_jax():
    from srgd_tpu.utils.metrics import psnr as jpsnr
    from srgd_tpu.utils.metrics import ssim as jssim
    from srgd_tpu_torch.utils.metrics import psnr, ssim
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(psnr(ta, tb)) == pytest.approx(float(jpsnr(a, b)), rel=1e-6)
    assert float(ssim(ta, tb)) == pytest.approx(float(jssim(a, b)), rel=1e-5)


def test_phase_timer():
    from srgd_tpu_torch.utils.profiling import PhaseTimer
    t = PhaseTimer()
    with t.phase('a'):
        pass
    with t.phase('a', sync='cpu'):
        pass
    assert t.counts['a'] == 2 and 'a:' in t.report()


def test_validate(image_dir):
    from srgd_tpu_torch.train.loop import validate
    conf, wrapper, _ = _validate_setup()
    m = validate(conf, wrapper, None, str(image_dir), 0, num_images=2)
    assert np.isfinite(m['psnr']) and -1 <= m['ssim'] <= 1


def test_lpips_math_and_converter():
    """Zero at identity, positive and symmetric otherwise; the params built
    from torch-format state dicts (torchvision VGG16 features, lpips lin)
    give a finite distance."""
    from srgd_tpu_torch.utils.lpips import (lpips,
                                            params_from_torch_state_dicts,
                                            random_lpips_params)
    params = random_lpips_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    d_aa, d_ab, d_ba = lpips(a, a, params), lpips(a, b, params), \
        lpips(b, a, params)
    assert d_aa.shape == (2,)
    np.testing.assert_allclose(d_aa.numpy(), 0.0, atol=1e-5)
    assert (d_ab > 0).all()
    np.testing.assert_allclose(d_ab.numpy(), d_ba.numpy(), rtol=1e-5)
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    widths = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    vgg_sd, c_in = {}, 3
    for idx, w in zip(conv_idx, widths):
        vgg_sd[f'{idx}.weight'] = torch.from_numpy(
            rng.normal(size=(w, c_in, 3, 3)).astype(np.float32))
        vgg_sd[f'{idx}.bias'] = torch.zeros(w)
        c_in = w
    lin_sd = {f'lin{k}.model.1.weight': torch.from_numpy(np.abs(
        rng.normal(size=(1, c, 1, 1))).astype(np.float32))
        for k, c in enumerate([64, 128, 256, 512, 512])}
    d = lpips(a, b, params_from_torch_state_dicts(vgg_sd, lin_sd))
    assert torch.isfinite(d).all()


def test_lpips_matches_jax_on_the_same_state_dicts():
    """The port's LPIPS and the JAX package's on the same torch-format
    weights (the JAX converter and ``params_from_torch_state_dicts``):
    float32, relative 1e-4."""
    from srgd_tpu.utils.lpips import convert_torch_lpips
    from srgd_tpu.utils.lpips import lpips as jlpips
    from srgd_tpu_torch.utils.lpips import (VGG_BLOCKS, VGG_CONV_INDICES,
                                            lpips,
                                            params_from_torch_state_dicts)
    rng = np.random.default_rng(5)
    vgg_sd, c_in = {}, 3
    for (n, w), idxs in zip(VGG_BLOCKS, VGG_CONV_INDICES):
        for idx in idxs:
            vgg_sd[f'{idx}.weight'] = (rng.normal(size=(w, c_in, 3, 3))
                                       * 0.05).astype(np.float32)
            vgg_sd[f'{idx}.bias'] = (0.01 * rng.normal(size=w)).astype(
                np.float32)
            c_in = w
    lin_sd = {f'lin{k}.model.1.weight': np.abs(rng.normal(
        size=(1, w, 1, 1))).astype(np.float32)
        for k, (_, w) in enumerate(VGG_BLOCKS)}
    a = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jlpips(jnp.asarray(a), jnp.asarray(b),
                             convert_torch_lpips(vgg_sd, lin_sd)))
    got = lpips(torch.from_numpy(a), torch.from_numpy(b),
                params_from_torch_state_dicts(
                    {k: torch.from_numpy(v) for k, v in vgg_sd.items()},
                    {k: torch.from_numpy(v) for k, v in lin_sd.items()}))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_lpips_save_load_roundtrip(tmp_path):
    """The ``.npz`` round trip, and the file is the JAX package's layout:
    its loader reads it to the same distance."""
    from srgd_tpu.utils.lpips import load_lpips_params as jload
    from srgd_tpu.utils.lpips import lpips as jlpips
    from srgd_tpu_torch.utils.lpips import (load_lpips_params, lpips,
                                            random_lpips_params,
                                            save_lpips_params)
    params = random_lpips_params(torch.Generator().manual_seed(1))
    path = str(tmp_path / 'lpips.npz')
    save_lpips_params(path, params)
    p2 = load_lpips_params(path)
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    np.testing.assert_allclose(lpips(a, b, params).numpy(),
                               lpips(a, b, p2).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jlpips(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                          jload(path))), lpips(a, b, p2).numpy(), rtol=1e-4)


def test_best_lpips_requires_weights(tmp_path):
    conf = _conf(**TINY, test_target='best_lpips')
    with pytest.raises(NotImplementedError, match='lpips'):
        _train(conf, 'unused', tmp_path / 'x', total_steps=1)


def test_madgrad_matches_published_step():
    """The port's Madgrad == an independent numpy transcription of the
    published step, decoupled and coupled decay, over several steps."""
    from srgd_tpu_torch.train.madgrad import Madgrad
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(5)]
    lr, mom, wd, eps = 0.05, 0.9, 0.01, 1e-6
    for decoupled in (True, False):
        p = p0.copy()
        s = np.zeros_like(p)
        nu = np.zeros_like(p)
        x0 = p0.copy()
        for k, g in enumerate(grads):
            g = g.copy()
            lamb = lr * np.sqrt(k + 1.0)
            if decoupled:
                p = p * (1 - lr * wd)
            else:
                g = g + wd * p
            nu = nu + lamb * g * g
            s = s + lamb * g
            z = x0 - s / (np.cbrt(nu) + eps)
            p = mom * p + (1 - mom) * z
        w = torch.from_numpy(p0.copy())
        opt = Madgrad([w], lr, momentum=mom, weight_decay=wd,
                      decoupled_decay=decoupled, eps=eps)
        for g in grads:
            w.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(w.numpy(), p, rtol=2e-5, atol=2e-6)


def test_madgrad_from_config_steps_and_honors_decay_knob():
    outs = {}
    for dd in (True, False):
        conf = _conf(optimizer='madgrad', lr=1e-2, weight_decay=0.1,
                     madgrad_decoupled_decay=dd, epochs=1, warmup_epochs=0)
        w, _ = _run_optimizer(conf, torch.ones(3) * 0.5, 2)
        assert torch.isfinite(w).all()
        outs[dd] = w.numpy()
    assert not np.allclose(outs[True], outs[False])


def test_log_dir_writes_train_log(image_dir, tmp_path):
    conf = _conf(model='continuous', unet_dim=8, ddpm_unet_dim_mults='1,2',
                 full_attn='False,True', learned_sinusoidal_cond=True,
                 learned_sinusoidal_dim=4, hr_image_size=32,
                 lr_image_size=8, batch_size=2, num_sample_steps=2,
                 epochs=1, warmup_epochs=0, num_workers=0)
    out = tmp_path / 'run'
    _train(conf, image_dir, out, total_steps=1, log_every=1, save_every=10,
           resume=False)
    log = out / 'logs' / 'train.log'
    assert log.exists()
    assert 'step 1 loss' in log.read_text()


def test_train_amp_uses_bf16_compute(image_dir, tmp_path):
    """amp: true -> bfloat16 compute over float32 master params; an
    explicit compute_dtype wins."""
    conf = _conf(**RUN, amp=True)
    state = _train(conf, image_dir, tmp_path / 'run', total_steps=2,
                   log_every=1, save_every=10)
    assert state.step == 2
    assert conf.compute_dtype == 'bfloat16'
    for p in list(state.params.values()) + list(state.ema_params.values()):
        assert p.dtype == torch.float32
    conf2 = _conf(**RUN, amp=True, compute_dtype='bfloat16')
    _train(conf2, image_dir, tmp_path / 'run2', total_steps=1, log_every=1,
           save_every=10)
    assert conf2.compute_dtype == 'bfloat16'


def test_save_params_crash_safe(tmp_path, monkeypatch):
    """A save that dies mid-write never destroys the previous checkpoint."""
    from srgd_tpu_torch import checkpoint as ckio
    path = str(tmp_path / 'ckpt')
    ckio.save_params(path, {'w': torch.arange(4.0), 'step': 1})
    real_ckpt = ckio._checkpointer

    class Boom(RuntimeError):
        pass

    class ExplodingCkpt:
        def save(self, p, params, **kw):
            os.makedirs(p, exist_ok=True)
            (tmp_path / 'ckpt.new' / 'partial').write_text('garbage')
            raise Boom('simulated OOM kill mid-save')

    monkeypatch.setattr(ckio, '_checkpointer', lambda: ExplodingCkpt())
    with pytest.raises(Boom):
        ckio.save_params(path, {'w': torch.arange(4.0) * 2, 'step': 2})
    monkeypatch.setattr(ckio, '_checkpointer', real_ckpt)
    assert int(ckio.restore_params(path)['step']) == 1
    ckio.save_params(path, {'w': torch.arange(4.0) * 3, 'step': 3})
    assert int(ckio.restore_params(path)['step']) == 3
    assert not os.path.exists(path + '.new')
    assert not os.path.exists(path + '.old')


def test_restore_params_mid_swap_fallbacks(tmp_path):
    from srgd_tpu_torch import checkpoint as ckio
    path = str(tmp_path / 'ckpt')
    ckio.save_params(path + '.new', {'step': 7})
    assert ckio.checkpoint_exists(path)
    assert int(ckio.restore_params(path)['step']) == 7
    os.rename(path + '.new', path + '.old')
    assert ckio.checkpoint_exists(path)
    assert int(ckio.restore_params(path)['step']) == 7
    assert not ckio.checkpoint_exists(str(tmp_path / 'nothing'))


# ---------------------------------------------------------------------------
# handoff and entry points
# ---------------------------------------------------------------------------

INFER_YAML = """
model: conditional_continuous
unet_dim: 8
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 4
hr_image_size: 16
lr_image_size: 4
image_size: 16
batch_size: 2
num_workers: 1
epochs: 1
warmup_epochs: 0
ema_decay: 0.9
train_trans_mode: simple
"""


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')


def test_infer_samples_from_a_checkpoint_the_port_trained(image_dir,
                                                          tmp_path):
    """Train 2 steps, then ``python -m srgd_tpu_torch.infer -m <ckpt>``
    writes a 4x image from the checkpoint's EMA weights, which
    ``factory.get_model`` loads."""
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.factory import get_model
    yaml = tmp_path / 'tiny.yaml'
    yaml.write_text(INFER_YAML)
    conf = load_config(str(yaml))
    state = _train(conf, image_dir, tmp_path / 'run', total_steps=2,
                   log_every=1, save_every=2)
    ckpt = tmp_path / 'run' / conf.prefix
    _, net = get_model(load_config(str(yaml)), str(ckpt), device='cpu')
    for k, v in net.state_dict().items():
        assert torch.equal(v, state.ema_params[k]), k
    src, dst = tmp_path / 'in', tmp_path / 'out'
    src.mkdir()
    Image.fromarray(np.random.default_rng(1).integers(
        0, 255, (8, 12, 3), dtype=np.uint8)).save(src / 'a.png')
    res = subprocess.run(
        [sys.executable, '-m', 'srgd_tpu_torch.infer', '-c', str(yaml),
         '-m', str(ckpt), '--input_dir', str(src), '--output_dir', str(dst),
         '--device', 'cpu', '--num_sample_steps', '2', '--tile_size', '16',
         '--batch_size', '4'], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    outs = sorted(os.listdir(dst))
    assert outs, res.stderr[-2000:]
    assert Image.open(dst / outs[0]).size == (48, 32)


def _cli(yaml, data, out, steps, save_every=100):
    return [sys.executable, '-m', 'srgd_tpu_torch.train.loop', '-c',
            str(yaml), '--data_dir', str(data), '--out_dir', str(out),
            '--steps', str(steps), '--log_every', '1', '--save_every',
            str(save_every), '--device', 'cpu']


def test_train_cli_runs_on_the_cpu(image_dir, tmp_path):
    yaml = tmp_path / 'tiny.yaml'
    yaml.write_text(INFER_YAML)
    res = subprocess.run(_cli(yaml, image_dir, tmp_path / 'run', 2, 2),
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'step 2 loss' in res.stderr
    assert 'data path: ' in res.stderr
    assert os.path.isdir(tmp_path / 'run' / 'conditional_continuous_linear')


def test_train_cli_sigterm_saves_its_tail_and_exits_75(image_dir, tmp_path):
    """SIGTERM while the CLI trains: the in-flight step finishes, the tail
    checkpoint is saved though save_every never fired, and the process
    exits 75 (incomplete)."""
    from srgd_tpu_torch.checkpoint import restore_params
    yaml = tmp_path / 'tiny.yaml'
    yaml.write_text(INFER_YAML)
    out = tmp_path / 'run'
    proc = subprocess.Popen(_cli(yaml, image_dir, out, 100000), cwd=REPO,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 240
        seen = ''
        while 'step 2 loss' not in seen and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            seen += line
        assert 'step 2 loss' in seen, seen[-3000:]
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 75, err[-3000:]
    state = restore_params(out / 'conditional_continuous_linear')
    assert state['step'] >= 2
