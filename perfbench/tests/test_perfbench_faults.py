"""A run with its timed path broken underneath comes out not correct, for
each fault the cells can have (their one chip has no exchange between chips
to leave out), and the control reads well above the program: the harness's
whole run past its look for a card, on the CPU, at a tiny size."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.run import judge, load_cell  # noqa: E402
from perfbench.tests.faults import FAULTS, TRAIN_FAULTS  # noqa: E402

torch.set_num_threads(1)
SEED = 2 ** 31 + 5

TINY = {
    'offline-2k-ancestral': (
        {'unet_dim': 16},
        dict(lr_size=[40, 36], tile=32, num_sample_steps=10,
             steps_per_call=4), 1.0),
    'serve-lr64-w8a8': (
        {'unet_dim': 16, 'quant_min_channels': 32},
        dict(lr_bucket=8, tile=32, sizes=[[8, 8], [8, 6], [7, 8]],
             num_sample_steps=3, rate=4.0, grace_s=30, max_batch_images=4,
             quantize_min_channels=32), 3.0),
    'train-b16-crop256': (
        {'unet_dim': 16},
        dict(images=6, image_size=40, micro_batch=2, steps_per_epoch=10,
             window_check_span=3,
             conf=dict(batch_size=4, hr_image_size=32, lr_image_size=8,
                       crop_size=32, image_size=32, scale_size=40,
                       num_workers=2)), 1.0),
}
SAMPLING = sorted(k for k in TINY if not k.startswith('train'))


def tiny_cell(name):
    overrides, traffic, seconds = TINY[name]
    cell = load_cell(name)
    cell['traffic_data'].update(traffic)
    return cell, overrides, seconds


def run(name, fault=None, control=False):
    cell, overrides, seconds = tiny_cell(name)
    drv = harness.driver(cell['traffic_data']['driver'])
    out = drv.run(cell, dict(seed=SEED, seconds=seconds, trace=False,
                             device='cpu', t_start=time.perf_counter(),
                             overrides=overrides, fault=fault,
                             control=control))
    return cell, out


@pytest.fixture(scope='module')
def sound():
    return {}


def sound_checks(sound, name):
    if name not in sound:
        sound[name] = run(name)[1]['checks']
    return sound[name]


@pytest.mark.parametrize('name,fault', [(n, f) for n in SAMPLING
                                        for f in FAULTS] +
                         [('train-b16-crop256', f) for f in TRAIN_FAULTS])
def test_fault_is_not_correct(sound, name, fault):
    good = sound_checks(sound, name)
    cell, out = run(name, fault)
    correct, _ = judge(out['checks'], cell['limits'])
    assert not correct
    # it fails by far more than the sound run's reading, not by noise
    assert any(out['checks'][k] > max(5 * good[k], 1e-9) for k in good), \
        (out['checks'], good)


@pytest.mark.parametrize('name', sorted(TINY))
def test_control_comes_out_not_correct_by_the_harness_verdict(name):
    """calibrate.py's path: each control reading put through ``run.judge``
    with the cell's own limits, the control's numbers in the program's
    place."""
    from perfbench.calibrate import control_verdict
    cell, overrides, seconds = tiny_cell(name)
    drv = harness.driver(cell['traffic_data']['driver'])
    r = drv.readings(cell, dict(seed=SEED, device='cpu', seconds=seconds,
                                overrides=overrides), control=True)
    verdict = control_verdict(cell, r)
    assert set(verdict['checks']) == set(cell['limits'])
    assert not verdict['correct'], verdict


def test_offline_control_reads_above_the_program():
    cell, overrides, _ = tiny_cell('offline-2k-ancestral')
    drv = harness.driver(cell['traffic_data']['driver'])
    r = drv.readings(cell, dict(seed=SEED, device='cpu',
                                overrides=overrides), control=True)
    for k in r['program']:
        assert r['control'][k] > 3 * r['program'][k], r


def test_serve_control_reads_above_the_program():
    cell, out = run('serve-lr64-w8a8', control=True)
    assert out['checks']['start_gap'] == out['checks']['png_gap'] == 0
    assert out['control']['step_gap'] > 3 * out['checks']['step_gap'], out


def test_train_control_reads_above_the_program():
    cell, overrides, _ = tiny_cell('train-b16-crop256')
    drv = harness.driver(cell['traffic_data']['driver'])
    r = drv.readings(cell, dict(seed=SEED, device='cpu',
                                overrides=overrides), control=True)
    assert any(r['control'][k] > 3 * r['program'][k] for k in r['program'])
