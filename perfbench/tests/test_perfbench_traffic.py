"""Every generator is seeded and repeats; every seed gets the same work."""

from __future__ import annotations

import io
import sys
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.loadgen import request_image, schedule  # noqa: E402
from perfbench.reference import inputs as ref_inputs  # noqa: E402

SEED = 2 ** 31 + 77


def params(seed, **kw):
    tr = harness.traffic('serve-lr64')
    return dict(seed=seed, rate=tr['rate'], seconds=40,
                arrival_seed=tr['arrival_seed'], sizes=tr['sizes'],
                labels=tr['labels'], **kw)


def test_schedule_repeats_and_every_seed_gets_the_same_work():
    a, b = schedule(params(SEED)), schedule(params(SEED))
    assert a == b
    c = schedule(params(SEED + 1))
    assert [d for d, _, _ in a] == [d for d, _, _ in c]
    assert Counter(s for _, s, _ in a) == Counter(s for _, s, _ in c)
    assert Counter(lab for _, _, lab in a) == \
        Counter(lab for _, _, lab in c)
    assert [(s, lab) for _, s, lab in a] != [(s, lab) for _, s, lab in c]
    n = round(40 * harness.traffic('serve-lr64')['rate'])
    assert len(a) == n and a[0][0] == 0.0 and 38 < a[-1][0] < 42


def test_the_check_makes_again_the_images_the_generator_sends():
    """daemon_http.cond_of, the reference's condition of request i, is the
    bucket pad and bicubic of the very PNG the load generator sends for
    the run's seed, and another seed sends other images."""
    from PIL import Image
    drv = harness.driver('daemon_http')
    tr = harness.traffic('serve-lr64')
    conds = []
    for seed in (SEED, SEED + 7):
        p = drv.load_params(tr, seed, tr['rate'], 2)
        for i, (_, size, _) in enumerate(schedule(p)):
            png = request_image(seed, i, size)
            lr = np.asarray(Image.open(io.BytesIO(png)).convert('RGB'))
            want = ref_inputs.upscale(ref_inputs.bucket_pad(
                lr, tr['lr_bucket']))
            got = drv.cond_of(seed, i, size, tr)
            assert np.array_equal(got, want), (seed, i)
            conds.append(got)
    half = len(conds) // 2
    assert not any(np.array_equal(x, y) for x, y in zip(conds[:half],
                                                         conds[half:]))


def test_photos_and_noise_repeat():
    assert np.array_equal(harness.photo(SEED, 64, 52),
                          harness.photo(SEED, 64, 52))
    assert not np.array_equal(harness.photo(SEED, 64, 52),
                              harness.photo(SEED + 1, 64, 52))
    n1, n2 = harness.SeededNoise(SEED, 'cpu'), harness.SeededNoise(SEED, 'cpu')
    for _ in range(2):
        assert (n1.step(0, (2, 8, 8, 3)) == n2.step(0, (2, 8, 8, 3))).all()
    assert harness.seed_of(SEED, 'w') == harness.seed_of(SEED, 'w') \
        != harness.seed_of(SEED, 'x')
    assert 0 <= harness.seed_of(-5, 'w') < 2 ** 63


def test_weights_repeat_from_the_seed():
    from perfbench.reference.weights import make_weights
    cfg = dict(unet_dim=16, ddpm_unet_dim_mults='1,2', learned_sinusoidal_dim=32,
               channels=3, num_classes=3, full_attn='False,True')
    a, b = make_weights(cfg, 3, 'cpu'), make_weights(cfg, 3, 'cpu')
    assert all((a[k] == b[k]).all() for k in a)
    c = make_weights(cfg, 4, 'cpu')
    assert not (a['init_conv.weight'] == c['init_conv.weight']).all()
    w = a['ups.0.3.net.0.weight']
    assert (w[0::4] == w[1::4]).all() and (a['ups.0.3.net.0.bias'] == 0).all()
