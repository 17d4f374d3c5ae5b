"""Int8 calibration and its cache in the port (``srgd_tpu_torch.nn.quant``)
against the JAX package's (``srgd_tpu.nn.quant``).

Calibration: ``calibrate_sampler`` of each package on the same weights and
the same draws (the JAX draws from PRNGKey(seed), handed to the port), global
and per-time, with margin, smoothing and the percentile estimator. Every
recorded statistic matches (``STAT_RTOL``: 1e-6 relative for the per-tensor
scales, 1e-4 for the per-channel amaxes of smoothing, which carry the float
layers' drift), and so does the forward on them, with the activation codes
handled as ``tests/test_torch_quant.JaxCodes`` says.

The cache mirrors tests/test_quant_cache.py: a lossless round trip (global
and per-time), a fingerprint mismatch that returns None with a warning, a
corrupt file and a save without calibration that raise. The ``.npz`` format
is shared: a cache that either package writes loads in the other with the
same statistics, and the two fingerprints are equal for one setup.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.config import Config as JaxConfig
from srgd_tpu.factory import build_wrapper as jax_build_wrapper
from srgd_tpu.nn import quant as jq
from srgd_tpu_torch.checkpoint import split_quant_stats, state_dict_from_jax
from srgd_tpu_torch.factory import build_wrapper
from srgd_tpu_torch.nn import quant as tq
from tests.test_torch_quant import (
    JaxCodes, STAT_RTOL, assert_net_close, inputs, jax_net, port_net,
    run_port, tiny_conf,
)

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once


def _jax_draws(seed, shape):
    """The draws of ``srgd_tpu.nn.quant.calibrate_sampler`` from
    PRNGKey(seed): (x, cond)."""
    kx, kc = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(kx, shape, jnp.float32)),
            np.asarray(jax.random.uniform(kc, shape, jnp.float32, -1.0, 1.0)))


def _calibrated_pair(kw, per_time, monkeypatch, margin=1.0, n_times=3,
                     batch=2, seed=7, tile=16):
    """The JAX variables and the port net, each calibrated by its own
    ``calibrate_sampler`` on the same draws (JAX eagerly, for ``JaxCodes``)."""
    jconf = tiny_conf(JaxConfig, **kw)
    jnet, variables = jax_net(kw)
    jw = jax_build_wrapper(jconf, jnet)
    codes = JaxCodes(monkeypatch)
    with jax.disable_jit():
        jcal = jq.calibrate_sampler(jw, variables, jax.random.PRNGKey(seed),
                                    tile_size=tile, batch=batch,
                                    n_times=n_times, margin=margin,
                                    per_time=per_time)
    net = port_net(kw, variables)
    w = build_wrapper(tiny_conf(**kw), net)
    assert tq.calibrate_sampler(
        w, tile_size=tile, batch=batch, n_times=n_times, margin=margin,
        per_time=per_time, draws=_jax_draws(seed, (batch, tile, tile, 3)))
    return jnet, jw, jcal, net, w, codes


def _assert_stats_match(net, jcal):
    _, stats = split_quant_stats(state_dict_from_jax(jcal))
    mine = {f'{n}.{s}': getattr(m, s) for n, m in tq.quant_convs(net)
            for s in ('act_scale', 'act_amax_ch', 'act_scale_t',
                      'act_amax_ch_t') if getattr(m, s) is not None}
    if net.quant_stats_times is not None:
        mine['quant_stats_times'] = net.quant_stats_times
        mine = {k: v for k, v in mine.items()
                if not k.endswith(('.act_scale', '.act_amax_ch'))}
    assert sorted(mine) == sorted(stats)
    for k, want in stats.items():
        stat = k.rpartition('.')[2].removesuffix('_t')
        np.testing.assert_allclose(mine[k].numpy(), want.numpy(),
                                   rtol=STAT_RTOL.get(stat, 0), err_msg=k)


@pytest.mark.parametrize('per_time, kw', [
    (False, {}), (True, {}), (False, {'quantize_smooth_alpha': 0.5}),
    (False, {'quantize_cal_mode': 'p99'})])
def test_calibrate_sampler_matches_jax(per_time, kw, monkeypatch):
    """One 8-px tile at two calibration times."""
    jnet, jw, jcal, net, w, codes = _calibrated_pair(
        kw, per_time, monkeypatch, margin=1.5, n_times=2, batch=1, tile=8)
    _assert_stats_match(net, jcal)
    x, t, cond, lb = inputs(seed=3)
    if per_time:
        t = np.full(2, np.asarray(jcal['quant_stats_times'])[1], np.float32)
    want = jw.net_apply(jcal, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(cond), jnp.asarray(lb), None)
    with torch.inference_mode():
        got = w.net_apply(torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(cond), torch.from_numpy(lb), None)
    assert_net_close(got.numpy(), want)
    codes.done()


def test_calibrated_stats_from_jax_drive_the_port_net(monkeypatch):
    """JAX's recorded stats carried over by state_dict_from_jax: the port net
    runs static scales and matches the JAX net on them."""
    kw = {'quantize_min_channels': 16}
    jconf = tiny_conf(JaxConfig, **kw)
    jnet, variables = jax_net(kw)
    jcal = jq.calibrate_sampler(jax_build_wrapper(jconf, jnet), variables,
                                jax.random.PRNGKey(7), tile_size=16, batch=2)
    net = port_net(kw, jcal)
    assert tq.has_calibration(net)
    x, t, cond, lb = inputs(seed=4)
    codes = JaxCodes(monkeypatch)
    want = jnet.apply(jcal, jnp.asarray(x), jnp.asarray(t),
                      cond=jnp.asarray(cond), class_label=jnp.asarray(lb))
    assert_net_close(run_port(net, x, t, cond, lb), want)
    codes.done()


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

STATS = ('act_scale', 'act_amax_ch', 'act_scale_t', 'act_amax_ch_t')


def _port_calibrated(kw=None, per_time=False):
    """A port net of ``tiny_conf(**kw)`` on JAX init weights, calibrated by
    the port (8-px tiles, one tile, two or three times)."""
    kw = kw or {}
    _, variables = jax_net(kw)
    net = port_net(kw, variables)
    w = build_wrapper(tiny_conf(**kw), net)
    assert tq.calibrate_sampler(w, generator=torch.Generator().manual_seed(7),
                                tile_size=8, batch=1,
                                n_times=3 if per_time else 2,
                                per_time=per_time)
    return net, variables


def _stats(net):
    out = {f'{n}.{s}': getattr(m, s).clone() for n, m in tq.quant_convs(net)
           for s in STATS if getattr(m, s) is not None}
    if net.quant_stats_times is not None:
        out['quant_stats_times'] = net.quant_stats_times.clone()
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]).float(),
                           torch.as_tensor(b[k]).float()), k


@pytest.mark.parametrize('per_time', [False, True])
def test_cache_roundtrip(tmp_path, per_time):
    net, _ = _port_calibrated(per_time=per_time)
    fp = tq.calibration_fingerprint(tiny_conf(), tile_size=8, batch=1,
                                    per_time=per_time)
    path = tmp_path / 'cal.npz'
    tq.save_calibration(path, net, fp)
    want = _stats(net)
    x, t, cond, lb = inputs(seed=3)
    w = build_wrapper(tiny_conf(), net)
    if per_time:
        assert set(k.rpartition('.')[2] for k in want) <= {
            'act_scale_t', 'act_amax_ch_t', 'quant_stats_times'}
        t[:] = net.quant_stats_times[1].item()

    def forward():
        with torch.inference_mode():
            return w.net_apply(*(torch.from_numpy(a)
                                 for a in (x, t, cond, lb)), None)

    y = forward()
    tq.clear_stats(net)
    assert not tq.has_calibration(net)
    assert tq.load_calibration(path, net, fp) is net
    _assert_same(_stats(net), want)
    assert torch.equal(forward(), y)


def test_cache_fingerprint_mismatch_returns_none(tmp_path, caplog):
    net, _ = _port_calibrated()
    fp = tq.calibration_fingerprint(tiny_conf(), tile_size=8, batch=1)
    path = tmp_path / 'cal.npz'
    tq.save_calibration(path, net, fp)
    before = _stats(net)
    fp2 = tq.calibration_fingerprint(tiny_conf(quantize_min_channels=16),
                                     tile_size=8, batch=1)
    with caplog.at_level('WARNING'):
        assert tq.load_calibration(path, net, fp2) is None
    assert 'quantize_min_channels' in caplog.text
    _assert_same(_stats(net), before)


def test_cache_rejects_corrupt_file(tmp_path):
    net = port_net({}, jax_net({})[1])
    fp = tq.calibration_fingerprint(tiny_conf())
    path = tmp_path / 'not_a_cache.npz'
    np.savez(path, stray=np.zeros(3))
    with pytest.raises(ValueError, match='not a calibration cache'):
        tq.load_calibration(path, net, fp)
    meta = np.frombuffer(__import__('json').dumps(fp, sort_keys=True)
                         .encode(), np.uint8)
    np.savez(path, __meta__=meta, stray=np.zeros(3))
    with pytest.raises(ValueError, match='unexpected entry'):
        tq.load_calibration(path, net, fp)
    np.savez(path, __meta__=meta,
             **{'quant_stats/downs_9_0/block1/proj/act_scale': np.ones(())})
    with pytest.raises(ValueError, match='names no quantized conv'):
        tq.load_calibration(path, net, fp)


def test_save_without_calibration_raises(tmp_path):
    net = port_net({}, jax_net({})[1])
    with pytest.raises(ValueError, match='quant_stats'):
        tq.save_calibration(tmp_path / 'x.npz', net,
                            tq.calibration_fingerprint(tiny_conf()))


def test_fingerprint_matches_jax(tmp_path):
    ckpt = tmp_path / 'w.pth'
    ckpt.write_bytes(b'weights')
    for kw, fkw in (({}, {}),
                    ({'quantize_cal_mode': 'p99.9'}, {'per_time': True}),
                    ({'quantize_smooth_alpha': 0.5,
                      'quantize_min_channels': 512},
                     {'ckpt_path': str(ckpt), 'class_label': 2, 'seed': 5,
                      'tile_size': 64, 'batch': 3})):
        assert tq.calibration_fingerprint(tiny_conf(**kw), **fkw) == \
            jq.calibration_fingerprint(tiny_conf(JaxConfig, **kw), **fkw)
    assert tq.calibration_fingerprint(tiny_conf()) != \
        tq.calibration_fingerprint(tiny_conf(quantize_cal_mode='p99.9'))


@pytest.mark.parametrize('per_time', [False, True])
def test_jax_cache_loads_in_port(tmp_path, per_time):
    conf = tiny_conf(JaxConfig)
    jnet, variables = jax_net({})
    jcal = jq.calibrate_sampler(jax_build_wrapper(conf, jnet), variables,
                                jax.random.PRNGKey(7), tile_size=8, batch=1,
                                n_times=3, per_time=per_time)
    fp = jq.calibration_fingerprint(conf, tile_size=8, batch=1,
                                    per_time=per_time)
    path = tmp_path / 'jax.npz'
    jq.save_calibration(path, jcal, fp)
    net = port_net({}, variables)
    assert tq.load_calibration(path, net, tq.calibration_fingerprint(
        tiny_conf(), tile_size=8, batch=1, per_time=per_time)) is net
    _, want = split_quant_stats(state_dict_from_jax(jcal))
    _assert_same(_stats(net), want)


@pytest.mark.parametrize('per_time', [False, True])
def test_port_cache_loads_in_jax(tmp_path, per_time):
    net, variables = _port_calibrated(per_time=per_time)
    fp = tq.calibration_fingerprint(tiny_conf(), tile_size=8, batch=1,
                                    per_time=per_time)
    path = tmp_path / 'port.npz'
    tq.save_calibration(path, net, fp)
    loaded = jq.load_calibration(path, variables, jq.calibration_fingerprint(
        tiny_conf(JaxConfig), tile_size=8, batch=1, per_time=per_time))
    assert loaded is not None
    assert ('quant_stats_t' in loaded) == per_time
    assert ('quant_stats' in loaded) != per_time
    _, got = split_quant_stats(state_dict_from_jax(loaded))
    _assert_same(got, _stats(net))
