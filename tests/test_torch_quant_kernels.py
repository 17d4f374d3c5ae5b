"""The int8 path's activation quantize (``kernels.quant_act``), the weight
cache of ``QuantConv`` and the route choice of ``kernels.int8_conv``, on the
CPU.

- ``act_amax_plain`` and ``quantize_act_plain`` equal the JAX package's
  expressions (``srgd_tpu/nn/quant.py:133``, ``:153``, ``:160``) bit for bit
  on the same seeded inputs: scalar and per-channel divisors, values on a
  half-integer after the divide (round half to even), values past the
  clip, zero channels, bf16 and float32 inputs. On the CPU the wrappers are
  those plain versions.
- ``QuantConv`` with its weight cache gives the bits of one whose cache is
  cleared before every call, after each way the weights' codes can go
  stale: ``load_state_dict``, ``weight.data.copy_``, an in-place write,
  ``select`` of per-time stats, a ``calibrate_quant`` pass; with smoothing
  the cache serves only recorded (static) a_c.
- ``int8_conv.route`` is a function of Cin, the kernel size and the
  operands' alignment alone.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srgd_tpu_torch.kernels import int8_conv as ic
from srgd_tpu_torch.kernels import quant_act as qa
from srgd_tpu_torch.nn import quant as tq

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once


# ---------------------------------------------------------------------------
# act_amax and quantize_act against JAX's expressions
# ---------------------------------------------------------------------------

def _activation(seed, dtype, shape=(2, 5, 7, 24)):
    """An NHWC activation (numpy float32, exact in ``dtype``) with channel 3
    all zero, channel 5 30x the others, some values on half-integers of the
    divisor 2^-4 and some far past 127 of its steps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[..., 5] *= 30.0
    x[..., 3] = 0.0
    # k + 1/2 steps of 2^-4, exact in bf16 and float32
    x[0, 0, :, 7] = (np.arange(shape[2]) - 3 + 0.5) / 16.0
    x[1, 2, :, 9] = (np.arange(shape[2]) * 40.0 - 100.0) / 16.0   # past 127
    t = torch.from_numpy(x).to(dtype)
    return t, t.float().numpy()


def _jax_amax(xf, per_channel):
    xf = jnp.asarray(xf)
    if per_channel:   # srgd_tpu/nn/quant.py:133
        return np.asarray(jnp.max(jnp.abs(xf), axis=(0, 1, 2)))
    return np.asarray(jnp.max(jnp.abs(xf)))            # :153


def _jax_quantize(xf, x_div):                             # :160
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(xf) / x_div), -127.0,
                               127.0).astype(jnp.int8))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('per_channel', [False, True])
def test_act_amax_plain_matches_jax(dtype, per_channel):
    x, xf = _activation(1, dtype)
    got = qa.act_amax_plain(x, per_channel)
    want = _jax_amax(xf, per_channel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if per_channel:
        assert got[3] == 0 and got[5] == got.max()
    # the wrapper is the plain version on the CPU, and counts nothing
    before = qa.launches_amax
    assert torch.equal(qa.act_amax(x, per_channel), got)
    assert qa.launches_amax == before


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('divisor', ['dynamic', 'step', 'calibrated',
                                     'per_channel'])
def test_quantize_act_plain_matches_jax(dtype, divisor):
    x, xf = _activation(2, dtype)
    c = x.shape[-1]
    amax = qa.act_amax_plain(x)
    div = {
        'dynamic': amax / 127.0 + 1e-12,
        # 2^-4: the half-integer values tie, and round to even
        'step': torch.tensor(1 / 16.0),
        # a calibrated scale under the dynamic one: codes clip
        'calibrated': amax / 127.0 * 0.25 + 1e-12,
        # SmoothQuant's s_c * s_x, one divisor per channel
        'per_channel': torch.from_numpy(np.random.default_rng(3).uniform(
            0.01, 0.2, c).astype(np.float32)),
    }[divisor]
    got = qa.quantize_act_plain(x, div)
    want = _jax_quantize(xf, div.numpy())
    assert got.dtype == torch.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[..., 3] == 0).all()
    if divisor == 'step':
        # half-integers round to even: (k + 1/2) for k = -3 .. 3
        np.testing.assert_array_equal(got[0, 0, :, 7].numpy(),
                                      [-2, -2, 0, 0, 2, 2, 4])
        assert got[1, 2, :, 9].tolist() == [-100, -60, -20, 20, 60, 100, 127]
    if divisor == 'calibrated':
        assert (got.abs() == 127).any()
    before = qa.launches
    assert torch.equal(qa.quantize_act(x, div), got)
    assert qa.launches == before


def test_quantize_act_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 3, 8)
    with pytest.raises(TypeError, match='bfloat16 or float32'):
        qa.quantize_act(x.to(torch.float16), torch.tensor(1.0))
    with pytest.raises(TypeError, match='bfloat16 or float32'):
        qa.act_amax(x.to(torch.int8))
    with pytest.raises(ValueError, match='non-empty'):
        qa.act_amax(torch.zeros(0, 8))


# ---------------------------------------------------------------------------
# QuantConv's weight cache
# ---------------------------------------------------------------------------

def _conv(alpha=0.0, ks=3, seed=0, cin=12, cout=20):
    torch.manual_seed(seed)
    m = tq.QuantConv(cin, cout, ks, padding=ks // 2, smooth_alpha=alpha)
    with torch.no_grad():
        m.bias.normal_()
    return m


def _input(seed, cin=12, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, cin, 9, 7, generator=g) * scale


def _fresh(m, x):
    """``m(x)`` with the weight cache cleared first, the cache as it was
    after."""
    saved = m._weight_cache
    m._weight_cache = None
    try:
        with torch.no_grad():
            return m(x)
    finally:
        m._weight_cache = saved


def _counting(monkeypatch):
    """How often QuantConv quantizes weights."""
    calls = []
    real = tq.QuantConv._quantize_weights

    def counted(self, a_c):
        calls.append(a_c is not None)
        return real(self, a_c)
    monkeypatch.setattr(tq.QuantConv, '_quantize_weights', counted)
    return calls


def _run(m, x):
    with torch.no_grad():
        return m(x)


@pytest.mark.parametrize('ks', [1, 3])
def test_weight_cache_gives_the_bits_of_no_cache(ks, monkeypatch):
    calls = _counting(monkeypatch)
    m = _conv(ks=ks)
    ys = [_run(m, _input(s)) for s in range(3)]
    assert len(calls) == 1          # one quantize of the weights, then hits
    for s, y in enumerate(ys):
        assert torch.equal(y, _fresh(m, _input(s)))
    xq, wq, scale = m.quantize(_input(0))
    assert wq.dtype == torch.int8 and wq.shape == (20, ks, ks, 12)
    assert wq.is_contiguous() and xq.is_contiguous()


@pytest.mark.parametrize('how', ['load_state_dict', 'data_copy', 'in_place',
                                 'data_assign'])
def test_weight_cache_misses_after_a_weight_write(how, monkeypatch):
    calls = _counting(monkeypatch)
    m, other = _conv(seed=0), _conv(seed=1)
    x = _input(4)
    before = _run(m, x)
    if how == 'load_state_dict':
        m.load_state_dict(other.state_dict())
    elif how == 'data_copy':
        m.weight.data.copy_(other.weight)
        m.bias.data.copy_(other.bias)
    elif how == 'data_assign':
        m.weight.data = other.weight.detach().clone()
        m.bias.data = other.bias.detach().clone()
    else:
        with torch.no_grad():
            m.weight.copy_(other.weight)
            m.bias.copy_(other.bias)
    after = _run(m, x)
    assert len(calls) == 2
    assert not torch.equal(after, before)
    assert torch.equal(after, _fresh(m, x))
    assert torch.equal(after, _run(other, x))


def test_weight_cache_survives_deepcopy_and_to(monkeypatch):
    m = _conv()
    x = _input(5)
    y = _run(m, x)
    twin = copy.deepcopy(m)
    assert isinstance(twin.weight, tq.WatchedParameter)
    assert torch.equal(_run(twin, x), y)
    m.to(torch.float64).to(torch.float32)      # the weight's data replaced
    assert torch.equal(_run(m, x), _fresh(m, x))


def test_smoothing_caches_only_static_a_c(monkeypatch):
    calls = _counting(monkeypatch)
    m = _conv(alpha=0.5)
    # dynamic a_c: the weights depend on the call and are never cached
    y0, y1 = _run(m, _input(0)), _run(m, _input(1, scale=3.0))
    assert calls == [True, True] and m._weight_cache is None
    assert torch.equal(y1, _fresh(m, _input(1, scale=3.0)))
    # a calibrate_quant pass records a_c (its calls recompute the weights)
    n = len(calls)
    assert tq.calibrate_quant(m, [((_input(2),), {}), ((_input(3),), {})])
    assert calls[n:] == [True, True]
    n = len(calls)
    ys = [_run(m, _input(s)) for s in (0, 1)]
    assert len(calls) == n + 1 and m._weight_cache is not None
    for s, y in zip((0, 1), ys):
        assert torch.equal(y, _fresh(m, _input(s)))
    # a second pass moves a_c: the cache misses
    assert tq.calibrate_quant(m, [((_input(6, scale=5.0),), {})])
    y = _run(m, _input(0))
    assert not torch.equal(y, ys[0])
    assert torch.equal(y, _fresh(m, _input(0)))
    assert y0.shape == y.shape


@pytest.mark.parametrize('alpha', [0.0, 0.5])
def test_select_of_per_time_stats_misses_the_cache(alpha, monkeypatch):
    m = _conv(alpha=alpha)
    x = _input(7)
    stat = 'act_amax_ch' if alpha else 'act_scale'
    amax = qa.act_amax_plain(x.permute(0, 2, 3, 1), per_channel=bool(alpha))
    stacked = torch.stack([amax * f for f in (0.5, 1.0, 2.0)])
    if not alpha:
        stacked = stacked / 127.0 + 1e-12
    setattr(m, f'{stat}_t', stacked)
    outs = []
    for idx in (0, 1, 2, 1, 0):
        m.select(idx)
        outs.append(_run(m, x))
        assert torch.equal(outs[-1], _fresh(m, x)), idx
    assert torch.equal(outs[0], outs[4]) and torch.equal(outs[1], outs[3])
    assert not torch.equal(outs[0], outs[2])


def test_calibrate_quant_pass_keeps_the_cached_weights_right(monkeypatch):
    """Without smoothing the weights' codes do not depend on the
    statistics: a calibration pass keeps them, and the output after it is
    that of a cleared cache."""
    calls = _counting(monkeypatch)
    m = _conv()
    _run(m, _input(0))
    assert tq.calibrate_quant(m, [((_input(1, scale=2.0),), {})])
    y = _run(m, _input(0))
    assert len(calls) == 1
    assert torch.equal(y, _fresh(m, _input(0)))


# ---------------------------------------------------------------------------
# int8_conv's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('cin, ks, x_ptr, w_ptr, want', [
    (512, 3, 0, 256, 'wgmma'), (128, 1, 1024, 4096, 'wgmma'),
    (16, 3, 16, 32, 'wgmma'), (40, 3, 0, 0, 'mma'), (3, 3, 0, 0, 'mma'),
    (512, 3, 8, 0, 'mma'), (512, 3, 0, 4, 'mma'), (64, 5, 0, 0, 'mma'),
    (1536, 1, 512, 512, 'wgmma')])
def test_int8_conv_route_is_a_function_of_shape_and_alignment(
        cin, ks, x_ptr, w_ptr, want):
    assert ic.route(cin, ks, x_ptr, w_ptr) == want


def test_int8_conv_rejects_an_unknown_kernel():
    xq = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    wq = torch.zeros((4, 3, 3, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match='kernel must be one of'):
        ic.int8_conv(xq, wq, torch.ones(4), padding=1, kernel='cudnn')
    # on the CPU either route is the plain version
    for kernel in ic.ROUTES:
        assert torch.equal(
            ic.int8_conv(xq, wq, torch.ones(4), padding=1, kernel=kernel),
            ic.int8_conv_plain(xq, wq, torch.ones(4), padding=1))
