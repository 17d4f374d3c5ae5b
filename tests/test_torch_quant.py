"""The port's W8A8 int8 path (``srgd_tpu_torch.nn.quant``) against the JAX
package's (``srgd_tpu.nn.quant``) on the same weights and inputs.

Weights come from JAX ``init`` and cross into the port through
``state_dict_from_jax``; inputs are numpy draws from a seed. The bars:

- ``QuantConv``: the int8 codes (xq, wq) and the int32 accumulators equal
  JAX's (captured from its ``lax.conv_general_dilated`` call), the output
  within f32 1e-6 * max|y| (the epilogue's multiply and add may be one FMA
  in XLA and are two roundings here);
- the plain ``int8_conv`` equals ``lax.conv_general_dilated`` on the same
  int8 inputs, bit for bit;
- the quantized U-Net, dynamic, calibrated, smoothed, per-time and
  DeepCache-cached: f32 1e-4 * max|ref|, the layer bar of
  tests/test_kernels.py;
- ``select_time_stats`` picks JAX's index (calibration against JAX and the
  cache: tests/test_torch_quant_cache.py).

Code flips. Inside a net, a QuantConv's input differs from JAX's by float32
rounding (about 1e-6 relative, as XLA and PyTorch sum in other orders; more
behind a GroupNorm whose group mean is large against its spread: JAX takes
the variance as E[x^2] - E[x]^2, PyTorch in two passes, and a 4x4 stage of
one tile measured 0.3%), so where x / x_div lies that close to a
half-integer the two round to neighbouring codes, and the flip, worth one
code step times the weights, travels on. ``JaxCodes`` therefore hands each
of the port's QuantConvs the activation codes JAX's matching conv used,
after checking that every code the port would have used itself is the same
or one step away at a half-integer (|x / x_div - (k + 1/2)| <= 1e-3 + 1e-2
|x / x_div|), and counts those flips (at most 1e-3 of the codes). The
weights' codes, the scales and everything else of the port's forward stay
its own.

Plus the contracts of tests/test_quant.py, mirrored on the port. No JAX net
is built with ``use_pallas``: nothing here enters Pallas interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.config import Config as JaxConfig
from srgd_tpu.diffusion.base import select_time_stats as jax_select
from srgd_tpu.factory import build_wrapper as jax_build_wrapper
from srgd_tpu.nn import quant as jq
from srgd_tpu.nn.unet import build_unet_from_config as jax_build_unet
from srgd_tpu_torch.checkpoint import split_quant_stats, state_dict_from_jax
from srgd_tpu_torch.config import Config
from srgd_tpu_torch.diffusion.base import select_time_stats
from srgd_tpu_torch.factory import build_wrapper
from srgd_tpu_torch.kernels.int8_conv import int8_conv, int8_conv_plain
from srgd_tpu_torch.nn import quant as tq
from srgd_tpu_torch.nn.layers import Conv2d
from srgd_tpu_torch.nn.unet import _quant_spec, build_unet_from_config

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

CONV_RTOL = 1e-6    # output of one QuantConv, relative to max|y|
# a flipped code's unrounded value u = x / x_div lies within
# HALF_TOL + HALF_RTOL * |u| of the half-integer between the two codes
HALF_TOL, HALF_RTOL = 1e-3, 1e-2
FLIP_FRAC = 1e-3    # flipped codes, as a share of all activation codes
NET_RTOL = 1e-4     # quantized U-Net forward, relative to max|ref|
STAT_RTOL = {       # recorded calibration statistics, relative
    'act_scale': 1e-6,
    # a per-channel amax is one activation value of one channel, and carries
    # the float32 drift of the float layers before the conv, which a
    # GroupNorm of few elements amplifies (see "Code flips" above; measured
    # up to 1.35e-5 relative here)
    'act_amax_ch': 1e-4,
}


def tiny_conf(cls=Config, **kw):
    base = dict(model='conditional_continuous', unet_dim=8,
                ddpm_unet_dim_mults='1,2', full_attn='False,True',
                learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
                num_classes=3, image_size=16, quantize='w8a8')
    base.update(kw)
    return cls(**base)


# the config keys that shape the param tree; quantization does not
# (tests/test_quant.py: the quantized init tree is the float one)
_ARCH_KEYS = ('model', 'unet_dim', 'ddpm_unet_dim_mults', 'full_attn',
              'pixel_shuffle_upsample', 'learned_sinusoidal_cond')


def jax_net(conf_kw, size=16, seed=0):
    """(JAX net, its variables) of ``tiny_conf(**conf_kw)``; the variables
    are initialised once per architecture in this process."""
    arch = tuple(sorted((k, v) for k, v in conf_kw.items()
                        if k in _ARCH_KEYS))
    return (jax_build_unet(tiny_conf(JaxConfig, **conf_kw)),
            _jax_init(arch, size, seed))


@functools.lru_cache(maxsize=None)
def _jax_init(arch, size, seed):
    net = jax_build_unet(tiny_conf(JaxConfig, quantize='none', **dict(arch)))
    shape = (1, size, size, 3)
    # jitted: a third of the eager init's time on the CPU
    return jax.jit(lambda key: net.init(
        key, jnp.zeros(shape), jnp.zeros((1,)), cond=jnp.zeros(shape),
        class_label=jnp.zeros((1,), jnp.int32)))(jax.random.PRNGKey(seed))


def port_net(conf_kw, variables):
    """The port's net of ``tiny_conf(**conf_kw)`` on the JAX variables, their
    calibration collections included."""
    conf = tiny_conf(**conf_kw)
    net = build_unet_from_config(conf).eval()
    params, stats = split_quant_stats(state_dict_from_jax(
        variables, pixel_shuffle_upsample=conf.pixel_shuffle_upsample))
    net.load_state_dict(params, strict=True)
    if stats:
        tq.load_stats(net, stats)
    return net


def nchw(a):
    return None if a is None else torch.from_numpy(np.asarray(a)).permute(
        0, 3, 1, 2)


def run_port(net, x, t, cond, label, **kw):
    with torch.inference_mode():
        out = net(nchw(x), torch.from_numpy(np.asarray(t)), cond=nchw(cond),
                  class_label=torch.from_numpy(np.asarray(label)), **kw)
    return out


def inputs(b=2, size=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    t = rng.uniform(-5, 5, size=(b,)).astype(np.float32)
    return x, t, cond, np.arange(b, dtype=np.int32) % 3


def assert_net_close(got, want, rtol=NET_RTOL):
    got = got.permute(0, 2, 3, 1).numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


class JaxCodes:
    """Records the int8 activation operand of every int8 conv that JAX runs,
    eagerly or, inside jitted code, through an ordered callback, and makes
    the port's QuantConvs, in call order, run on those codes: each call checks
    that the port's own codes differ from JAX's only by flips (one step, at
    a half-integer) and counts them. ``done()`` checks every code was
    consumed and the flips are rare."""

    def __init__(self, monkeypatch):
        self.codes, self.used, self.flips, self.elements = [], 0, 0, 0
        real_conv = jax.lax.conv_general_dilated

        def record(lhs):
            self.codes.append(np.asarray(lhs))

        def spy(lhs, *args, **kw):
            if lhs.dtype != jnp.int8:
                pass
            elif isinstance(lhs, jax.core.Tracer):
                jax.debug.callback(record, lhs, ordered=True)
            else:
                record(lhs)
            return real_conv(lhs, *args, **kw)
        monkeypatch.setattr(jax.lax, 'conv_general_dilated', spy)
        real_q = tq.QuantConv.quantize_activation

        def forced(xf, x_div):
            xq = real_q(xf, x_div)
            want = torch.from_numpy(self.codes[self.used]).permute(0, 3, 1, 2)
            self.used += 1
            assert want.shape == xq.shape
            diff = xq != want
            self.elements += xq.numel()
            if diff.any():
                u = (xf / x_div)[diff]
                assert ((xq.int() - want.int())[diff].abs() == 1).all()
                assert ((u - torch.floor(u) - 0.5).abs()
                        <= HALF_TOL + HALF_RTOL * u.abs()).all()
                self.flips += int(diff.sum())
            return want
        monkeypatch.setattr(tq.QuantConv, 'quantize_activation',
                            staticmethod(forced))

    def done(self):
        assert self.used == len(self.codes) > 0
        assert self.flips <= FLIP_FRAC * self.elements, (self.flips,
                                                         self.elements)


# ---------------------------------------------------------------------------
# QuantConv against the JAX QuantConv
# ---------------------------------------------------------------------------

CONV_CASES = {
    # name: (kernel size, bias, smooth_alpha, cal_mode or None for dynamic)
    'dynamic_3x3': (3, True, 0.0, None),
    'dynamic_1x1_nobias': (1, False, 0.0, None),
    'calibrated_3x3': (3, True, 0.0, 'max'),
    'calibrated_p99.9_1x1': (1, True, 0.0, 'p99.9'),
    'smooth0.5_3x3': (3, True, 0.5, None),
    'smooth0.75_1x1_nobias': (1, False, 0.75, None),
    'smooth0.5_calibrated_3x3': (3, True, 0.5, 'max'),
}


def _capture_conv(monkeypatch):
    """Record the int8 operands and int32 result of JAX QuantConv's conv."""
    seen = []
    real = jax.lax.conv_general_dilated

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((np.asarray(args[0]), np.asarray(args[1]),
                     np.asarray(out)))
        return out
    monkeypatch.setattr(jax.lax, 'conv_general_dilated', spy)
    return seen


@pytest.mark.parametrize('case', sorted(CONV_CASES))
def test_quantconv_matches_jax(case, monkeypatch):
    ks, bias, alpha, cal = CONV_CASES[case]
    cin, cout = 12, 20
    rng = np.random.default_rng(sorted(CONV_CASES).index(case))
    scale_ch = np.where(np.arange(cin) == 5, 30.0, 1.0).astype(np.float32)
    x = (rng.normal(size=(2, 9, 7, cin)) * scale_ch).astype(np.float32)
    x_cal = (rng.normal(size=(3, 9, 7, cin)) * 1.3 * scale_ch).astype(
        np.float32)
    jm = jq.QuantConv(cout, (ks, ks), padding=ks // 2, use_bias=bias,
                      smooth_alpha=alpha, cal_mode=cal or 'max')
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    if bias:     # a non-zero bias, so the epilogue's add is exercised
        variables = {'params': {**variables['params'], 'bias': jnp.asarray(
            rng.normal(size=(cout,)).astype(np.float32))}}
    tm = tq.QuantConv(cin, cout, ks, padding=ks // 2, bias=bias,
                      smooth_alpha=alpha, cal_mode=cal or 'max')
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.transpose(np.array(
            variables['params']['kernel']), (3, 2, 0, 1))))
        if bias:
            tm.bias.copy_(torch.from_numpy(np.array(
                variables['params']['bias'])))
    if cal is not None:
        variables = jq.calibrate_quant(jm, variables,
                                       [((jnp.asarray(x_cal),), {})])
        assert tq.calibrate_quant(tm, [((nchw(x_cal),), {})])
        stat = 'act_amax_ch' if alpha else 'act_scale'
        np.testing.assert_allclose(
            getattr(tm, stat).numpy(),
            np.asarray(variables['quant_stats'][stat]), rtol=STAT_RTOL[stat])

    seen = _capture_conv(monkeypatch)
    y_jax = np.asarray(jm.apply(variables, jnp.asarray(x)))
    (xq_jax, wq_jax, acc_jax), = seen
    xq, wq, scale = tm.quantize(nchw(x))
    np.testing.assert_array_equal(xq.numpy(), xq_jax)
    np.testing.assert_array_equal(wq.permute(1, 2, 3, 0).numpy(), wq_jax)
    acc = int8_conv_plain(xq, wq, padding=ks // 2, out_dtype=torch.int32)
    np.testing.assert_array_equal(acc.numpy(), acc_jax)
    with torch.no_grad():
        y = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert np.abs(y - y_jax).max() <= CONV_RTOL * np.abs(y_jax).max()


@pytest.mark.parametrize('b, h, w, cin, cout, ks', [
    (2, 5, 7, 3, 5, 3), (1, 6, 6, 40, 24, 3), (3, 4, 9, 17, 33, 1),
    (2, 8, 8, 64, 16, 1)])
def test_int8_conv_plain_matches_lax_conv(b, h, w, cin, cout, ks):
    rng = np.random.default_rng(cin)
    xq = rng.integers(-127, 128, size=(b, h, w, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, size=(cout, ks, ks, cin), dtype=np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(np.transpose(wq, (1, 2, 3, 0))),
        window_strides=(1, 1), padding=[(ks // 2, ks // 2)] * 2,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    got = int8_conv(torch.from_numpy(xq), torch.from_numpy(wq),
                    padding=ks // 2, out_dtype=torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the epilogue is acc * scale + bias as two float32 roundings
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        y = int8_conv(torch.from_numpy(xq), torch.from_numpy(wq), scale, bias,
                      padding=ks // 2, out_dtype=dt)
        assert torch.equal(y, (got.float() * scale + bias).to(dt))


def test_int8_conv_rejects_what_the_kernel_does_not_take():
    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    wq = torch.zeros((4, 3, 3, 8), dtype=torch.int8)
    scale = torch.ones(4)
    with pytest.raises(ValueError, match='same'):
        int8_conv(xq, wq, scale, padding=0)
    with pytest.raises(TypeError, match='int8'):
        int8_conv(xq.float(), wq, scale, padding=1)
    with pytest.raises(ValueError, match='scale'):
        int8_conv(xq, wq, padding=1)
    with pytest.raises(ValueError, match='no scale'):
        int8_conv(xq, wq, scale, padding=1, out_dtype=torch.int32)
    with pytest.raises(RuntimeError, match='no kernel'):
        int8_conv(xq.to('meta'), wq.to('meta'), scale.to('meta'), padding=1)


# ---------------------------------------------------------------------------
# The contracts of tests/test_quant.py, on the port
# ---------------------------------------------------------------------------

def test_quantconv_state_dict_matches_conv2d():
    """Same parameter names and shapes as Conv2d, and no statistic in the
    state dict, calibrated or not: checkpoints load either way."""
    q = tq.QuantConv(4, 16, 3, padding=1)
    f = Conv2d(4, 16, 3, padding=1)
    for m in (q, f):
        torch.manual_seed(0)
        m.reset_parameters()
    assert {k: v.shape for k, v in q.state_dict().items()} == \
        {k: v.shape for k, v in f.state_dict().items()}
    for k in f.state_dict():
        assert torch.equal(q.state_dict()[k], f.state_dict()[k])
    tq.calibrate_quant(q, [((torch.randn(2, 4, 8, 8),), {})])
    assert q.act_scale is not None
    assert set(q.state_dict()) == set(f.state_dict())


def test_quant_unet_state_dict_identical_and_no_stats():
    _, variables = jax_net({})
    assert 'quant_stats' not in variables
    qnet = port_net({}, variables)
    fnet = port_net({'quantize': 'none'}, variables)
    assert tq.quant_convs(qnet) and not tq.quant_convs(fnet)
    assert not tq.has_calibration(qnet)
    sq, sf = qnet.state_dict(), fnet.state_dict()
    assert list(sq) == list(sf)
    assert all(torch.equal(sq[k], sf[k]) for k in sq)


@pytest.mark.parametrize('kw', [{'quantize_min_channels': 16}, {},
                                {'pixel_shuffle_upsample': False,
                                 'quantize_min_channels': 16},
                                {'ddpm_unet_dim_mults': '1,2,4',
                                 'full_attn': 'False,False,True',
                                 'quantize_min_channels': 16}])
def test_quant_sites_match_jax(kw):
    """The port's QuantConvs sit where the JAX net records quant_stats, at
    the JAX net's widths, under flax paths that ``flax_path`` maps back."""
    from srgd_tpu_torch.checkpoint import flax_path, module_name
    jnet, variables = jax_net(kw)
    x, t, cond, lb = inputs(b=1)
    _, upd = jnet.apply(variables, jnp.asarray(x), jnp.asarray(t),
                        cond=jnp.asarray(cond), class_label=jnp.asarray(lb),
                        mutable=['quant_stats'])
    want = sorted(p.rpartition('/')[0] for p in _flat_keys(upd['quant_stats']))
    names = [n for n, _ in tq.quant_convs(port_net(kw, variables))]
    assert sorted(flax_path(n) for n in names) == want
    shuffle = kw.get('pixel_shuffle_upsample', True)
    assert [module_name(flax_path(n), pixel_shuffle_upsample=shuffle)
            for n in names] == names
    assert 'init_conv' not in names and 'final_conv' not in names


def _flat_keys(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_keys(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}'


def test_quant_forward_close_to_float():
    _, variables = jax_net({'unet_dim': 16})
    qnet = port_net({'unet_dim': 16}, variables)
    fnet = port_net({'unet_dim': 16, 'quantize': 'none'}, variables)
    x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    t, lb = np.zeros(2, np.float32), np.zeros(2, np.int64)
    yf = run_port(fnet, x, t, x, lb)
    yq = run_port(qnet, x, t, x, lb)
    rel = float((yf - yq).abs().max() / yf.abs().max())
    assert rel < 0.10, rel


def test_quant_min_channels_disables_narrow_blocks():
    """quantize_min_channels above every width: no QuantConv, and the float
    net's bits."""
    _, variables = jax_net({})
    qnet = port_net({'quantize_min_channels': 4096}, variables)
    fnet = port_net({'quantize': 'none'}, variables)
    assert not tq.quant_convs(qnet)
    x, t, cond, lb = inputs(b=1, seed=1)
    assert torch.equal(run_port(qnet, x, t, cond, lb),
                       run_port(fnet, x, t, cond, lb))


def test_smoothquant_beats_per_tensor_on_outlier_channels():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 8).astype(np.float32)
    x[..., 3] *= 100.0                      # outlier channel
    plain = tq.QuantConv(8, 16, 3, padding=1)
    smooth = tq.QuantConv(8, 16, 3, padding=1, smooth_alpha=0.5)
    ref = Conv2d(8, 16, 3, padding=1)
    smooth.load_state_dict(plain.state_dict())
    ref.load_state_dict(plain.state_dict())
    with torch.no_grad():
        y_ref = ref(nchw(x))
        e_plain = float(((plain(nchw(x)) - y_ref) ** 2).mean())
        e_smooth = float(((smooth(nchw(x)) - y_ref) ** 2).mean())
    assert e_smooth < e_plain * 0.25, (e_smooth, e_plain)


def test_smoothquant_calibrated_matches_dynamic_on_calib_input():
    rs = np.random.RandomState(2)
    x = nchw(rs.randn(2, 12, 12, 6).astype(np.float32)
             * np.array([1, 1, 50, 1, 1, 1], np.float32))
    m = tq.QuantConv(6, 12, 3, padding=1, smooth_alpha=0.5)
    with torch.no_grad():
        y_dyn = m(x)
        assert tq.calibrate_quant(m, [((x,), {})])
        assert m.act_amax_ch.shape == (6,) and m.act_scale is None
        y_cal = m(x)
    torch.testing.assert_close(y_cal, y_dyn, rtol=1e-6, atol=1e-6)


def test_quant_spec_threading_and_rejections():
    assert _quant_spec(tiny_conf(quantize='none')) is None
    assert _quant_spec(tiny_conf()) == 'w8a8'
    assert _quant_spec(tiny_conf(quantize_smooth_alpha=0.5)) == 'w8a8:0.5'
    assert _quant_spec(tiny_conf(quantize_cal_mode='p99.9')) == 'w8a8:0:p99.9'
    for spec in ('w8a8:0.5', 'w8a8:0:p99.9'):
        assert _quant_spec(tiny_conf(quantize_smooth_alpha=0.5)
                           if spec == 'w8a8:0.5'
                           else tiny_conf(quantize_cal_mode='p99.9')) == \
            _quant_spec(tiny_conf(
                JaxConfig, **({'quantize_smooth_alpha': 0.5}
                              if spec == 'w8a8:0.5'
                              else {'quantize_cal_mode': 'p99.9'})))
    m = tq.conv(8, 8, 1, quant='w8a8:0.5')
    assert isinstance(m, tq.QuantConv) and m.smooth_alpha == 0.5
    m = tq.conv(8, 8, 3, padding=1, quant='w8a8:0:p99.9')
    assert m.cal_mode == 'p99.9' and m.smooth_alpha == 0.0
    assert type(tq.conv(8, 8, 1)) is Conv2d
    with pytest.raises(ValueError, match='unknown quantize'):
        _quant_spec(tiny_conf(quantize='w8a8cal'))
    with pytest.raises(ValueError, match='quantize_smooth_alpha'):
        _quant_spec(tiny_conf(quantize_smooth_alpha=1.5))
    with pytest.raises(ValueError, match='quantize_cal_mode'):
        _quant_spec(tiny_conf(quantize_cal_mode='p99.9',
                              quantize_smooth_alpha=0.5))
    bad = tq.QuantConv(4, 8, 3, padding=1, smooth_alpha=0.5,
                       cal_mode='p99.9')
    with pytest.raises(ValueError, match='cal_mode'):
        bad(torch.zeros(1, 4, 8, 8))


@pytest.mark.parametrize('shape, q', [((64, 64), 'p99.9'), ((33, 7), 'p99'),
                                      ((5, 5), 'p50'), ((100,), 'p100')])
def test_cal_amax_matches_jnp_quantile(shape, q):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    x.reshape(-1)[0] = 1000.0
    want = float(jq._cal_amax(jnp.asarray(x), q))
    got = float(tq._cal_amax(torch.from_numpy(x), q))
    assert got == pytest.approx(want, rel=1e-6, abs=0)
    assert float(tq._cal_amax(torch.from_numpy(x), 'max')) == 1000.0


def test_cal_amax_percentile_clips_outliers():
    rs = np.random.RandomState(0)
    bulk = torch.from_numpy(rs.randn(64, 64).astype(np.float32))
    spiked = bulk.clone()
    spiked[0, 0] = 1000.0
    assert float(tq._cal_amax(spiked, 'p99.9')) < 0.02 * 1000.0
    amax_b = float(bulk.abs().max())
    assert float(tq._cal_amax(bulk, 'max')) == amax_b
    assert float(tq._cal_amax(bulk, 'p99.9')) > 0.6 * amax_b
    with pytest.raises(ValueError, match='cal_mode'):
        tq._cal_amax(bulk, 'mse')
    with pytest.raises(ValueError, match='percentile'):
        tq._cal_amax(bulk, 'p0')


def test_cal_mode_percentile_beats_max_on_outlier_input():
    x_cal = np.random.RandomState(1).randn(1, 8, 8, 16).astype(np.float32)
    x_cal[0, 0, 0, 0] = 500.0
    x_eval = nchw(np.random.RandomState(2).randn(1, 8, 8, 16).astype(
        np.float32))
    ref = Conv2d(16, 8, 3, padding=1)

    def static_out(mode):
        m = tq.QuantConv(16, 8, 3, padding=1, cal_mode=mode)
        m.load_state_dict(ref.state_dict())
        tq.calibrate_quant(m, [((nchw(x_cal),), {})])
        with torch.no_grad():
            return m(x_eval)

    with torch.no_grad():
        y = ref(x_eval)
    err_max = float(((static_out('max') - y) ** 2).mean())
    err_pct = float(((static_out('p99') - y) ** 2).mean())
    assert err_pct < 0.25 * err_max, (err_pct, err_max)


def test_calibrate_sampler_noop_without_quantconvs():
    conf = tiny_conf(quantize_min_channels=4096)
    net = build_unet_from_config(conf)
    wrapper = build_wrapper(conf, net)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert tq.calibrate_sampler(wrapper, tile_size=16, batch=1) is False
    assert not tq.has_calibration(net) and net.quant_stats_times is None
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())


@pytest.mark.parametrize('model', ['conditional_continuous',
                                   'conditional_gaussian',
                                   'conditional_elucidated'])
def test_calibration_times_match_jax(model):
    kw = dict(model=model, timesteps=20, sampling_timesteps=10,
              num_sample_steps=6,
              learned_sinusoidal_cond=model != 'conditional_gaussian')
    jnet, variables = jax_net(kw)
    jw = jax_build_wrapper(tiny_conf(JaxConfig, **kw), jnet)
    net = port_net(kw, variables)
    w = build_wrapper(tiny_conf(**kw), net)
    for n in (1, 2, 5, 6):
        want = np.asarray(jw.calibration_times(variables, n), np.float32)
        got = w.calibration_times(n)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_calibration_times_learned_schedule_match_jax():
    """The continuous family's table comes from the learned log-SNR net."""
    from srgd_tpu.factory import get_model as jax_get_model
    from srgd_tpu_torch.factory import get_model
    kw = dict(noise_schedule='learned', learned_schedule_net_hidden_dim=16)
    jconf = tiny_conf(JaxConfig, **kw)
    jw, _, params = jax_get_model(jconf)
    w, _ = get_model(tiny_conf(**kw), device='cpu')
    sd = state_dict_from_jax(params)
    w.log_snr.load_state_dict({k[len('log_snr.'):]: v for k, v in sd.items()
                               if k.startswith('log_snr.')})
    # the bar of tests/test_torch_families.py for the learned schedule
    np.testing.assert_allclose(w.calibration_times(6),
                               np.asarray(jw.calibration_times(params, 6)),
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# The quantized U-Net against JAX
# ---------------------------------------------------------------------------

NET_CASES = {
    'dynamic': {},
    'smooth0.5': {'quantize_smooth_alpha': 0.5},
    'min16': {'quantize_min_channels': 16},
    'nearest_upsample': {'pixel_shuffle_upsample': False},
}


@pytest.mark.parametrize('case', sorted(NET_CASES))
def test_quant_unet_matches_jax(case, monkeypatch):
    kw = NET_CASES[case]
    jnet, variables = jax_net(kw, seed=1)
    net = port_net(kw, variables)
    x, t, cond, lb = inputs(seed=2)
    codes = JaxCodes(monkeypatch)
    want = jnet.apply(variables, jnp.asarray(x), jnp.asarray(t),
                      cond=jnp.asarray(cond), class_label=jnp.asarray(lb))
    assert_net_close(run_port(net, x, t, cond, lb), want)
    codes.done()


def test_select_time_stats_picks_jax_index():
    """On, between and tied between calibration times: the same index, the
    first winning a tie."""
    times = np.array([4.0, 2.0, 0.0, -2.0], np.float32)
    stacked = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    net = build_unet_from_config(tiny_conf())
    (name, conv), *_ = tq.quant_convs(net)
    conv.act_scale_t = torch.from_numpy(stacked)
    net.quant_stats_times = torch.from_numpy(times)
    jparams = {'params': {}, 'quant_stats_times': jnp.asarray(times),
               'quant_stats_t': {'c': {'act_scale': jnp.asarray(stacked)}}}
    for t in (4.0, 2.0, -2.0, 3.0, 1.0, -1.0, 0.7, -5.0, 9.0):
        select_time_stats(net, torch.tensor(t))
        want = jax_select(jparams, jnp.float32(t))['quant_stats']['c']
        assert float(conv.act_scale) == float(want['act_scale']), t


def test_deep_cache_forward_int8_matches_jax(monkeypatch):
    """A DeepCache full forward (return_cache) and a cached one, quantized,
    against the JAX net's."""
    kw = {'ddpm_unet_dim_mults': '1,2,4', 'full_attn': 'False,False,True'}
    jnet, variables = jax_net(kw)
    net = port_net(kw, variables)
    x, t, cond, lb = inputs(seed=5)
    codes = JaxCodes(monkeypatch)
    args = (jnp.asarray(x), jnp.asarray(t))
    jkw = dict(cond=jnp.asarray(cond), class_label=jnp.asarray(lb))
    want, want_cache = jnet.apply(variables, *args, **jkw, cache_depth=1,
                                  return_cache=True)
    got, cache = run_port(net, x, t, cond, lb, cache_depth=1,
                          return_cache=True)
    assert_net_close(got, want)
    assert_net_close(cache, want_cache)
    want_c = jnet.apply(variables, *args, **jkw, cache_depth=1,
                        deep_cache=want_cache)
    got_c = run_port(net, x, t, cond, lb, cache_depth=1, deep_cache=cache)
    assert_net_close(got_c, want_c)
    codes.done()


def test_quant_use_pallas_routes():
    """quant + use_pallas in the port, held as tests/test_torch_layers.py
    holds the use_pallas route: the same net without use_pallas gives the
    same result but for to_out of the linear attention, which runs in float
    where n % 256 == 0 (the JAX module's Pallas branch declares a float
    nn.Conv there) and stays quantized elsewhere."""
    from srgd_tpu_torch.nn.layers import LinearAttention
    torch.manual_seed(0)
    plain = LinearAttention(16, quant='w8a8')
    pallas = LinearAttention(16, quant='w8a8', use_pallas=True)
    pallas.load_state_dict(plain.state_dict())
    with torch.no_grad():
        for hw, float_out in ((16, True), (12, False)):
            x = torch.randn(2, 16, hw, hw).contiguous(
                memory_format=torch.channels_last)
            qkv = plain.to_qkv(plain.norm(x))
            from srgd_tpu_torch.kernels.linear_attention import (
                linear_attention_qkv)
            core = linear_attention_qkv(
                qkv.permute(0, 2, 3, 1).reshape(2, hw * hw, -1))
            core = core.reshape(2, hw, hw, -1).permute(0, 3, 1, 2)
            to_out = (Conv2d.forward(plain.to_out[0], core) if float_out
                      else plain.to_out[0](core))
            want = plain.to_out[1](to_out)
            assert torch.equal(pallas(x), want)
            if not float_out:
                assert torch.equal(plain(x), want)
