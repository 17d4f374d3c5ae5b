"""Each layer of the port against its flax counterpart at float32.

The weights of a small JAX U-Net cross into the port through
``state_dict_from_jax``; then every layer kind runs on the same numpy inputs
in both (NHWC in JAX, the same memory as NCHW channels_last in the port) and
must agree to atol 1e-4."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.nn import layers as jl
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch.checkpoint import state_dict_from_jax
from srgd_tpu_torch.nn import layers as tl
from srgd_tpu_torch.nn.unet import SRUnet

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

ATOL = 1e-4
DIM, MULTS, FULL = 16, (1, 2), (False, True)


def _pair(pixel_shuffle=True):
    kw = dict(dim=DIM, dim_mults=MULTS, full_attn=FULL,
              learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
              num_classes=3, pixel_shuffle_upsample=pixel_shuffle)
    jnet = JaxUnet(**kw)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                       jnp.zeros((1,)), class_label=jnp.zeros((1,), jnp.int32))
    params = params['params']
    net = SRUnet(**kw)
    net.load_state_dict(state_dict_from_jax(
        params, pixel_shuffle_upsample=pixel_shuffle), strict=True)
    return params, net


@pytest.fixture(scope='module')
def nets():
    return {True: _pair(True), False: _pair(False)}


def _img(c, hw=8, b=2, seed=0):
    return np.random.default_rng(seed).normal(size=(b, hw, hw, c)).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _t_emb(seed=1):
    return np.random.default_rng(seed).normal(size=(2, 4 * DIM)).astype(
        np.float32)


# name -> (flax module, params path, port module getter, input builder)
CASES = {
    'rmsnorm': (lambda: jl.RMSNorm(DIM), ('downs_0_2', 'norm'),
                lambda n: n.downs[0][2].norm, 'img16'),
    'learned_sinusoidal': (lambda: jl.LearnedSinusoidalPosEmb(8),
                           ('time_mlp', 'pos_emb'),
                           lambda n: n.time_mlp[0], 'time'),
    'time_mlp': (lambda: jl.TimeMLP(DIM, 4 * DIM, True, 8), ('time_mlp',),
                 lambda n: n.time_mlp, 'time'),
    'class_mlp': (lambda: jl.ClassMLP(3, DIM, 4 * DIM), ('class_mlp',),
                  lambda n: n.class_mlp, 'label'),
    'block': (lambda: jl.Block(DIM), ('downs_0_0', 'block2'),
              lambda n: n.downs[0][0].block2, 'img16'),
    'block_film': (lambda: jl.Block(DIM), ('downs_0_0', 'block1'),
                   lambda n: n.downs[0][0].block1, 'img16_film'),
    'resnet_block': (lambda: jl.ResnetBlock(DIM, DIM, time_emb_dim=4 * DIM),
                     ('downs_0_1',), lambda n: n.downs[0][1], 'img16_t'),
    'resnet_block_res_conv': (
        lambda: jl.ResnetBlock(2 * DIM, DIM, time_emb_dim=4 * DIM),
        ('ups_1_0',), lambda n: n.ups[1][0], 'img32_t'),
    'linear_attention': (lambda: jl.LinearAttention(DIM), ('downs_0_2',),
                         lambda n: n.downs[0][2], 'img16'),
    'attention': (lambda: jl.Attention(DIM), ('downs_1_2',),
                  lambda n: n.downs[1][2], 'img16'),
    'downsample': (lambda: jl.Downsample(DIM), ('downs_0_3',),
                   lambda n: n.downs[0][3], 'img16'),
    'pixel_shuffle_upsample': (lambda: jl.PixelShuffleUpsample(2 * DIM, DIM),
                               ('ups_0_3',), lambda n: n.ups[0][3], 'img32'),
    'nearest_upsample': (lambda: jl.NearestUpsample(DIM), ('ups_0_3',),
                         lambda n: n.ups[0][3], 'img32_nearest'),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_layer_matches_flax(nets, name):
    make_flax, path, get_port, kind = CASES[name]
    params, net = nets[not kind.endswith('_nearest')]
    p = params
    for k in path:
        p = p[k]
    jmod, tmod = make_flax(), get_port(net)

    if kind == 'time':
        t = np.random.default_rng(2).normal(size=(3,)).astype(np.float32)
        want = jmod.apply({'params': p}, jnp.asarray(t))
        got = tmod(torch.from_numpy(t)).detach().numpy()
    elif kind == 'label':
        lab = np.asarray([0, 2, 1])
        want = jmod.apply({'params': p}, jnp.asarray(lab))
        got = tmod(torch.from_numpy(lab)).detach().numpy()
    else:
        c = int(kind[3:5])
        x = _img(c)
        args, targs = (jnp.asarray(x),), (_nchw(x),)
        if kind.endswith('_t'):
            te = _t_emb()
            args, targs = args + (jnp.asarray(te),), targs + (
                torch.from_numpy(te),)
        if kind.endswith('_film'):
            rng = np.random.default_rng(3)
            s, sh = (rng.normal(size=(2, 1, 1, DIM)).astype(np.float32) * 0.3
                     for _ in range(2))
            want = jmod.apply({'params': p}, jnp.asarray(x),
                              scale_shift=(jnp.asarray(s), jnp.asarray(sh)))
            got = _nhwc(tmod(_nchw(x), scale_shift=(_nchw(s), _nchw(sh))))
        else:
            want = jmod.apply({'params': p}, *args)
            got = _nhwc(tmod(*targs))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX modules import their Pallas kernels at call time; run them in
    interpret mode per call (far faster than force_tpu_interpret_mode)."""
    from srgd_tpu.kernels import attention, groupnorm_silu, linear_attention
    for mod, name in ((attention, 'fused_attention'),
                      (groupnorm_silu, 'fused_groupnorm_silu'),
                      (linear_attention, 'fused_linear_attention_qkv')):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))


# name -> (flax module, params path, port module getter, (h, w), FiLM?)
FLAG_CASES = {
    'block': (lambda: jl.Block(DIM, use_pallas=True),
              ('downs_0_0', 'block2'), lambda n: n.downs[0][0].block2,
              (8, 8), False),
    'block_film': (lambda: jl.Block(DIM, use_pallas=True),
                   ('downs_0_0', 'block1'), lambda n: n.downs[0][0].block1,
                   (8, 8), True),
    # n = 256 reaches the JAX kernel; at n = 64 the JAX module takes its
    # plain core, while the port keeps one route at every n
    'linear_attention_n256': (
        lambda: jl.LinearAttention(DIM, use_pallas=True), ('downs_0_2',),
        lambda n: n.downs[0][2], (16, 16), False),
    'linear_attention_n64': (
        lambda: jl.LinearAttention(DIM, use_pallas=True), ('downs_0_2',),
        lambda n: n.downs[0][2], (8, 8), False),
    'attention': (lambda: jl.Attention(DIM, use_pallas=True, fused=False),
                  ('downs_1_2',), lambda n: n.downs[1][2], (16, 16), False),
}


@pytest.fixture(scope='module')
def flag_net(nets):
    params, net = nets[True]
    flagged = SRUnet(dim=DIM, dim_mults=MULTS, full_attn=FULL,
                     learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
                     num_classes=3, use_pallas=True, use_pallas_attention=True,
                     fused_linattn=False)
    flagged.load_state_dict(net.state_dict(), strict=True)
    return params, flagged


@pytest.mark.parametrize('name', sorted(FLAG_CASES))
def test_flagged_layer_matches_flax(flag_net, interpret_kernels, name):
    """The kernel flags on in both: the port's plain versions against the
    flax modules' Pallas kernels."""
    make_flax, path, get_port, (h, w), film = FLAG_CASES[name]
    params, net = flag_net
    p = params
    for k in path:
        p = p[k]
    tmod = get_port(net)
    assert tmod.use_pallas
    x = np.random.default_rng(5).normal(size=(2, h, w, DIM)).astype(np.float32)
    kw, tkw = {}, {}
    if film:
        rng = np.random.default_rng(3)
        s, sh = (rng.normal(size=(2, 1, 1, DIM)).astype(np.float32) * 0.3
                 for _ in range(2))
        kw = dict(scale_shift=(jnp.asarray(s), jnp.asarray(sh)))
        tkw = dict(scale_shift=(_nchw(s), _nchw(sh)))
    want = np.asarray(make_flax().apply({'params': p}, jnp.asarray(x), **kw))
    out = tmod(_nchw(x), **tkw)
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = _nhwc(out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_attention_routing_follows_the_flags(monkeypatch):
    """bfloat16 with ``fused`` keeps the whole-block kernel even under
    ``use_pallas``; float32, or ``fused=False``, goes to ``attention``; the
    default net routes as before."""
    from srgd_tpu_torch.kernels import attention as at

    calls = []

    def spy(*a):
        calls.append(1)
        return at.attention_plain(*a)

    monkeypatch.setattr(tl, 'attention', spy)
    x = _nchw(_img(128, hw=8))          # hidden = 128, n = 64
    for dtype, use_pallas, fused, expect in (
            (torch.bfloat16, True, True, 0), (torch.bfloat16, True, False, 1),
            (torch.float32, True, True, 1), (torch.float32, False, True, 0),
            (torch.float32, False, False, 0)):
        mod = tl.Attention(128, dtype=dtype, use_pallas=use_pallas,
                           fused=fused)
        calls.clear()
        with torch.no_grad():
            out = mod(x)
        assert len(calls) == expect, (dtype, use_pallas, fused)
        assert out.dtype == dtype and out.shape == x.shape


@pytest.mark.parametrize('hw', [16, 8, 5])
def test_flagged_linear_attention_has_one_route(monkeypatch, hw):
    """With ``use_pallas`` the core is ``linear_attention_qkv`` at every n,
    also where n is no multiple of 256: the module never takes plain tensor
    code of its own, so on the card it launches the kernel or raises."""
    from srgd_tpu_torch.kernels import linear_attention as la

    calls = []

    def spy(qkv, **kw):
        calls.append(tuple(qkv.shape))
        return la.linear_attention_qkv_plain(qkv, **kw)

    monkeypatch.setattr(tl, 'linear_attention_qkv', spy)
    mod = tl.LinearAttention(DIM, use_pallas=True)
    x = _nchw(_img(DIM, hw=hw))
    with torch.no_grad():
        out = mod(x)
    assert calls == [(x.shape[0], hw * hw, 3 * 128)]
    assert out.shape == x.shape


def test_sinusoidal_pos_emb_matches_flax():
    t = np.random.default_rng(4).normal(size=(5,)).astype(np.float32) * 10
    want = jl.SinusoidalPosEmb(16).apply({}, jnp.asarray(t))
    got = tl.SinusoidalPosEmb(16)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_channel_order_contracts():
    """pixel-shuffle reads channel c*4 + dy*2 + dx and space-to-depth writes
    channel c*4 + p1*2 + p2 (the reference's Rearrange)."""
    x = torch.arange(2 * 8 * 4 * 4, dtype=torch.float32).reshape(2, 8, 4, 4)
    down = torch.nn.PixelUnshuffle(2)(x)
    for c in range(8):
        for p1 in range(2):
            for p2 in range(2):
                assert torch.equal(down[:, c * 4 + p1 * 2 + p2],
                                   x[:, c, p1::2, p2::2])
    up = torch.nn.PixelShuffle(2)(down)
    assert torch.equal(up, x)


def test_random_init_keeps_pixel_shuffle_checkerboard_free():
    """init_weights gives each pixel-shuffle conv one kernel repeated over
    the 4 sub-pixels of every output channel, and a zero bias."""
    net = SRUnet(dim=DIM, dim_mults=MULTS, full_attn=FULL)
    net.init_weights(torch.Generator().manual_seed(0))
    conv = net.ups[0][3].net[0]
    w = conv.weight.detach()
    for k in range(1, 4):
        assert torch.equal(w[k::4], w[0::4])
    assert torch.count_nonzero(conv.bias) == 0
    assert w.abs().max() > 0


def test_attention_blocks_take_channels_last_views(nets):
    """The attention blocks hand the kernels (b, h*w, c) views of a
    channels_last activation, and return channels_last."""
    _, net = nets[True]
    x = _nchw(_img(DIM))
    assert x.is_contiguous(memory_format=torch.channels_last)
    rows = tl._as_rows(x)
    assert rows.data_ptr() == x.data_ptr() and rows.is_contiguous()
    out = net.downs[0][2](x)
    assert out.is_contiguous(memory_format=torch.channels_last)
