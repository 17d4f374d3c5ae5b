"""Each layer of the port against its flax counterpart at float32.

The weights of a small JAX U-Net cross into the port through
``state_dict_from_jax``; then every layer kind runs on the same numpy inputs
in both (NHWC in JAX, the same memory as NCHW channels_last in the port) and
must agree to atol 1e-4."""

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
