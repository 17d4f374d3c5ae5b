"""The port's SRUnet against the JAX SRUnet on reference-format weights.

The six configurations of tests/test_unet_parity.py: a state dict with the
reference's key names (tests/torch_ref.make_state_dict) loads into the port
with ``strict=True`` and into the JAX net through the converter; both nets
run the same numpy inputs and agree to atol 1e-4 at float32. Plus the two
CFG nulls and one loose bf16 check."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.checkpoint.torch_convert import convert_unet_state_dict
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch.nn.unet import SRUnet
from tests.torch_ref import make_state_dict

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

ATOL = 1e-4
FLAGS = dict(use_pallas=True, use_pallas_attention=True, fused_linattn=False)

CONFIGS = {
    '2stage': dict(),
    '3stage_conditional': dict(dim=8, dim_mults=(1, 2, 4),
                               full_attn=(False, False, True), size=24,
                               num_classes=3, with_label=True, seed=1),
    'nearest_upsample': dict(pixel_shuffle=False, seed=2),
    'plain_sinusoidal': dict(learned_sinusoidal=False, seed=3),
    'no_cond': dict(with_cond=False, seed=4),
    'conditional_no_label': dict(num_classes=3, seed=6),
}


def _pair(dim=16, dim_mults=(1, 2), full_attn=(False, True), num_classes=None,
          learned_sinusoidal=True, pixel_shuffle=True, seed=0, dtype=None,
          **flags):
    sd = make_state_dict(dim=dim, dim_mults=dim_mults, full_attn=full_attn,
                         num_classes=num_classes,
                         learned_sinusoidal=learned_sinusoidal,
                         learned_sinusoidal_dim=8, pixel_shuffle=pixel_shuffle,
                         seed=seed)
    params, unmatched = convert_unet_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_stages=len(dim_mults))
    assert not unmatched
    kw = dict(dim=dim, dim_mults=dim_mults, full_attn=full_attn,
              learned_sinusoidal_cond=learned_sinusoidal,
              learned_sinusoidal_dim=8, pixel_shuffle_upsample=pixel_shuffle,
              num_classes=num_classes)
    net = SRUnet(**kw, **flags, dtype=dtype or torch.float32)
    net.load_state_dict(sd, strict=True)
    return JaxUnet(**kw, **flags), params, net


def _forward(net, x, t, cond=None, label=None, mask=None):
    nchw = (lambda a: None if a is None
            else torch.from_numpy(a).permute(0, 3, 1, 2))
    tens = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    with torch.inference_mode():
        out = net(nchw(x), torch.from_numpy(t), cond=nchw(cond),
                  class_label=tens(label), class_mask=tens(mask))
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_unet_matches_jax(name):
    cfg = dict(CONFIGS[name])
    size = cfg.pop('size', 16)
    with_cond = cfg.pop('with_cond', True)
    with_label = cfg.pop('with_label', False)
    jnet, params, net = _pair(**cfg)
    rng = np.random.default_rng(cfg.get('seed', 0))
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    cond = (rng.normal(size=(2, size, size, 3)).astype(np.float32)
            if with_cond else None)
    t = rng.normal(size=(2,)).astype(np.float32)
    label = (rng.integers(0, cfg['num_classes'], size=(2,))
             if with_label else None)
    want = jnet.apply({'params': params}, jnp.asarray(x), jnp.asarray(t),
                      cond=None if cond is None else jnp.asarray(cond),
                      class_label=None if label is None else jnp.asarray(label))
    got = _forward(net, x, t, cond, label)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


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


@pytest.fixture(scope='module')
def flagged_pair():
    return _pair(num_classes=3, seed=9, **FLAGS)


@pytest.mark.parametrize('size', [16, 24], ids=['n256', 'n576'])
def test_flagged_unet_matches_jax(flagged_pair, interpret_kernels, size):
    """The slice as a whole: use_pallas, use_pallas_attention and
    fused_linattn=False in both nets, class-conditional. At 16 px the linear
    attention has n = 256 and reaches linear_attention_qkv; at 24 px n = 576
    takes the plain core in both."""
    jnet, params, net = flagged_pair
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    cond = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    t = rng.normal(size=(2,)).astype(np.float32)
    label = np.asarray([2, 0])
    want = jnet.apply({'params': params}, jnp.asarray(x), jnp.asarray(t),
                      cond=jnp.asarray(cond), class_label=jnp.asarray(label))
    got = _forward(net, x, t, cond, label)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_flags_on_match_flags_off(flagged_pair):
    """Inside the port the second kernel set computes the default path's
    function: atol 5e-5 at float32, the bar tests/test_kernels.py sets for the
    JAX net's flag."""
    _, _, flagged = flagged_pair
    _, _, plain = _pair(num_classes=3, seed=9)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = rng.normal(size=(2,)).astype(np.float32)
    label = np.asarray([1, 2])
    a = _forward(plain, x, t, cond, label)
    b = _forward(flagged, x, t, cond, label)
    np.testing.assert_allclose(b, a, atol=5e-5, rtol=0)
    assert np.abs(a).max() > 1e-2


def test_build_from_config_maps_the_kernel_flags():
    from srgd_tpu_torch.config import Config
    from srgd_tpu_torch.nn.layers import Attention, Block, LinearAttention
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    conf = Config(model='conditional_continuous', unet_dim=8,
                  ddpm_unet_dim_mults='1,2', full_attn='False,True',
                  use_pallas_kernels=True, flash_attn=True,
                  fused_linattn=False)
    net = build_unet_from_config(conf, device='meta')
    mods = list(net.modules())
    for cls, flag in ((Block, True), (LinearAttention, True),
                      (Attention, True)):
        picked = [m for m in mods if isinstance(m, cls)]
        assert picked and all(m.use_pallas is flag for m in picked)
    assert all(not m.fused for m in mods if isinstance(m, Attention))
    default = build_unet_from_config(
        Config(model='conditional_continuous', unet_dim=8,
               ddpm_unet_dim_mults='1,2', full_attn='False,True'),
        device='meta')
    assert not any(getattr(m, 'use_pallas', False) for m in default.modules())
    # quantize: w8a8 builds the int8 net (tests/test_torch_quant.py holds
    # it to JAX); an unknown value raises
    from srgd_tpu_torch.nn.quant import quant_convs
    assert quant_convs(build_unet_from_config(
        Config(model='conditional_continuous', unet_dim=8,
               ddpm_unet_dim_mults='1,2', full_attn='False,True',
               quantize='w8a8'), device='meta'))
    with pytest.raises(ValueError, match='unknown quantize'):
        build_unet_from_config(Config(quantize='w8a8cal'), device='meta')
    # remat_unet wraps the blocks in checkpoint: the same parameters
    remat = build_unet_from_config(
        Config(model='conditional_continuous', unet_dim=8,
               ddpm_unet_dim_mults='1,2', full_attn='False,True',
               remat_unet=True), device='meta')
    assert remat.remat and not default.remat
    assert sorted(remat.state_dict()) == sorted(default.state_dict())
    # DeepCache is a sampler option: the net is the same
    cached = build_unet_from_config(
        Config(model='conditional_continuous', unet_dim=8,
               ddpm_unet_dim_mults='1,2', full_attn='False,True',
               deep_cache_interval=2, deep_cache_depth=1), device='meta')
    assert sorted(cached.state_dict()) == sorted(default.state_dict())


def test_class_mask_null_matches_jax_and_equals_no_label():
    jnet, params, net = _pair(dim=8, num_classes=3, seed=5)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = rng.normal(size=(2,)).astype(np.float32)
    label, mask = np.asarray([1, 2]), np.asarray([1.0, 0.0], np.float32)
    want = jnet.apply({'params': params}, jnp.asarray(x), jnp.asarray(t),
                      class_label=jnp.asarray(label),
                      class_mask=jnp.asarray(mask))
    got = _forward(net, x, t, label=label, mask=mask)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    no_label = _forward(net, x, t)
    np.testing.assert_allclose(got[1], no_label[1], atol=1e-6, rtol=0)
    assert np.abs(got[0] - no_label[0]).max() > 1e-4


def test_zeros_cond_null_equals_no_cond():
    _, _, net = _pair(seed=7)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = rng.normal(size=(2,)).astype(np.float32)
    np.testing.assert_array_equal(_forward(net, x, t),
                                  _forward(net, x, t, cond=np.zeros_like(x)))


def test_bf16_forward_tracks_f32():
    """bf16 compute (conv operands, attention blocks) with float32 norm
    statistics stays near the float32 forward: a loose check of the casts."""
    _, _, net32 = _pair(num_classes=3, seed=8)
    _, _, net16 = _pair(num_classes=3, seed=8, dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = rng.normal(size=(2,)).astype(np.float32)
    label = np.asarray([0, 2])
    a = _forward(net32, x, t, cond, label)
    b = _forward(net16, x, t, cond, label)
    assert b.dtype == np.float32 and np.isfinite(b).all()
    assert np.abs(a - b).max() < 0.05 * np.abs(a).max()


def test_downsample_factor_is_checked():
    net = SRUnet(dim=8, dim_mults=(1, 2, 4), full_attn=(False, False, True))
    with pytest.raises(ValueError, match='divisible by 4'):
        net(torch.zeros(1, 3, 18, 18), torch.zeros(1))


SHIPPED_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'conf',
    'conditional_continuous_linear_df8kost_dim128.yaml')


def _seeded_params(shapes, seed):
    """Numpy weights for a JAX param tree of ``shapes`` (a
    ``jax.eval_shape`` of the init): kernels at fan-in scale, gains near 1,
    biases and shifts small, embeddings and the learned sinusoid's
    frequencies standard normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            std = float(np.prod(s.shape[:-1])) ** -0.5
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name in ('g', 'norm_scale'):
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ('bias', 'norm_bias'):
            return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_flagship_width_unet_matches_jax():
    """The shipped YAML's net at its own width (dim 128, mults 1,2,4,8,
    full attention at the last stage, learned sinusoidal 32, 3 classes) in
    float32: one forward of b = 1 at 64 px with a class label and the
    condition image through ``srgd_tpu`` and through the port, on numpy
    weights carried across by ``state_dict_from_jax``, within f32 atol 1e-4
    (tests/test_kernels.py's bar). GroupNorm's 8 groups of 16 to 128
    channels, the 4 heads of 32 and the 1024-channel bottleneck run as they
    run at the card's width."""
    from srgd_tpu.config import load_config as jax_load_config
    from srgd_tpu.nn.unet import build_unet_from_config as jax_build
    from srgd_tpu_torch.checkpoint import state_dict_from_jax
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    conf = load_config(SHIPPED_YAML)
    assert (conf.unet_dim, conf.ddpm_unet_dim_mults, conf.full_attn,
            conf.learned_sinusoidal_dim, conf.num_classes) == (
        128, '1,2,4,8', 'False,False,False,True', 32, 3)
    jnet = jax_build(jax_load_config(SHIPPED_YAML), dtype=jnp.float32)
    rng = np.random.default_rng(128)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    cond = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    t = rng.normal(size=(1,)).astype(np.float32)
    label = np.asarray([2])
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(t), cond=jnp.asarray(cond),
                          class_label=jnp.asarray(label)))['params']
    params = _seeded_params(shapes, seed=128)
    want = jax.jit(lambda p: jnet.apply(
        {'params': p}, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond),
        class_label=jnp.asarray(label)))(params)
    net = build_unet_from_config(conf, dtype=torch.float32)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    assert sum(p.numel() for p in net.parameters()) == 137_569_939
    got = _forward(net.eval(), x, t, cond, label)
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
