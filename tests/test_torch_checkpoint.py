"""The port's parameter layout is the reference checkpoint's.

The released flagship ``.pth`` (dim 128, mults 1,2,4,8, learned sinusoidal
dim 32, 3 classes) is 550,400,570 bytes: 137,569,939 float32 parameters in
280 tensors plus torch's container. The port's net has exactly that layout,
and a reference-format file written from JAX params loads strictly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.checkpoint.torch_convert import export_torch_state_dict
from srgd_tpu.nn.unet import SRUnet as JaxUnet
from srgd_tpu_torch.checkpoint import (load_reference_checkpoint,
                                       state_dict_from_jax)
from srgd_tpu_torch.nn.unet import SRUnet
from tests.torch_ref import make_state_dict

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

FLAGSHIP = dict(dim_mults=(1, 2, 4, 8), full_attn=(False, False, False, True),
                learned_sinusoidal_cond=True, learned_sinusoidal_dim=32,
                num_classes=3)


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def test_flagship_parameter_count_on_meta():
    net = SRUnet(dim=128, **FLAGSHIP, device='meta')
    params = list(net.parameters())
    assert len(params) == 280
    n = sum(p.numel() for p in params)
    assert n == 137_569_939
    assert n * 4 == 550_279_756   # 550.28 MB of float32 weights
    assert not list(net.buffers())


@pytest.mark.parametrize('dim', [16, 128])
def test_flagship_layout_matches_reference_keys(dim):
    """Key names and shapes equal tests/torch_ref.make_state_dict at the
    flagship stage layout: in full at dim 16, and the dim-128 meta net's
    names equal the same reference keys."""
    ref = make_state_dict(dim=16, dim_mults=FLAGSHIP['dim_mults'],
                          full_attn=FLAGSHIP['full_attn'], num_classes=3,
                          learned_sinusoidal_dim=32, seed=0)
    net = SRUnet(dim=dim, **FLAGSHIP, device='meta')
    sd = net.state_dict()
    assert sorted(sd) == sorted(ref)
    if dim == 16:
        assert _shapes(sd) == _shapes(ref)


@pytest.fixture(scope='module')
def jax_params():
    kw = dict(dim=16, dim_mults=(1, 2), full_attn=(False, True),
              learned_sinusoidal_cond=True, learned_sinusoidal_dim=8,
              num_classes=3)
    params = JaxUnet(**kw).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
        class_label=jnp.zeros((1,), jnp.int32))['params']
    return kw, params


def _save(path, sd):
    torch.save({'ema_model': {k: torch.from_numpy(np.array(v))
                              for k, v in sd.items()}}, path)


def test_load_reference_checkpoint_strict(tmp_path, jax_params):
    kw, params = jax_params
    exported = export_torch_state_dict({'params': params},
                                       model='conditional_continuous')
    assert all(k.startswith('model.') for k in exported)
    # schedule buffers the reference registers are dropped on load
    exported['betas'] = np.zeros(4, np.float32)
    path = tmp_path / 'ref.pth'
    _save(path, exported)

    sd = load_reference_checkpoint(path)
    net = SRUnet(**kw)
    net.load_state_dict(sd, strict=True)
    want = state_dict_from_jax(params)
    assert sorted(sd) == sorted(want)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0)


def test_load_reference_checkpoint_rejects_unported(tmp_path, jax_params):
    """A learned log-SNR schedule's entries load (``log_snr.*``, kept beside
    the U-Net's) and equal what the JAX converter reads from the same file;
    any other entry outside the U-Net is still refused."""
    from srgd_tpu.checkpoint.torch_convert import (convert_learned_log_snr,
                                                   load_torch_checkpoint,
                                                   strip_wrapper_prefix)
    from srgd_tpu.diffusion.schedules import init_learned_log_snr
    from srgd_tpu_torch.checkpoint import split_schedule
    from srgd_tpu_torch.diffusion.schedules import LearnedLogSNR
    kw, params = jax_params
    tree = {'params': params,
            'log_snr': init_learned_log_snr(jax.random.PRNGKey(2),
                                            hidden_dim=16)}
    exported = export_torch_state_dict(tree, model='conditional_continuous')
    assert any(k.startswith('log_snr.') for k in exported)
    _save(tmp_path / 'learned.pth', exported)

    unet_sd, schedule_sd = split_schedule(
        load_reference_checkpoint(tmp_path / 'learned.pth'))
    SRUnet(**kw).load_state_dict(unet_sd, strict=True)
    log_snr = LearnedLogSNR(16)
    log_snr.load_state_dict(schedule_sd, strict=True)
    want = convert_learned_log_snr(strip_wrapper_prefix(
        load_torch_checkpoint(str(tmp_path / 'learned.pth')))[1])
    for layer, mod in (('l1', log_snr.net[1]), ('l2', log_snr.net[2].fn[0]),
                       ('l3', log_snr.net[2].fn[2])):
        np.testing.assert_array_equal(mod.net.weight.detach().numpy().T,
                                      want[layer]['kernel'])
        np.testing.assert_array_equal(mod.net.bias.detach().numpy(),
                                      want[layer]['bias'])
    # the JAX tree through state_dict_from_jax gives the same entries
    from_jax = state_dict_from_jax(tree)
    for k, v in {**unet_sd, **{'log_snr.' + k: v
                                for k, v in schedule_sd.items()}}.items():
        torch.testing.assert_close(from_jax[k], v, atol=0, rtol=0)

    # an entry outside the U-Net is left out, as the JAX converter returns
    # it among its extras, whatever load_strict says
    _save(tmp_path / 'extra.pth', dict(exported, stray=np.zeros(1, np.float32)))
    extra = load_reference_checkpoint(tmp_path / 'extra.pth')
    assert 'stray' not in extra
    assert sorted(extra) == sorted(load_reference_checkpoint(
        tmp_path / 'learned.pth'))


# ---------------------------------------------------------------------------
# param_dtype and load_strict through both packages' get_model
# ---------------------------------------------------------------------------

FACTORY_YAML = """
model: conditional_continuous
noise_schedule: linear
unet_dim: 16
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 8
num_classes: 3
"""
BF16_RTOL = 2e-2   # chip_smoke's: max|a - b| <= 2e-2 * max|b|


def _confs(tmp_path, **over):
    from srgd_tpu.config import load_config as jax_load_config
    from srgd_tpu_torch.config import load_config
    path = tmp_path / 'f.yaml'
    path.write_text(FACTORY_YAML + ''.join(f'{k}: {v}\n'
                                           for k, v in over.items()))
    return jax_load_config(str(path)), load_config(str(path))


def _forward_both(jconf, tconf, ckpt, seed=0):
    """The same seeded inputs through JAX's get_model -> apply and the
    port's get_model forward; (jax out, port out, port net)."""
    from srgd_tpu.factory import get_model as jax_get_model
    from srgd_tpu_torch.factory import get_model
    _, jnet, params = jax_get_model(jconf, str(ckpt))
    _, net = get_model(tconf, str(ckpt), device='cpu')
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(-5, 5, size=(2,)).astype(np.float32)
    label = np.array([0, 2], np.int32)
    want = np.asarray(jnet.apply({'params': params['params']}, x, t,
                                 cond=cond, class_label=label), np.float32)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    with torch.inference_mode():
        got = net(nchw(x), torch.from_numpy(t), cond=nchw(cond),
                  class_label=torch.from_numpy(label.astype(np.int64)))
    return want, got.float().permute(0, 2, 3, 1).numpy(), net


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_param_dtype_bfloat16_matches_jax(tmp_path, jax_params, compute_dtype):
    """param_dtype: bfloat16 stores every parameter in bf16 (half the
    float32 net's bytes) and the forward equals JAX's load_params -> apply
    on the same .pth: f32 atol 1e-4 in float32 compute, chip_smoke's bf16
    tolerance in bfloat16."""
    _, params = jax_params
    path = tmp_path / 'ref.pth'
    _save(path, export_torch_state_dict({'params': params},
                                        model='conditional_continuous'))
    jconf, tconf = _confs(tmp_path, param_dtype='bfloat16',
                          compute_dtype=compute_dtype)
    want, got, net = _forward_both(jconf, tconf, path)
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    f32 = _confs(tmp_path, compute_dtype=compute_dtype)[1]
    from srgd_tpu_torch.factory import get_model
    _, net32 = get_model(f32, str(path), device='cpu')
    nbytes = lambda m: sum(p.numel() * p.element_size()  # noqa: E731
                           for p in m.parameters())
    assert 2 * nbytes(net) == nbytes(net32)
    err = np.abs(got - want).max()
    if compute_dtype == 'float32':
        assert err < 1e-4, err
    else:
        assert err <= BF16_RTOL * np.abs(want).max(), err


def test_param_dtype_bfloat16_casts_the_learned_schedule(tmp_path):
    """The learned log-SNR net's parameters are bf16 too, and its table
    equals the float32 schedule rounded through bf16."""
    from srgd_tpu_torch.factory import get_model
    confs = [_confs(tmp_path, noise_schedule='learned',
                    learned_schedule_net_hidden_dim=16,
                    param_dtype=dt)[1] for dt in ('float32', 'bfloat16')]
    (w32, _), (w16, _) = (get_model(c, '', device='cpu') for c in confs)
    assert all(p.dtype == torch.bfloat16 for p in w16.log_snr.parameters())
    with torch.no_grad():
        for a, b in zip(w32.log_snr.parameters(), w16.log_snr.parameters()):
            a.copy_(a.to(torch.bfloat16).float())
    np.testing.assert_allclose(w16.log_snr.table(4), w32.log_snr.table(4),
                               atol=1e-5)


@pytest.mark.parametrize('strict', [True, False])
def test_load_strict_raises_where_jax_raises(tmp_path, jax_params, strict):
    """A .pth with one extra wrapper entry and one extra U-Net key: with
    load_strict both packages raise on the U-Net key and neither on the
    wrapper entry; without it both load and give the same forward."""
    from srgd_tpu.factory import get_model as jax_get_model
    from srgd_tpu_torch.factory import get_model
    _, params = jax_params
    sd = export_torch_state_dict({'params': params},
                                 model='conditional_continuous')
    wrapper_only = tmp_path / 'wrapper.pth'
    _save(wrapper_only, dict(sd, step=np.zeros(1, np.float32)))
    both = tmp_path / 'both.pth'
    _save(both, dict(sd, step=np.zeros(1, np.float32),
                     **{'model.stray.weight': np.ones(3, np.float32)}))
    jconf, tconf = _confs(tmp_path, load_strict=str(strict).lower())
    assert jconf.load_strict is strict and tconf.load_strict is strict
    want, got, _ = _forward_both(jconf, tconf, wrapper_only)
    assert np.abs(got - want).max() < 1e-4
    if strict:
        with pytest.raises(KeyError, match='stray'):
            jax_get_model(jconf, str(both))
        with pytest.raises(KeyError, match='stray'):
            get_model(tconf, str(both), device='cpu')
    else:
        want, got, _ = _forward_both(jconf, tconf, both)
        assert np.abs(got - want).max() < 1e-4
