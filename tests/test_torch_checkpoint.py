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

    _save(tmp_path / 'extra.pth', dict(exported, stray=np.zeros(1, np.float32)))
    with pytest.raises(KeyError, match='stray'):
        load_reference_checkpoint(tmp_path / 'extra.pth')
