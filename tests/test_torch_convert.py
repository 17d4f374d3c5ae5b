"""``python -m srgd_tpu_torch.checkpoint.convert`` against
``srgd_tpu.checkpoint.convert`` and ``export_torch_state_dict``.

Forward, a reference ``.pth`` becomes the port's checkpoint directory with
the weights JAX's converter gives (carried across by
``state_dict_from_jax``) and that loading the ``.pth`` gives; reverse, a
port directory (a trainer state, or a forward-converted one) becomes the
``.pth`` that ``export_torch_state_dict`` writes for the same weights, key
for key and bit for bit, which ``srgd_tpu`` reads strictly. Dim-8 nets on
the CPU."""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from srgd_tpu.checkpoint.convert import main as jax_convert_main
from srgd_tpu.checkpoint.io import restore_params as jax_restore_params
from srgd_tpu.checkpoint.io import save_params as jax_save_params
from srgd_tpu.checkpoint.torch_convert import (
    _LEARNED_LOG_SNR_KEYS, convert_checkpoint, convert_learned_log_snr,
    convert_unet_state_dict, export_torch_state_dict, strip_wrapper_prefix)
from srgd_tpu_torch.checkpoint import (load_trained_checkpoint, restore_params,
                                       save_params, state_dict_from_jax)
from srgd_tpu_torch.checkpoint.convert import main as convert_main
from srgd_tpu_torch.config import load_config
from srgd_tpu_torch.factory import get_model
from tests.test_torch_train_loop import RUN, _const_data, _train
from tests.test_torch_unet import _forward
from tests.torch_ref import make_state_dict

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

NET = dict(unet_dim=8, ddpm_unet_dim_mults='1,2', full_attn='False,True',
           learned_sinusoidal_dim=4, num_classes=3)
FAMILIES = {
    'continuous_learned': dict(NET, model='conditional_continuous',
                               noise_schedule='learned',
                               learned_schedule_net_hidden_dim=8),
    'gaussian': dict(NET, model='conditional_gaussian',
                     learned_sinusoidal_cond=False, timesteps=20,
                     sampling_timesteps=2, beta_schedule='sigmoid'),
    'elucidated': dict(NET, model='conditional_elucidated'),
}


def _yaml(tmp_path, name, fields):
    path = tmp_path / f'{name}.yaml'
    path.write_text(yaml.safe_dump(fields))
    return str(path)


def _reference_sd(fields, seed=7):
    """A reference-format ``ema_model`` of ``fields``' net: U-Net entries
    under the family's prefix, a learned schedule's under its torch
    keys."""
    prefix = 'net.' if 'elucidated' in fields['model'] else 'model.'
    sd = make_state_dict(dim=8, dim_mults=(1, 2), full_attn=(False, True),
                         num_classes=3, learned_sinusoidal_dim=4,
                         learned_sinusoidal=fields.get(
                             'learned_sinusoidal_cond', True), seed=seed)
    out = {prefix + k: v for k, v in sd.items()}
    if fields.get('noise_schedule') == 'learned':
        g = torch.Generator().manual_seed(seed + 1)
        hidden = fields['learned_schedule_net_hidden_dim']
        shapes = {'log_snr.net.1.net': (1, 1), 'log_snr.net.2.fn.0.net':
                  (hidden, 1), 'log_snr.net.2.fn.2.net': (1, hidden)}
        for key, (o, i) in shapes.items():
            out[f'{key}.weight'] = torch.rand(o, i, generator=g) + 0.1
            out[f'{key}.bias'] = torch.randn(o, generator=g) * 0.1
    return out


def _write_pth(path, sd):
    """``sd`` as a reference ``.pth``, with two schedule buffers that
    every loader drops."""
    sd = dict(sd, betas=torch.linspace(0, 1, 20),
              alphas_cumprod=torch.linspace(1, 0, 20))
    torch.save({'ema_model': sd}, path)
    return str(path)


def _jax_tree(sd):
    """The JAX variables of a reference ``ema_model`` (JAX's converter)."""
    unet_sd, extras = strip_wrapper_prefix({k: v.numpy()
                                            for k, v in sd.items()})
    params, unmatched = convert_unet_state_dict(unet_sd, num_stages=2)
    assert not unmatched
    tree = {'params': params}
    log_snr = convert_learned_log_snr(extras)
    if log_snr is not None:
        tree['log_snr'] = log_snr
    return tree


def _same(got: dict, want: dict):
    """Key for key and bit for bit, dtypes included."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize('family', ['continuous_learned', 'elucidated'])
def test_forward_equals_the_jax_converter_and_the_direct_load(tmp_path,
                                                              family):
    """The port's directory holds what JAX's converter writes for the same
    ``.pth`` (``state_dict_from_jax`` of its orbax tree), bit for bit, in
    the layout ``load_trained_checkpoint`` reads, and
    ``factory.get_model`` loads from it the weights it loads from the
    ``.pth``."""
    fields = FAMILIES[family]
    conf = _yaml(tmp_path, family, fields)
    pth = _write_pth(tmp_path / 'ref.pth', _reference_sd(fields))
    convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'port')])
    jax_convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'jax')])
    got = load_trained_checkpoint(str(tmp_path / 'port'))
    assert set(restore_params(str(tmp_path / 'port'))) == {'ema_params'}
    _same(got, state_dict_from_jax(jax_restore_params(str(tmp_path / 'jax'))))
    w_pth, n_pth = get_model(load_config(conf), pth, device='cpu')
    w_dir, n_dir = get_model(load_config(conf), str(tmp_path / 'port'),
                             device='cpu')
    _same(n_dir.state_dict(), n_pth.state_dict())
    if family == 'continuous_learned':
        _same(w_dir.log_snr.state_dict(), w_pth.log_snr.state_dict())


def test_forward_under_load_strict_false_leaves_unknown_keys_out(tmp_path):
    """A U-Net key the net lacks raises under ``load_strict`` and is left
    out of the directory without it, as JAX's converter leaves it
    unmatched."""
    fields = dict(NET, model='conditional_continuous')
    sd = dict(_reference_sd(fields), **{'model.extra.weight': torch.ones(2)})
    pth = _write_pth(tmp_path / 'ref.pth', sd)
    with pytest.raises(KeyError, match='extra.weight'):
        convert_main(['-c', _yaml(tmp_path, 'strict', fields), '-m', pth,
                      '-o', str(tmp_path / 'strict')])
    conf = _yaml(tmp_path, 'loose', dict(fields, load_strict=False))
    convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'port')])
    jax_convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'jax')])
    got = load_trained_checkpoint(str(tmp_path / 'port'))
    assert 'extra.weight' not in got
    _same(got, state_dict_from_jax(jax_restore_params(str(tmp_path / 'jax'))))


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_reverse_equals_export_torch_state_dict(tmp_path, family):
    """``--reverse`` of a port directory holding JAX's weights is the dict
    ``export_torch_state_dict`` gives for them: the same keys (``net.`` for
    the elucidated family, the learned schedule's torch keys), float32, the
    same bits."""
    fields = FAMILIES[family]
    tree = _jax_tree(_reference_sd(fields))
    save_params(str(tmp_path / 'dir'),
                {'ema_params': state_dict_from_jax(tree), 'step': 2})
    out = str(tmp_path / 'out.pth')
    convert_main(['-c', _yaml(tmp_path, family, fields), '--reverse', '-m',
                  str(tmp_path / 'dir'), '-o', out])
    want = export_torch_state_dict(tree, model=fields['model'])
    got = torch.load(out, map_location='cpu', weights_only=True)
    assert list(got) == ['ema_model']
    _same(got['ema_model'], {k: torch.from_numpy(v) for k, v in want.items()})
    learned = {k for k in want if k.startswith('log_snr.')}
    assert learned == (set(_LEARNED_LOG_SNR_KEYS)
                       if family == 'continuous_learned' else set())


@pytest.mark.parametrize('family', ['continuous_learned', 'elucidated'])
def test_pth_to_directory_to_pth_returns_the_same_bits(tmp_path, family):
    """``.pth`` -> directory -> ``--reverse`` -> ``.pth``: the original's
    entries, schedule buffers aside, bit for bit."""
    fields = FAMILIES[family]
    conf = _yaml(tmp_path, family, fields)
    sd = _reference_sd(fields)
    pth = _write_pth(tmp_path / 'ref.pth', sd)
    convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'dir')])
    out = str(tmp_path / 'back.pth')
    convert_main(['-c', conf, '--reverse', '-m', str(tmp_path / 'dir'),
                  '-o', out])
    _same(torch.load(out, map_location='cpu', weights_only=True)['ema_model'],
          sd)


def test_param_dtype_bfloat16_stores_bf16_and_exports_float32(tmp_path):
    """``--param_dtype bfloat16`` stores every entry in bfloat16 (JAX's
    converter's cast, bit for bit); ``--reverse`` of that directory writes
    those values in float32."""
    fields = FAMILIES['continuous_learned']
    conf = _yaml(tmp_path, 'conf', fields)
    pth = _write_pth(tmp_path / 'ref.pth', _reference_sd(fields))
    convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'port'),
                  '--param_dtype', 'bfloat16'])
    jax_convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'jax'),
                      '--param_dtype', 'bfloat16'])
    got = load_trained_checkpoint(str(tmp_path / 'port'))
    jax_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            jax_restore_params(str(tmp_path / 'jax')))
    _same(got, {k: v.to(torch.bfloat16)
                for k, v in state_dict_from_jax(jax_tree).items()})
    out = str(tmp_path / 'out.pth')
    convert_main(['-c', conf, '--reverse', '-m', str(tmp_path / 'port'),
                  '-o', out])
    back = torch.load(out, map_location='cpu', weights_only=True)['ema_model']
    assert {v.dtype for v in back.values()} == {torch.float32}
    _same({k.removeprefix('model.'): v for k, v in back.items()},
          {k: v.float() for k, v in got.items()})


def test_forward_reads_a_jax_trainer_state_exported_by_jax(tmp_path):
    """A JAX trainer state (orbax: params, ema_params, step, best_score)
    exported by JAX's ``--reverse`` feeds the port's forward conversion,
    which gives the state's EMA weights."""
    fields = FAMILIES['continuous_learned']
    conf = _yaml(tmp_path, 'conf', fields)
    ema = _jax_tree(_reference_sd(fields, seed=3))
    live = _jax_tree(_reference_sd(fields, seed=4))
    jax_save_params(str(tmp_path / 'jax_state'),
                    {'params': live, 'ema_params': ema, 'step': 5,
                     'best_score': 0.0})
    pth = str(tmp_path / 'exported.pth')
    jax_convert_main(['-c', conf, '--reverse', '-m',
                      str(tmp_path / 'jax_state'), '-o', pth])
    convert_main(['-c', conf, '-m', pth, '-o', str(tmp_path / 'port')])
    _same(load_trained_checkpoint(str(tmp_path / 'port')),
          state_dict_from_jax(ema))


def test_reverse_of_a_trained_directory_runs_in_jax(tmp_path, monkeypatch):
    """Two steps of ``srgd_tpu_torch.train.loop``; its directory exported
    with ``--reverse`` loads through ``convert_checkpoint(strict=True)``
    with nothing unmatched and no extras, and the JAX U-Net on those
    weights gives the port's forward on the trained EMA weights within f32
    atol 1e-4."""
    from srgd_tpu.nn.unet import SRUnet as JaxUnet
    fields = dict(RUN, num_classes=3)
    conf = _yaml(tmp_path, 'run', fields)
    _const_data(monkeypatch)
    state = _train(load_config(conf), 'unused', tmp_path / 'run',
                   total_steps=2, log_every=1, save_every=2)
    assert state.step == 2
    trained = str(tmp_path / 'run' / load_config(conf).prefix)
    out = str(tmp_path / 'out.pth')
    convert_main(['-c', conf, '--reverse', '-m', trained, '-o', out])
    tree, unmatched, extras = convert_checkpoint(out, num_stages=2,
                                                 strict=True)
    assert unmatched == [] and extras == {} and set(tree) == {'params'}
    _, net = get_model(load_config(conf), trained, device='cpu')
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = rng.normal(size=(2,)).astype(np.float32)
    label = np.asarray([2, 0])
    jnet = JaxUnet(dim=8, dim_mults=(1, 2), full_attn=(False, True),
                   learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
                   num_classes=3)
    want = jnet.apply(tree, jnp.asarray(x), jnp.asarray(t),
                      cond=jnp.asarray(cond), class_label=jnp.asarray(label))
    got = _forward(net.float(), x, t, cond, label)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    ema = restore_params(trained)['ema_params']
    back = torch.load(out, map_location='cpu', weights_only=True)['ema_model']
    _same(back, {f'model.{k}': v for k, v in ema.items()})
