"""The port's ``train`` against ``srgd_tpu.train.loop.train``: the slice
as a whole.

4 steps of each package's training loop on the monkeypatched constant
dataset of tests/test_train.py, from the same initial weights, the port
replaying the JAX per-step keys (``fold_in(PRNGKey(seed), step)``). The
tolerances and the measured gaps are at ``test_train_matches_the_jax_loop``.
Tiny sizes: dim 8, mults 1,2, 16-px HR and 4-px LR crops, batch 2.
"""

import torch

from tests.test_torch_train import (_adam_moment, port_weights_into_jax,
                                    replay_jax_step_keys)
from tests.test_torch_train_loop import RUN, _conf, _const_data, _train

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once


def test_train_matches_the_jax_loop(tmp_path, monkeypatch):
    """4 steps of ``train`` in both packages from the same weights (the
    port's init, handed to the JAX net's ``init``) on the same constant
    batch, the port replaying the JAX step keys, cosine schedule with
    warmup, AdamW, EMA 0.9. Adam's m / sqrt(v) turns rounding differences
    in near-zero gradients into steps of about lr, so parameters are held
    within 2 lr steps and the EMA within 2 lr steps (1 - 0.9^steps); the
    first moments within 1e-4 and the second within 1e-3 of their largest
    entry."""
    from srgd_tpu.config import Config as JaxConfig
    from srgd_tpu.nn.unet import SRUnet as JaxUnet
    from srgd_tpu.train.loop import train as jax_train
    from srgd_tpu_torch.checkpoint import state_dict_from_jax
    from srgd_tpu_torch.nn.unet import build_unet_from_config

    steps, lr = 4, 1e-3
    kw = dict(RUN, lr=lr, min_lr=1e-5)
    conf, jconf = _conf(**kw), JaxConfig(**kw)
    _const_data(monkeypatch)
    net = build_unet_from_config(conf)
    net.init_weights(torch.Generator().manual_seed(conf.seed))
    params = port_weights_into_jax(net)
    monkeypatch.setattr(JaxUnet, 'init', lambda self, *a, **k: params)
    jstate = jax_train(jconf, 'unused', str(tmp_path / 'jax'),
                       total_steps=steps, log_every=10, save_every=100)
    replay_jax_step_keys(monkeypatch)
    state = _train(conf, 'unused', tmp_path / 'port', total_steps=steps,
                   log_every=10, save_every=100)
    assert state.step == int(jstate.step) == steps

    gaps = {}
    for name, got, want, atol in (
            ('params', state.params, jstate.params, 2 * lr * steps),
            ('ema', state.ema_params, jstate.ema_params,
             2 * lr * steps * (1 - 0.9 ** steps))):
        want = state_dict_from_jax(want)
        assert sorted(got) == sorted(want)
        gaps[name] = max(float((got[k].detach() - want[k]).abs().max())
                         for k in want)
        assert gaps[name] <= atol, (name, gaps[name], atol)
    index = {id(p): k for k, p in state.params.items()}
    for field, rtol in (('mu', 1e-4), ('nu', 1e-3)):
        want = state_dict_from_jax(_adam_moment(jstate.opt_state, field))
        scale = max(float(w.abs().max()) for w in want.values())
        got = {index[id(p)]: s[field]
               for p, s in state.optimizer.state.items()}
        gaps[field] = max(float((got[k] - want[k]).abs().max())
                          for k in want) / scale
        assert gaps[field] <= rtol, (field, gaps[field])
    print('gaps vs the JAX loop:', gaps)
