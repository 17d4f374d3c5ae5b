"""Training over the port's device mesh against one device and against
``srgd_tpu.train.loop.train``.

Mirrors tests/test_parallel.py's
``test_dp_tp_train_step_runs_and_matches_single_device`` (loss rtol 1e-4,
parameters atol 1e-5 after one step) at (2, 1) and (2, 2) on spawned gloo
ranks (see tests/test_torch_parallel.py for the harness), plus one (2, 1)
step against the JAX loop at the bar of tests/test_torch_train_jax_loop.py,
and the checkpoint both ways: written under (2, 2), read by
``factory.get_model`` and resumed at world 1; written at world 1 and
resumed, re-sharded, under (2, 2). The runs go through the loop's per-rank
body on tests/test_torch_train_loop.py's constant batch of 2 (so one row a
data rank) with a dim-8 net.
"""

import shutil
import tempfile

import numpy as np
import pytest
import torch

from tests import test_torch_mesh_ranks as ranks
from tests.test_torch_train_loop import (  # noqa: F401 (a fixture)
    RUN, _conf, _const_data, _train, image_dir)

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

LR = 1e-3
JAX_RUN = dict(RUN, lr=LR, min_lr=1e-5)   # tests/test_torch_train_jax_loop


def _ckpt(out_dir):
    return out_dir / (_conf(**RUN).prefix or 'ckpt')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """World 1 (here) for 1 and 2 steps, and 1 step on the JAX loop's
    recorded draws. (2, 2): 1 step; 2 steps; a resume of its own 1-step
    checkpoint to step 2; a resume of the world-1 1-step checkpoint to step
    2. (2, 1): 1 step, and 1 step on the recorded draws."""
    from srgd_tpu_torch.train import trainer
    from tests.test_torch_train import JaxDraws
    tmp = tmp_path_factory.mktemp('mesh_train')
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _const_data(mp)
        for steps in (1, 2):
            out[f'one{steps}'] = _train(_conf(**RUN), 'unused',
                                        tmp / f'one{steps}', total_steps=steps,
                                        log_every=1, save_every=1)
        import jax
        recorders = {}

        def recorded(seed, step, device):
            recorders[step] = ranks.DrawRecorder(JaxDraws(
                jax.random.fold_in(jax.random.PRNGKey(seed), step),
                'continuous'))
            return recorders[step]
        mp.setattr(trainer, 'step_draws', recorded)
        out['one_jax'] = _train(_conf(**JAX_RUN), 'unused', tmp / 'one_jax',
                                total_steps=1, log_every=1, save_every=1)
    draws = {s: r.made for s, r in recorders.items()}

    def run(name, steps, conf=RUN, draws=None, copy_from=None):
        return (conf, str(tmp / name), steps, draws,
                copy_from and str(tmp / copy_from))
    (out['22'], out['22_2'], out['22_resume'],
     out['one1_resume22']) = ranks.run_world(
        ranks.train_rank, (2, 2), ([run('mesh22', 1), run('mesh22_2', 2),
                                    run('mesh22_resume', 2,
                                        copy_from='mesh22'),
                                    run('one1_resume22', 2,
                                        copy_from='one1')],), tmp)
    out['21'], out['21_jax'] = ranks.run_world(
        ranks.train_rank, (2, 1), ([run('mesh21', 1),
                                    run('mesh21_jax', 1, JAX_RUN, draws)],),
        tmp)
    out['tmp'] = tmp
    return out


def _close(mesh_run, state, atol=1e-5):
    """The mesh run's parameters and EMA equal ``state``'s within atol."""
    for field, want in (('params', state.params), ('ema', state.ema_params)):
        got = mesh_run[field]
        assert sorted(got) == sorted(want)
        gap = max(float((got[k].detach() - want[k].detach()).abs().max())
                  for k in want)
        assert gap <= atol, (field, gap)


# after a second step at lr = 1e-4 the one-device and mesh runs are held
# within 2 lr: Adam's m / sqrt(v) turns the rounding differences of a split
# batch in near-zero gradients into steps of about lr
# (tests/test_torch_train_jax_loop.py); the first step's warmup lr is 1e-6
ADAM_ATOL = 2 * _conf(**RUN).lr


@pytest.mark.parametrize('shape', ['21', '22'])
def test_dp_tp_train_step_runs_and_matches_single_device(runs, shape):
    """One step: the global loss at rtol 1e-4 and every parameter and EMA
    entry at atol 1e-5 of one device's. At (2, 2) the parameters JAX's rule
    shards keep their master, EMA and Adam moments as dim-0 halves."""
    from srgd_tpu_torch.parallel.mesh import sharded_names
    got, want = runs[shape], runs['one1']
    assert got['step'] == 1
    np.testing.assert_allclose(got['losses'], want.losses, rtol=1e-4)
    _close(got, want)
    names = sharded_names(want.params, 2 if shape == '22' else 1)
    assert sorted(got['shards']) == sorted(names)
    for k in names:
        full = tuple(want.params[k].shape)
        assert got['shards'][k] == (full[0] // 2, *full[1:])
    if shape == '22':
        assert len(names) > 10
    # the optimizer state comes back whole, in one device's layout
    for idx, st in got['opt']['state'].items():
        ref = want.optimizer.state_dict()['state'][idx]
        for key in ('mu', 'nu'):
            assert st[key].shape == ref[key].shape
            assert float((st[key] - ref[key]).abs().max()) <= 1e-5 * max(
                1.0, float(ref[key].abs().max()))


def test_mesh_train_step_matches_the_jax_loop(runs, monkeypatch, tmp_path):
    """One (2, 1) step on the JAX loop's draws (recorded from its keys at the
    global batch, cut to each rank's row) against one step of
    ``srgd_tpu.train.loop.train`` from the same weights: the bars of
    tests/test_torch_train_jax_loop.py (parameters and EMA within 2 lr
    steps, Adam's moments within 1e-4 / 1e-3 of their largest entry), and
    the one-device port on the same draws at atol 1e-5."""
    from srgd_tpu.config import Config as JaxConfig
    from srgd_tpu.nn.unet import SRUnet as JaxUnet
    from srgd_tpu.train.loop import train as jax_train
    from srgd_tpu_torch.checkpoint import state_dict_from_jax
    from srgd_tpu_torch.nn.unet import build_unet_from_config
    from tests.test_torch_train import _adam_moment, port_weights_into_jax
    conf = _conf(**JAX_RUN)
    _const_data(monkeypatch)
    net = build_unet_from_config(conf)
    net.init_weights(torch.Generator().manual_seed(conf.seed))
    params = port_weights_into_jax(net)
    monkeypatch.setattr(JaxUnet, 'init', lambda self, *a, **k: params)
    jstate = jax_train(JaxConfig(**JAX_RUN), 'unused', str(tmp_path / 'jax'),
                       total_steps=1, log_every=10, save_every=100)
    got = runs['21_jax']
    _close(got, runs['one_jax'])
    np.testing.assert_allclose(got['losses'], runs['one_jax'].losses,
                               rtol=1e-4)
    for field, want, atol in (('params', jstate.params, 2 * LR),
                              ('ema', jstate.ema_params, 2 * LR * 0.1)):
        want = state_dict_from_jax(want)
        gap = max(float((got[field][k] - want[k]).abs().max()) for k in want)
        assert gap <= atol, (field, gap)
    names = list(runs['one_jax'].params)
    for key, rtol in (('mu', 1e-4), ('nu', 1e-3)):
        want = state_dict_from_jax(_adam_moment(jstate.opt_state, key))
        scale = max(float(w.abs().max()) for w in want.values())
        gap = max(float((st[key] - want[names[i]]).abs().max())
                  for i, st in got['opt']['state'].items()) / scale
        assert gap <= rtol, (key, gap)


def test_mesh_checkpoint_loads_and_resumes_at_one_device(runs, monkeypatch):
    """The (2, 2) run's checkpoint is the single file one device writes,
    with whole tensors equal to the mesh's state: ``factory.get_model``
    loads its EMA weights, and a one-device run resumes it to step 2 (its
    loss at rtol 1e-4 of the mesh's own second step, its parameters within
    2 lr of it)."""
    from srgd_tpu_torch.checkpoint import restore_params
    from srgd_tpu_torch.factory import get_model
    tmp = runs['tmp']
    conf = _conf(**RUN)
    saved = restore_params(str(_ckpt(tmp / 'mesh22')))
    mesh = runs['22']
    assert saved['step'] == 1
    for field, key in (('params', 'params'), ('ema_params', 'ema')):
        for k, v in mesh[key].items():
            torch.testing.assert_close(saved[field][k], v, atol=0, rtol=0)
    _, net = get_model(conf, str(_ckpt(tmp / 'mesh22')), device='cpu')
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, mesh['ema'][k], atol=0, rtol=0)
    shutil.copytree(tmp / 'mesh22', tmp / 'mesh22_one')
    _const_data(monkeypatch)
    state = _train(conf, 'unused', tmp / 'mesh22_one', total_steps=2,
                   log_every=1, save_every=1)
    assert state.step == 2
    np.testing.assert_allclose(state.losses, runs['22_2']['losses'][1:],
                               rtol=1e-4)
    _close({'params': state.params, 'ema': state.ema_params}, runs['one2'],
           atol=ADAM_ATOL)


def test_mesh_resume_reshards_its_checkpoint(runs):
    """A resume under (2, 2) re-shards the whole-tensor checkpoint: resumed
    from its own step-1 checkpoint it reproduces the uninterrupted (2, 2)
    run bit for bit (parameters, EMA, Adam state); resumed from the
    one-device step-1 checkpoint it stays within 2 lr of the one-device
    run."""
    got, want = runs['22_resume'], runs['22_2']
    assert got['step'] == want['step'] == 2
    assert got['losses'] == want['losses'][1:]
    for field in ('params', 'ema'):
        for k, v in want[field].items():
            torch.testing.assert_close(got[field][k], v, atol=0, rtol=0)
    for idx, st in want['opt']['state'].items():
        for key, v in st.items():
            w = got['opt']['state'][idx][key]
            assert torch.equal(w, v) if torch.is_tensor(v) else w == v
    other, one = runs['one1_resume22'], runs['one2']
    assert other['step'] == 2
    np.testing.assert_allclose(other['losses'], one.losses[1:], rtol=1e-4)
    _close(other, one, atol=ADAM_ATOL)


def test_loop_train_at_41_matches_single_device(tmp_path, image_dir,
                                                monkeypatch):
    """``train.loop.train(mesh_shape=(4, 1))``, which spawns its four gloo
    ranks itself, on the real data pipeline at a global batch of 4 (one row
    a data rank), against one device on the same images: the step's loss
    at rtol 1e-4, the parameters and EMA at atol 1e-5, and Adam's first
    moment, one tenth of the step's gradient, from the mesh run's
    checkpoint at the (2, 1) test's 1e-5 bar (a gradient that missed the
    all-reduce, or came from one rank's row, is off by about its own
    size). The mesh run returns one device's ``TrainState`` type: whole
    tensors, and no optimizer."""
    from srgd_tpu_torch.checkpoint import restore_params
    from srgd_tpu_torch.parallel import mesh as pmesh
    from srgd_tpu_torch.train.trainer import TrainState
    real = pmesh.launch

    def launch(fn, shape, device_type, args=(), **kw):
        return real(fn, shape, device_type, args, timeout_s=60,
                    join_s=ranks.JOIN_S, threads=1, **kw)
    monkeypatch.setattr(pmesh, 'launch', launch)
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    conf = dict(RUN, batch_size=4)
    want = _train(_conf(**conf), image_dir, tmp_path / 'one', total_steps=1,
                  log_every=1, save_every=1)
    got = _train(_conf(**conf), image_dir, tmp_path / 'mesh', total_steps=1,
                 log_every=1, save_every=1, mesh_shape=(4, 1))
    assert type(got) is TrainState and got.optimizer is None
    assert got.step == 1 and got.timer.counts['step'] == 1
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    _close({'params': got.params, 'ema': got.ema_params}, want)
    for k, v in got.params.items():
        assert v.device.type == 'cpu' and v.shape == want.params[k].shape
    saved = restore_params(str(_ckpt(tmp_path / 'mesh')))['opt_state']
    ref = want.optimizer.state_dict()['state']
    assert sorted(saved['state']) == sorted(ref)
    for idx, st in saved['state'].items():
        mu = ref[idx]['mu']
        assert float(mu.abs().max()) > 0
        assert float((st['mu'] - mu).abs().max()) <= 1e-5 * max(
            1.0, float(mu.abs().max()))
