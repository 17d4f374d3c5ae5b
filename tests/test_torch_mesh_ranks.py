"""Rank bodies for the spawned gloo worlds of tests/test_torch_parallel.py.

No tests here. A spawned rank imports this module by name, so it imports
neither ``jax`` nor ``srgd_tpu``: noise that the JAX key schedule drew
reaches the ranks as arrays (``RecordedNoise``). Every body takes the
rank's ``parallel.mesh.Mesh`` first and returns what rank 0 hands back to
the test (``parallel.mesh.launch`` pickles it home).
"""

import tempfile
import time

import numpy as np
import torch
from torch import nn

from srgd_tpu_torch.config import Config
from srgd_tpu_torch.diffusion.base import GeneratorNoise
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.factory import build_wrapper
from srgd_tpu_torch.nn.unet import build_unet_from_config

JOIN_S = 120   # seconds a spawned world may take before it is killed


def run_world(fn, shape, args, tmp, timeout_s=60):
    """``fn`` on a spawned gloo world of ``shape`` (or in this process at
    world 1): its ``file://`` store and temporary files under ``tmp``, a
    ``timeout_s`` process-group timeout, ``JOIN_S`` to finish, one thread a
    rank. A failure says how long the world ran and under which limits."""
    from srgd_tpu_torch.parallel.mesh import launch
    saved = tempfile.tempdir
    tempfile.tempdir = str(tmp)
    t0 = time.monotonic()
    try:
        return launch(fn, shape, 'cpu', args, timeout_s=timeout_s,
                      join_s=JOIN_S, threads=1)
    except Exception as e:
        raise RuntimeError(
            f'{fn.__name__} on a {shape} world failed after '
            f'{time.monotonic() - t0:.1f} s (join deadline {JOIN_S} s, '
            f'process-group timeout {timeout_s} s)') from e
    finally:
        tempfile.tempdir = saved


NET = dict(unet_dim=8, ddpm_unet_dim_mults='1,2', full_attn='False,True',
           learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
           num_classes=3)
NET3 = dict(NET, ddpm_unet_dim_mults='1,2,4', full_attn='False,False,True')

# name -> (config keywords, tiled_sample keywords); real tiny nets, a
# 64 px canvas (tile 32: 9 aligned and 4 shifted tiles), tile batch 2
REAL = dict(tile_size=32, batch_size=2)
CASES = {
    'fake': (None, dict(tile_size=32, batch_size=8)),
    'fake_overlap': (None, dict(tile_size=32, tile_stride=16, batch_size=8)),
    'continuous': (dict(NET, model='conditional_continuous',
                        num_sample_steps=2), dict(REAL, class_cond_scale=2.0)),
    'dpmpp': (dict(NET, model='conditional_continuous', num_sample_steps=3,
                   continuous_sampler='dpmpp'), REAL),
    'gaussian': (dict(NET, model='conditional_gaussian',
                      learned_sinusoidal_cond=False, timesteps=20,
                      sampling_timesteps=2, beta_schedule='sigmoid'),
                 REAL),
    'elucidated': (dict(NET, model='conditional_elucidated',
                        num_sample_steps=2), REAL),
    'deep_cache': (dict(NET3, model='conditional_continuous',
                        num_sample_steps=4, deep_cache_interval=2,
                        deep_cache_depth=2), REAL),
}


class FakeNet(nn.Module):
    """tests/test_continuous.FakeNet in NCHW: cheap and
    conditioning-sensitive."""

    def forward(self, x, time, cond=None, class_label=None, class_mask=None):
        out = 0.3 * x + 0.01 * time[:, None, None, None]
        if cond is not None:
            out = out + 0.5 * cond
        if class_label is not None:
            lab = (1.0 + class_label.float())[:, None, None, None]
            if class_mask is not None:
                lab = lab * class_mask[:, None, None, None]
            out = out + 0.2 * lab
        return out


def build_case(name: str):
    """(wrapper, cond (1, H, W, 3), label, tiled_sample keywords) of a
    case, seeded: the same on every rank and in the test process."""
    conf_kw, kw = CASES[name]
    rng = np.random.default_rng(6)
    if conf_kw is None:
        cond = rng.uniform(size=(1, 120, 120, 3)).astype(np.float32)
        wrapper = ContinuousDiffusion(FakeNet(), image_size=32,
                                      num_sample_steps=4)
        return wrapper, torch.from_numpy(cond), None, kw
    conf = Config(**conf_kw)
    net = build_unet_from_config(conf).eval()
    net.init_weights(torch.Generator().manual_seed(3))
    cond = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    return (build_wrapper(conf, net), torch.from_numpy(cond),
            torch.tensor([1]), kw)


def sample_case(name: str, mesh=None, noise=None) -> np.ndarray:
    wrapper, cond, label, kw = build_case(name)
    out = wrapper.tiled_sample(
        cond, label, noise=noise or GeneratorNoise(7, 'cpu'), mesh=mesh, **kw)
    return out.numpy()


def sample_rank(mesh, names):
    """Every case in ``names`` under the mesh, and the mesh's own facts."""
    from srgd_tpu_torch.parallel import mesh as mesh_mod
    facts = dict(shape=mesh.shape, data=mesh.data_rank,
                 model=mesh.model_rank, default=mesh_mod.make_mesh(
                     None, 'cpu').shape,
                 from_config=mesh_mod.mesh_from_config(
                     Config(mesh_shape=f'{mesh.shape[0]},1'), 'cpu').shape)
    try:
        mesh_mod.make_mesh((3, 2), 'cpu')
    except AssertionError as e:
        facts['error'] = str(e)
    return {'facts': facts, **{n: sample_case(n, mesh) for n in names}}


def capture_case(name: str, mesh=None) -> tuple:
    """A case's output and both capture stacks, as numpy."""
    wrapper, cond, label, kw = build_case(name)
    out = wrapper.tiled_sample(cond, label, noise=GeneratorNoise(7, 'cpu'),
                               mesh=mesh, capture_trajectory=True,
                               capture_x0=True, **kw)
    return tuple(t.numpy() for t in out)


def capture_rank(mesh, names):
    """``capture_case`` of every case in ``names`` under the mesh."""
    return {n: capture_case(n, mesh) for n in names}


def flags_rank(mesh):
    """This rank's float32 precision settings and process-group timeout."""
    from srgd_tpu_torch.parallel.mesh import float32_flags
    return float32_flags(), mesh.timeout_s


class RecordedNoise:
    """A noise source that replays recorded draws: ``draws`` maps
    ('init',), ('step', i) and ('margin', i) to arrays."""

    def __init__(self, draws: dict):
        self.draws = draws

    def init(self, shape):
        return torch.from_numpy(self.draws[('init',)])

    def step(self, i, shape):
        return torch.from_numpy(self.draws[('step', i)])

    def margin(self, i, shape):
        return torch.from_numpy(self.draws[('margin', i)])


class Recorder:
    """Wraps a noise source and records what it draws, for
    ``RecordedNoise``."""

    def __init__(self, noise):
        self.noise, self.draws = noise, {}

    def _keep(self, key, t):
        self.draws[key] = t.numpy().copy()
        return t

    def init(self, shape):
        return self._keep(('init',), self.noise.init(shape))

    def step(self, i, shape):
        return self._keep(('step', i), self.noise.step(i, shape))

    def margin(self, i, shape):
        return self._keep(('margin', i), self.noise.margin(i, shape))


def jax_weights_rank(mesh, state_dict, net_kw, cond, label, noise, kw):
    """The continuous tiled sampler on a net holding ``state_dict`` (numpy
    arrays). ``noise``: a noise source, or a ``Recorder``'s draws to
    replay."""
    from srgd_tpu_torch.nn.unet import SRUnet
    net = SRUnet(**net_kw).eval()
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in state_dict.items()}, strict=True)
    wrapper = ContinuousDiffusion(net, image_size=32)
    out = wrapper.tiled_sample(torch.from_numpy(cond), torch.from_numpy(label),
                               noise=(RecordedNoise(noise)
                                      if isinstance(noise, dict) else noise),
                               mesh=mesh, **kw)
    return out.numpy()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def const_batch():
    """tests/test_torch_train_loop._const_data's batch."""
    rng = np.random.default_rng(0)
    hr = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    return hr, cond, np.zeros((2,), np.int64)


class ConstData:
    """An endless constant batch in place of the training set."""

    def __init__(self, *a, **kw):
        pass

    def __iter__(self):
        batch = const_batch()
        while True:
            yield batch


class DrawRecorder:
    """Wraps a draw source and records each draw by (kind, name, shape)."""

    def __init__(self, draws):
        self.draws, self.made = draws, {}

    def _keep(self, kind, name, shape, t):
        self.made[(kind, name, tuple(shape))] = t.numpy().copy()
        return t

    def uniform(self, name, shape):
        return self._keep('uniform', name, shape,
                          self.draws.uniform(name, shape))

    def normal(self, name, shape):
        return self._keep('normal', name, shape,
                          self.draws.normal(name, shape))

    def randint(self, name, shape, high):
        return self._keep('randint', name, shape,
                          self.draws.randint(name, shape, high))


class RecordedDraws:
    """Replays a ``DrawRecorder``'s draws."""

    def __init__(self, made: dict):
        self.made = made

    def uniform(self, name, shape):
        return torch.from_numpy(self.made[('uniform', name, tuple(shape))])

    def normal(self, name, shape):
        return torch.from_numpy(self.made[('normal', name, tuple(shape))])

    def randint(self, name, shape, high):
        return torch.from_numpy(self.made[('randint', name, tuple(shape))])


def train_rank(mesh, runs):
    """Training runs under the mesh, one after the other: each of ``runs``
    is (config keywords, out_dir, steps, recorded draws by step or None,
    a run directory to copy into out_dir first or None), on ``ConstData``.
    Returns, per run, the losses, the whole parameters, EMA and optimizer
    state, and which parameters are shards."""
    import shutil
    from torch.distributed.tensor import DTensor
    from srgd_tpu_torch.parallel.mesh import barrier
    from srgd_tpu_torch.train import data, trainer
    from srgd_tpu_torch.train.loop import train_on
    from srgd_tpu_torch.train.sharded import full_state
    data.DegradationDataset = ConstData
    make_draws = trainer.step_draws
    out = []
    for conf_kw, out_dir, steps, draws, copy_from in runs:
        if copy_from and mesh.is_writer:
            shutil.copytree(copy_from, out_dir)
        barrier(mesh)
        trainer.step_draws = make_draws if draws is None else (
            lambda seed, step, device: RecordedDraws(draws[step]))
        state = train_on(mesh, Config(**conf_kw), 'unused', out_dir,
                              steps, 1, 1, True, None, mesh.device)
        out.append(dict(
            step=state.step, losses=[float(x) for x in state.losses],
            params=full_state(state.params),
            ema=full_state(state.ema_params),
            opt=full_state(state.optimizer.state_dict()),
            shards={k: tuple(v.to_local().shape)
                    for k, v in state.params.items()
                    if isinstance(v, DTensor)}))
    return out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def serve_rank(mesh, argv, requests, idle_s=0.0, fail_first=False):
    """The daemon's ``Server`` on every rank: rank 0 idles ``idle_s``
    seconds, answers ``requests`` ((seed, label, h, w) each) through
    ``super_resolve`` and then sends the stop message; the others follow
    until it. ``fail_first``: rank 0's net raises in its first forward.
    Returns, per request, the PNG bytes or the name of the error it raised,
    and the mesh shape that /healthz and /stats report. ``mesh`` None: the
    daemon without a mesh."""
    import io
    import time
    from PIL import Image
    from srgd_tpu_torch.serve import Server, parse_args
    server = Server(parse_args(argv), mesh=mesh)
    if mesh is not None and not mesh.is_writer:
        server.follow()
        return None
    if fail_first:
        net, forward = server.sampler.wrapper.net, None

        def fail_once(*a, **kw):
            net.forward = forward
            raise RuntimeError('injected fault')
        forward, net.forward = net.forward, fail_once
    try:
        time.sleep(idle_s)
        pngs = []
        for seed, label, h, w in requests:
            img = Image.fromarray((np.random.RandomState(seed).rand(h, w, 3)
                                   * 255).astype(np.uint8))
            buf = io.BytesIO()
            try:
                server.super_resolve(img, seed=seed, test_label=label).save(
                    buf, format='PNG')
            except Exception as e:
                pngs.append(type(e).__name__)
                continue
            pngs.append(buf.getvalue())
        return pngs, server.model_info['mesh'], server.stats_snapshot()['mesh']
    finally:
        server.close()
