"""The samplers' debug captures (``capture_trajectory``, ``capture_x0``: the
reference's with_images / with_x0_images) in the port, against
tests/test_capture.py's contract and against the JAX samplers frame by
frame.

Contract, every family, tiled and untiled: frames are float32 [-1, 1]
canvases (tiled: cropped to the output region); frame 0 is the init canvas;
one frame per executed step, so 1 + steps - generation_start_steps frames;
the last image frame unnormalizes to the returned output; a run with the
captures off gives the same bits as one with them on. The x0 frames hold
the clamped x0 estimate (continuous, gaussian), DPM++'s combined estimate,
or, as in the reference, the elucidated Heun step's derivative d (d' on a
Heun step).

Parity: two-stage dim-16 nets through ``state_dict_from_jax`` (as
tests/test_torch_families.py), the JAX key schedule replayed
(``UntiledJaxKeyNoise``, ``JaxKeyNoise``). Every frame is held to the
samplers' bar of tests/test_e2e_parity.py:105-111 in float32, max error <
5e-4 and PSNR > 60 dB in pixel space: a [-1, 1] frame is halved, as
unnormalizing maps it to [0, 1], and a frame of larger magnitude m is
divided by 2 m (the init canvas of the Karras schedule is 80 times a normal
draw, and a Heun derivative near sigma_min is divided by 0.002)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu.diffusion.continuous import ContinuousDiffusion as JaxContinuous
from srgd_tpu.diffusion.elucidated import ElucidatedDiffusion as JaxElucidated
from srgd_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussian
from srgd_tpu_torch.diffusion.base import GeneratorNoise, crop_frames
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.diffusion.elucidated import ElucidatedDiffusion
from srgd_tpu_torch.diffusion.gaussian import GaussianDiffusion
from tests import test_torch_mesh_ranks as ranks
from tests.test_torch_families import UntiledJaxKeyNoise, _pair
from tests.test_torch_sampler import JaxKeyNoise, assert_golden

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

N_STEPS = 4
FAMILIES = ('continuous', 'gaussian', 'elucidated')
# (JAX wrapper, port wrapper, keywords of both)
WRAPPERS = {
    'continuous': (JaxContinuous, ContinuousDiffusion,
                   dict(num_sample_steps=N_STEPS)),
    'continuous_dpmpp': (JaxContinuous, ContinuousDiffusion,
                         dict(num_sample_steps=N_STEPS, sampler='dpmpp')),
    'continuous_ddim_dc': (JaxContinuous, ContinuousDiffusion,
                           dict(num_sample_steps=N_STEPS, sampler='ddim',
                                ddim_eta=1.0, deep_cache_interval=2,
                                deep_cache_depth=1)),
    'gaussian': (JaxGaussian, GaussianDiffusion,
                 dict(timesteps=12, sampling_timesteps=N_STEPS,
                      beta_schedule='sigmoid')),
    'gaussian_ancestral': (JaxGaussian, GaussianDiffusion,
                           dict(timesteps=N_STEPS, sampling_timesteps=None,
                                beta_schedule='sigmoid')),
    'elucidated': (JaxElucidated, ElucidatedDiffusion,
                   dict(num_sample_steps=N_STEPS)),
    'elucidated_dpmpp': (JaxElucidated, ElucidatedDiffusion,
                         dict(num_sample_steps=N_STEPS,
                              use_dpmpp_solver=True)),
}


@pytest.fixture(scope='module')
def pairs():
    return {'learned': _pair(True, 21), 'plain': _pair(False, 22)}


def _wrappers(pairs, name):
    jax_cls, port_cls, kw = WRAPPERS[name]
    jnet, params, net = pairs['plain' if 'gaussian' in name else 'learned']
    jw = jax_cls(net=jnet, image_size=16, **kw)
    return jw, params, port_cls(net, image_size=16, **kw)


@pytest.fixture(scope='module')
def conds():
    rng = np.random.default_rng(23)
    return dict(untiled=rng.uniform(size=(1, 16, 16, 3)).astype(np.float32),
                tiled=rng.uniform(size=(1, 40, 40, 3)).astype(np.float32),
                label=np.asarray([2]))


TILED = dict(tile_size=32, batch_size=4)


def _port_run(wrapper, conds, tiled, seed=5, **kw):
    """The port's run with its default noise source, torch inputs."""
    cond = torch.from_numpy(conds['tiled' if tiled else 'untiled'])
    label = torch.from_numpy(conds['label'])
    noise = GeneratorNoise(seed, 'cpu')
    if tiled:
        return wrapper.tiled_sample(cond, label, noise=noise, **TILED, **kw)
    return wrapper.sample(cond, label, noise=noise, **kw)


def assert_frames_golden(got, want):
    """Frame by frame at the samplers' bar in pixel space: a [-1, 1] frame
    halved, as unnormalizing maps it to [0, 1], and a frame of larger
    magnitude m divided by 2 m."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    for k in range(want.shape[0]):
        scale = 2.0 * max(1.0, float(np.abs(want[k]).max()))
        assert_golden(got[k] / scale, want[k] / scale)


# ---------------------------------------------------------------------------
# tests/test_capture.py's contract in every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('family', FAMILIES)
def test_tiled_capture_frames(pairs, conds, family):
    _, _, w = _wrappers(pairs, family)
    out = _port_run(w, conds, True, class_cond_scale=2.0)
    out2, traj, x0 = _port_run(w, conds, True, class_cond_scale=2.0,
                               capture_trajectory=True, capture_x0=True)
    # the captures change no bit of the output
    assert torch.equal(out, out2)
    assert traj.shape == (N_STEPS + 1, *out.shape) and traj.dtype == torch.float32
    assert x0.shape == traj.shape
    # frame 0 of both stacks is the cropped init canvas
    assert torch.equal(traj[0], x0[0])
    # the last image frame is the raw canvas behind the output
    assert torch.equal((torch.clamp(traj[-1], -1, 1) + 1) * 0.5, out)
    # the x0 frames hold the net's estimate (or derivative), not the canvas
    assert not torch.allclose(traj[1], x0[1])
    assert torch.isfinite(x0).all()


@pytest.mark.parametrize('family', FAMILIES)
def test_tiled_capture_each_flag_alone(pairs, conds, family):
    _, _, w = _wrappers(pairs, family)
    out_t, traj = _port_run(w, conds, True, capture_trajectory=True)
    out_x, x0 = _port_run(w, conds, True, capture_x0=True)
    both = _port_run(w, conds, True, capture_trajectory=True, capture_x0=True)
    assert torch.equal(traj, both[1]) and torch.equal(x0, both[2])
    assert torch.equal(out_t, out_x) and torch.equal(out_t, both[0])


@pytest.mark.parametrize('family', FAMILIES)
def test_untiled_capture_frames(pairs, conds, family):
    """Init frame plus one per step, both stacks; the elucidated family's
    Heun path (``sample_org``) captures as its DPM++ one does."""
    _, _, w = _wrappers(pairs, family)
    out, traj, x0 = _port_run(w, conds, False, capture_trajectory=True,
                              capture_x0=True)
    assert traj.shape == (N_STEPS + 1, 1, 16, 16, 3) and x0.shape == traj.shape
    assert torch.equal(traj[0], x0[0])
    assert not torch.allclose(traj[1], x0[1])
    assert torch.equal(out, _port_run(w, conds, False))
    if family == 'elucidated':
        o3, t3, x3 = w.sample_org(torch.from_numpy(conds['untiled']),
                                  noise=GeneratorNoise(5, 'cpu'),
                                  capture_trajectory=True, capture_x0=True)
        assert t3.shape == x3.shape == (N_STEPS + 1, 1, 16, 16, 3)
        assert torch.equal((torch.clamp(t3[-1], -1, 1) + 1) * 0.5, o3)


@pytest.mark.parametrize('family', FAMILIES)
def test_capture_respects_generation_start_steps(pairs, conds, family):
    """Frames: the init canvas and one per executed step."""
    _, _, w = _wrappers(pairs, family)
    for tiled in (True, False):
        out, traj, x0 = _port_run(w, conds, tiled, generation_start_steps=2,
                                  capture_trajectory=True, capture_x0=True)
        assert traj.shape[0] == x0.shape[0] == 1 + (N_STEPS - 2)
        assert torch.equal((torch.clamp(traj[-1], -1, 1) + 1) * 0.5, out)


@pytest.mark.parametrize('family', FAMILIES)
def test_tiled_capture_with_deep_cache_raises(pairs, conds, family):
    """As in the JAX package: the per-step state would stack the per-tile
    caches. The untiled samplers capture under DeepCache."""
    jax_cls, port_cls, kw = WRAPPERS[family]
    net = pairs['plain' if family == 'gaussian' else 'learned'][2]
    w = port_cls(net, image_size=16, deep_cache_interval=2,
                 deep_cache_depth=1, **kw)
    for flags in (dict(capture_trajectory=True), dict(capture_x0=True)):
        with pytest.raises(NotImplementedError,
                           match='deep_cache_interval > 1 with tiled debug '
                                 'captures is not supported'):
            _port_run(w, conds, True, **flags)
    out, traj = _port_run(w, conds, False, capture_trajectory=True)
    assert traj.shape[0] == N_STEPS + 1


def test_crop_frames_crops_every_frame():
    frames = torch.arange(2 * 1 * 6 * 5 * 3, dtype=torch.float32).reshape(
        2, 1, 6, 5, 3)
    got = crop_frames(frames, (1, 2, 4, 5))      # left, top, right, bottom
    assert torch.equal(got, frames[:, :, 2:5, 1:4, :])
    assert torch.equal(crop_frames(frames[0], (1, 2, 4, 5)), got[0])


# ---------------------------------------------------------------------------
# Frame by frame against the JAX samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name,start', [
    ('continuous', 0), ('continuous_dpmpp', 0), ('gaussian', 1),
    ('elucidated', 1)])
def test_tiled_frames_match_jax(pairs, conds, name, start):
    """Class CFG on the 96 canvas of 9 aligned and 4 shifted tiles, tile
    batch 4; from step 1 (an odd first step) in two families."""
    jw, params, pw = _wrappers(pairs, name)
    key = jax.random.PRNGKey(24)
    kw = dict(TILED, class_cond_scale=2.0, generation_start_steps=start,
              capture_trajectory=True, capture_x0=True)
    want = jw.tiled_sample(params, key, jnp.asarray(conds['tiled']),
                           jnp.asarray(conds['label']), **kw)
    got = pw.tiled_sample(torch.from_numpy(conds['tiled']),
                          torch.from_numpy(conds['label']),
                          noise=JaxKeyNoise(key), **kw)
    assert len(got) == len(want) == 3
    assert_golden(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.shape[0] == 1 + N_STEPS - start
        assert_frames_golden(g.numpy(), w)


@pytest.mark.parametrize('name', ['continuous', 'continuous_ddim_dc',
                                  'gaussian', 'gaussian_ancestral',
                                  'elucidated', 'elucidated_dpmpp'])
def test_untiled_frames_match_jax(pairs, conds, name):
    """Cond CFG; DeepCache at interval 2 on the DDIM(eta 1) case."""
    jw, params, pw = _wrappers(pairs, name)
    key = jax.random.PRNGKey(25)
    kw = dict(cond_scale=1.5, capture_trajectory=True, capture_x0=True)
    if name.startswith('continuous'):
        # the continuous sampler's untiled noise: injected in both
        rng = np.random.default_rng(26)
        init = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
        steps = rng.normal(size=(N_STEPS, 1, 16, 16, 3)).astype(np.float32)
        want = jw.sample(params, key, jnp.asarray(conds['untiled']),
                         jnp.asarray(conds['label']),
                         init_noise=jnp.asarray(init),
                         step_noises=jnp.asarray(steps), **kw)
        got = pw.sample(torch.from_numpy(conds['untiled']),
                        torch.from_numpy(conds['label']),
                        init_noise=torch.from_numpy(init),
                        step_noises=torch.from_numpy(steps), **kw)
    else:
        want = jw.sample(params, key, jnp.asarray(conds['untiled']),
                         jnp.asarray(conds['label']), **kw)
        got = pw.sample(torch.from_numpy(conds['untiled']),
                        torch.from_numpy(conds['label']),
                        noise=UntiledJaxKeyNoise(key), **kw)
    assert len(got) == len(want) == 3
    assert_golden(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.shape[0] == 1 + N_STEPS
        assert_frames_golden(g.numpy(), w)


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------

def test_mesh_ranks_capture_world_one_frames(tmp_path):
    """Two gloo ranks split the tile chunks and gather them back, the x0
    canvas's tiles too: every rank's output and frames are world 1's, bit
    for bit (the continuous and elucidated cases of
    tests/test_torch_mesh_ranks.py)."""
    names = ['continuous', 'elucidated']
    want = {n: ranks.capture_case(n) for n in names}
    got = ranks.run_world(ranks.capture_rank, (2, 1), (names,), tmp_path)
    for n in names:
        assert len(got[n]) == 3 and got[n][1].shape[0] == got[n][2].shape[0]
        for g, w in zip(got[n], want[n]):
            np.testing.assert_array_equal(g, w)
