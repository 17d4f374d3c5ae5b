"""The port's evaluation entry points (``srgd_tpu_torch.tools``) against the
JAX package's ``tools/``.

- ``synth.make_image``: the bytes of ``tools/make_synth_dataset.make_image``.
- ``quality_probe``: the JAX probe's ``main`` and the port's ``run`` at
  QP_DIM=16, QP_LR=16, QP_STEPS=3 on the same weights (the JAX init through
  ``state_dict_from_jax``), condition and noise (the JAX key schedule,
  ``JaxKeyNoise``). The float32 modes are held to PSNR > 60 dB with max
  error < 2e-3 (``F32_MAX_ERR``: the first step's 1/alpha; their frames
  from the second step meet the samplers' 5e-4) and their PSNR lines to
  ROADMAP item 16's 0.1 dB; bfloat16, whose rounding points differ between XLA and PyTorch,
  to lie nearer JAX's bf16 output than that lies to JAX's float32 one;
  w8a8dyn, in float32 compute on JAX's activation codes
  (``tests/test_torch_quant.JaxCodes``), to
  tests/test_quant.py:77's 0.10 of the output's largest value. One parser
  reads both probes' lines.
- ``evidence_eval``: tests/test_cli.py's CFG-ladder variants against the
  port's ``run_cfg_ladder``, the same call list as JAX's; one tiny
  end-to-end ``main`` from a port checkpoint, all three tables parsed.
- ``flagship_ckpt`` at dim 16: the ``.pth`` holds tests/torch_ref.py's
  keys, loads with none missing or left over, and the CLI writes the x4 PNG.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu_torch.checkpoint import save_params, state_dict_from_jax
from srgd_tpu_torch.tools import evidence_eval as tev
from srgd_tpu_torch.tools import flagship_ckpt
from srgd_tpu_torch.tools import quality_probe as tqp
from srgd_tpu_torch.tools import synth
from tests.test_torch_quant import JaxCodes
from tests.test_torch_sampler import JaxKeyNoise

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W8A8_RTOL = 0.10     # tests/test_quant.py:77
PSNR_DB = 0.1        # ROADMAP item 16
SAMPLER_MAX_ERR = 5e-4   # tests/test_e2e_parity.py:105-111
# the probe's float32 outputs: the samplers' PSNR bar holds (97.6 dB), their
# max error does not. The first step, at log-SNR -10, takes x0 from the net's
# noise estimate divided by alpha = 0.0067; the two packages' estimates differ
# by about 2e-5 there (well inside tests/test_torch_unet.py's 1e-4), and the
# first x0 frame lies 1.3e-3 (in [0, 1]) from JAX's, one pixel of the output
# 1.18e-3. From the second step on the probe meets 5e-4
# (test_probe_float32_frames_match_jax).
F32_MAX_ERR = 2e-3


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_make_image_matches_the_jax_tool(seed):
    from tools.make_synth_dataset import make_image
    for size in (32, 48):
        want = make_image(np.random.default_rng(seed), size)
        got = synth.make_image(np.random.default_rng(seed), size)
        assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# quality_probe
# ---------------------------------------------------------------------------

PROBE_ENV = dict(QP_DIM='16', QP_LR='16', QP_STEPS='3', QP_WSEED='0',
                 QP_CSEED='1', QP_QMIN='0',
                 QP_MODES='float32,float32+dc2.2,bfloat16,w8a8dyn')
MODES = PROBE_ENV['QP_MODES'].split(',')


def _float32_quantized_nets(mp):
    """Both probes build their w8a8 nets in float32 compute with float32
    weights; everything int8 stays. bf16 rounds at different points in XLA
    and PyTorch on the CPU, which moves activations by whole int8 codes
    (tests/test_torch_cli.py's int8 CLI test does the same)."""
    import srgd_tpu.nn.unet as jax_unet
    real_build = jax_unet.build_unet_from_config

    def build(conf, *a, **k):
        if conf.quantize == 'w8a8':
            conf.compute_dtype = 'float32'   # and JAX casts no params
        return real_build(conf, *a, **k)
    mp.setattr(jax_unet, 'build_unet_from_config', build)
    real_get = tqp.get_model

    def get_model(conf, *a, **k):
        if conf.quantize == 'w8a8':
            conf.compute_dtype = conf.param_dtype = 'float32'
        return real_get(conf, *a, **k)
    mp.setattr(tqp, 'get_model', get_model)


@pytest.fixture(scope='module')
def probe_inputs():
    """The JAX probe's QP_WSEED=0 weights of the flagship geometry at dim 16
    and its QP_CSEED=1 condition."""
    import __graft_entry__ as ge
    from srgd_tpu.nn.unet import build_unet_from_config

    params = jax.jit(lambda k: build_unet_from_config(
        ge._flagship_conf(unet_dim=16)).init(
            k, jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,)),
            cond=jnp.zeros((1, 256, 256, 3)),
            class_label=jnp.zeros((1,), jnp.int32)))(jax.random.PRNGKey(0))
    cond = np.array(jax.random.uniform(jax.random.PRNGKey(1), (1, 64, 64, 3),
                                       jnp.float32))
    return params, cond


@pytest.fixture(scope='module')
def probes(probe_inputs, tmp_path_factory):
    """Both probes on the same inputs; (JAX outputs, JAX stdout, port
    outputs, port stdout). The JAX probe reads the weights of its QP_WSEED
    init from a checkpoint (QP_CKPT), so it runs no init forward, and runs
    jitted: ``JaxCodes`` reads its int8 operands through ordered
    callbacks."""
    import contextlib
    import io

    import tools.quality_probe as jqp
    from srgd_tpu.checkpoint.io import save_params as jax_save_params

    params, cond = probe_inputs
    tmp = tmp_path_factory.mktemp('probe')
    jax_save_params(str(tmp / 'ckpt'), {'ema_params': params})
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(PROBE_ENV, QP_SAVE_DIR=str(tmp / 'save'),
                         QP_CKPT=str(tmp / 'ckpt')).items():
            mp.setenv(k, v)
        _float32_quantized_nets(mp)
        codes = JaxCodes(mp)
        jax_text = io.StringIO()
        with contextlib.redirect_stdout(jax_text):
            jqp.main()
        want = {m: np.load(tmp / 'save' / f'{m}.npy') for m in MODES}

        port_text = io.StringIO()
        with contextlib.redirect_stdout(port_text):
            got, _ = tqp.run(
                tqp.flagship_conf(16), MODES,
                state_dict_from_jax(params['params']),
                torch.from_numpy(cond), torch.zeros((1,), dtype=torch.long),
                steps=3, device=torch.device('cpu'), qmin=0,
                noise_for_seed=lambda seed, device: JaxKeyNoise(
                    jax.random.PRNGKey(seed)))
        codes.done()
    return want, jax_text.getvalue(), got, port_text.getvalue()


def _psnr(a, b):
    return -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20))


@pytest.mark.parametrize('mode', MODES)
def test_probe_mode_matches_jax(probes, mode):
    want, _, got, _ = probes
    a, b = got[mode], want[mode]
    assert a.shape == b.shape == (1, 64, 64, 3) and a.dtype == np.float32
    assert np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1
    err = np.abs(a - b).max()
    if mode.startswith('float32'):
        assert _psnr(a, b) > 60 and err < F32_MAX_ERR, (err, _psnr(a, b))
    elif mode == 'bfloat16':
        # bf16 rounds at other points in XLA and PyTorch; the port's output
        # is nearer JAX's bf16 output than that is to JAX's float32 one
        assert _psnr(a, b) > _psnr(b, want['float32']) + 3, (
            _psnr(a, b), _psnr(b, want['float32']))
    else:
        assert err <= W8A8_RTOL * np.abs(b).max(), (mode, err)


@pytest.mark.parametrize('start', [0, 1])
def test_probe_float32_frames_match_jax(probe_inputs, start, capsys):
    """The probe's float32 sampling (tile 256, batch 8, 3 steps, seed 71)
    from ``generation_start_steps`` ``start`` with both captures, frame by
    frame against JAX's, errors in output units ([-1, 1] frames halved).
    From the second step the frames and the output meet the samplers' bar.
    From the first, the first step's output frame still does; its x0 frame,
    the noise estimate divided by alpha = 0.0067, and what follows from it
    are held to F32_MAX_ERR (the readings print with ``-s``)."""
    import __graft_entry__ as ge
    from srgd_tpu.factory import build_wrapper
    from srgd_tpu.nn.unet import build_unet_from_config
    from srgd_tpu_torch.factory import get_model

    params, cond = probe_inputs
    kw = dict(batch_size=8, tile_size=256, num_sample_steps=3,
              generation_start_steps=start, capture_trajectory=True,
              capture_x0=True)
    conf = ge._flagship_conf(unet_dim=16)
    want = build_wrapper(conf, build_unet_from_config(conf)).tiled_sample(
        params, jax.random.PRNGKey(tqp.NOISE_SEED), jnp.asarray(cond),
        jnp.zeros((1,), jnp.int32), host_loop=True, **kw)
    wrapper, _ = get_model(tqp.flagship_conf(16), '', device='cpu',
                           state_dict=state_dict_from_jax(params['params']))
    got = wrapper.tiled_sample(
        torch.from_numpy(cond), torch.zeros((1,), dtype=torch.long),
        noise=JaxKeyNoise(jax.random.PRNGKey(tqp.NOISE_SEED)), **kw)
    errs = {}
    for name, a, b, scale in zip(('output', 'trajectory', 'x0'), got, want,
                                 (1, 2, 2)):
        a, b = a.float().numpy() / scale, np.asarray(b, np.float32) / scale
        assert a.shape == b.shape
        frames = [(a, b)] if name == 'output' else list(zip(a, b))
        errs[name] = [(float(np.abs(x - y).max()), _psnr(x, y))
                      for x, y in frames]
    with capsys.disabled():
        print(f'\nfloat32 probe frames from step {start}, (max err, PSNR):',
              errs)
    assert len(errs['x0']) == len(errs['trajectory']) == 4 - start
    for name, frames in errs.items():
        for k, (err, psnr) in enumerate(frames):
            bar = (F32_MAX_ERR if start == 0 and (name == 'output' or k >= 2
                                                   or name == 'x0' and k == 1)
                   else SAMPLER_MAX_ERR)
            assert err < bar and psnr > 60, (name, k, err, psnr)


def test_probe_lines_parse_with_one_regex(probes):
    """Both probes print a 'sampled' line per mode and a 'vs' line per mode
    after the first; one parser reads both."""
    _, jax_text, _, port_text = probes
    for text in (jax_text, port_text):
        lines = tqp.parse_lines(text)
        assert sorted(lines['sampled']) == sorted(MODES)
        assert sorted(lines['psnr']) == sorted(MODES[1:])
        for m in MODES:
            assert lines['sampled'][m]['px'] == 64
            assert lines['sampled'][m]['steps'] == 3
        assert {v['ref'] for v in lines['psnr'].values()} == {'float32'}
    # the line format itself, character for character
    assert re.search(r'^float32\+dc2\.2 vs float32: PSNR \d+\.\d\d dB  '
                     r'\(max\|d\| \d\.\d{4}, uint8-quantized PSNR \d+\.\d\d '
                     r'dB\)$', port_text, re.M)


def test_probe_float32_psnr_lines_within_a_tenth_of_a_db(probes):
    _, jax_text, got, port_text = probes
    want = tqp.parse_lines(jax_text)['psnr']['float32+dc2.2']
    mine = tqp.parse_lines(port_text)['psnr']['float32+dc2.2']
    for key in ('psnr', 'psnr_uint8'):
        assert abs(mine[key] - want[key]) <= PSNR_DB, (key, mine, want)
    # the printed numbers are the port's compare() of its own outputs
    c = tqp.compare(got['float32'], got['float32+dc2.2'])
    assert abs(c['psnr'] - mine['psnr']) <= 0.005


@pytest.mark.parametrize('mode, fields, base', [
    ('float32', dict(compute_dtype='float32', quantize='none',
                     deep_cache_interval=0), 'float32'),
    ('bfloat16+dc3', dict(compute_dtype='bfloat16', param_dtype='bfloat16',
                          deep_cache_interval=3, deep_cache_depth=2), 'bfloat16'),
    ('w8a8+dc2.3', dict(compute_dtype='bfloat16', quantize='w8a8',
                        deep_cache_interval=2, deep_cache_depth=3), 'w8a8'),
    ('w8a8dyn@0.5', dict(quantize='w8a8', quantize_smooth_alpha=0.5),
     'w8a8dyn'),
    ('w8a8%p99.9', dict(quantize='w8a8', quantize_cal_mode='p99.9'), 'w8a8'),
    ('w8a8t', dict(quantize='w8a8', quantize_smooth_alpha=0.0), 'w8a8t'),
    ('bfloat16+dc2.2@0.5x3/0.5x1', dict(
        deep_cache_interval=2, deep_cache_depth=2,
        deep_cache_schedule='0.5x3/0.5x1'), 'bfloat16'),
])
def test_probe_mode_grammar(mode, fields, base):
    """The JAX probe's grammar: '+dcN[.D][@SCHED]', '@alpha', '%cal_mode'."""
    got, got_base = tqp.parse_mode(mode)
    assert got_base == base
    assert {k: got[k] for k in fields} == fields


# ---------------------------------------------------------------------------
# evidence_eval
# ---------------------------------------------------------------------------

CFG_ENV = {'EV_CFG': '1', 'EV_CFG_CLASSES': '1', 'EV_CFG_IMAGES': '1',
           'EV_CFG_MODE': 'ddim:1.0-6', 'EV_CFG_CLASS_SCALES': '2',
           'EV_CFG_WARM': '2@3', 'EV_CFG_COND_SCALES': '1.5',
           'EV_CFG_WRONG': '1,2'}


def _ladder_calls(run_cfg_ladder, dcfg):
    calls = []

    def fake_sample(cond01, label, steps, mode, **gk):
        calls.append((label, steps, mode, gk))
        return np.asarray(cond01, np.float32), 0.0

    run_cfg_ladder(fake_sample, 32, np.random.default_rng(0), dcfg)
    return calls


def test_evidence_cfg_ladder_variants(monkeypatch, capsys):
    """tests/test_cli.py's case on the port's ``run_cfg_ladder``: the
    baseline carries no guidance, each scale variant one CFG axis, the
    warm-up its start step, the wrong-label controls the permuted label;
    and the call list is the JAX tool's."""
    import tools.evidence_eval as jev
    from srgd_tpu.config import Config as JaxConfig
    from srgd_tpu.train.data import DegradeConfig as JaxDegradeConfig
    from srgd_tpu_torch.config import Config
    from srgd_tpu_torch.train.data import DegradeConfig

    for k, v in CFG_ENV.items():
        monkeypatch.setenv(k, v)
    calls = _ladder_calls(tev.run_cfg_ladder,
                          DegradeConfig.from_conf(Config()))
    assert [c[:3] for c in calls] == [(1, 6, 'ddim:1.0')] * 4 + [
        (2, 6, 'ddim:1.0')] * 2
    assert [c[3] for c in calls] == [
        {}, {'class_cond_scale': 2.0},
        {'class_cond_scale': 2.0, 'class_guidance_start_steps': 3},
        {'cond_scale': 1.5}, {}, {'class_cond_scale': 2.0}]
    out = capsys.readouterr().out
    assert 'CFG summary' in out and 'WRONG-label' in out
    assert calls == _ladder_calls(jev.run_cfg_ladder,
                                  JaxDegradeConfig.from_conf(JaxConfig()))
    monkeypatch.setenv('EV_CFG', '0')
    assert _ladder_calls(tev.run_cfg_ladder,
                         DegradeConfig.from_conf(Config())) == []


TINY_EVIDENCE_YAML = """
model: conditional_continuous
unet_dim: 8
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 4
num_classes: 3
conditional_task_type: realsr_denoise_sr
"""


def test_evidence_main_prints_the_three_tables(tmp_path, monkeypatch, capsys):
    """``main`` from a port trainer checkpoint (``save_params`` of seeded
    weights, the trainer's ``ema_params`` and ``step``) on 32-px canvases:
    the per-class table, the few-step summary and the CFG summary, every
    number finite."""
    from srgd_tpu_torch.config import load_config
    conf_path = tmp_path / 'tiny.yaml'
    conf_path.write_text(TINY_EVIDENCE_YAML)
    weights = tqp.random_weights(load_config(str(conf_path)), 3, 'cpu')
    save_params(str(tmp_path / 'ckpt'), {'ema_params': weights, 'step': 7})
    env = dict(EV_CKPT=str(tmp_path / 'ckpt'), EV_CONF=str(conf_path),
               EV_HR='32', EV_TILE='32', EV_IMAGES='1', EV_BASE_STEPS='2',
               EV_LADDER_CLASSES='0,1', EV_LADDER_IMAGES='1',
               EV_LADDER_MODES='ddim-2,dpmpp-2', EV_CFG='1',
               EV_CFG_CLASSES='2', EV_CFG_IMAGES='1',
               EV_CFG_MODE='ddim:1.0-2', EV_CFG_CLASS_SCALES='2',
               EV_CFG_WARM='2@1', EV_CFG_COND_SCALES='1.5',
               EV_CFG_WRONG='2', EV_DEVICE='cpu')
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tev.main()
    out = capsys.readouterr().out
    assert 'loaded EMA weights at train step 7' in out
    tables = tev.parse_tables(out)
    assert [r['label'] for r in tables['per_class']] == [0, 1, 2]
    assert [(r['mode'], r['steps']) for r in tables['ladder']] == [
        ('ancestral', 2), ('ddim', 2), ('dpmpp', 2)]
    assert [r['tag'] for r in tables['cfg']] == [
        'base s=1', 'class s=2', 'class s=2@w1', 'cond s=1.5',
        'WRONG-label s=2']
    assert all(list(r['classes']) == [2] for r in tables['cfg'])
    numbers = [v for rows in tables.values() for r in rows
               for v in r.values() if isinstance(v, float)]
    numbers += [x for r in tables['cfg'] for pair in r['classes'].values()
                for x in pair]
    assert len(numbers) > 30 and np.isfinite(numbers).all()


# ---------------------------------------------------------------------------
# flagship_ckpt
# ---------------------------------------------------------------------------

TINY_FLAGSHIP_YAML = """
model: conditional_continuous
noise_schedule: linear
unet_dim: 16
ddpm_unet_dim_mults: '1,2,4,8'
full_attn: 'False,False,False,True'
learned_sinusoidal_cond: true
learned_sinusoidal_dim: 32
num_classes: 3
"""


def test_flagship_tool_at_dim_16_writes_loads_and_samples(tmp_path):
    """The flagship geometry at dim 16: the ``.pth`` holds the reference's
    keys (tests/torch_ref.make_state_dict of the same config), every one of
    them loads, and ``python -m srgd_tpu_torch.infer`` writes the x4 PNG."""
    from tests.torch_ref import make_state_dict
    conf = tmp_path / 'flagship16.yaml'
    conf.write_text(TINY_FLAGSHIP_YAML)
    rec = flagship_ckpt.run(str(tmp_path / 'work'), conf_path=str(conf),
                            device='cpu', dim=16)
    want = make_state_dict(dim=16, dim_mults=(1, 2, 4, 8),
                           full_attn=(False, False, False, True),
                           num_classes=3, learned_sinusoidal_dim=32)
    saved = torch.load(rec['pth'], weights_only=True)
    assert set(saved) == {'ema_model'}
    assert set(saved['ema_model']) == {f'model.{k}' for k in want}
    assert all(saved['ema_model'][f'model.{k}'].shape == v.shape
               for k, v in want.items())
    assert rec['loaded']['missing'] == rec['loaded']['unexpected'] == []
    assert rec['cli']['size'] == (64, 64)
    assert rec['cli']['cmd'][-2:] == ['--device', 'cpu']


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('tool', ['quality_probe', 'evidence_eval',
                                  'flagship_ckpt'])
def test_tools_default_to_the_card_and_raise_without_one(tool, monkeypatch,
                                                         tmp_path):
    """QP_DEVICE, EV_DEVICE and --device default to cuda; with no card each
    tool raises before any work, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for k in ('QP_DEVICE', 'EV_DEVICE'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('EV_CKPT', str(tmp_path / 'none'))
    main = {'quality_probe': tqp.main, 'evidence_eval': tev.main,
            'flagship_ckpt': lambda: flagship_ckpt.main([str(tmp_path / 'w')])}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main[tool]()
    assert not (tmp_path / 'w').exists()
