"""The port stands alone: no JAX at import or run time, no CPU mode in
chip_smoke.py, and no silent fallback when the kernels cannot be built."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from srgd_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

# Rehearses chip_smoke.py's phases on the CPU at a tiny size (the kernels'
# plain versions; dim 16, 32-px tiles), then imports every module of the port
# and builds the CLI's sampler on the CPU, and reports which modules of JAX
# or the JAX package got imported.
_SLICE = r"""
import importlib, json, pkgutil, sys
import torch
torch.set_num_threads(1)
import chip_smoke
cpu = torch.device('cpu')
kernels = chip_smoke.phase_kernels(
    torch, cpu, b=2, lin_shapes=((40, 32),), attn_shapes=((16, 64),),
    gn_shapes=((40, 32),), linear_shapes=(40,), flash_shapes=(16,),
    ragged_lin_shapes=((70, 32),), ragged_flash_shapes=(70, 24),
    ragged_attn_shapes=((70, 64), (24, 64)), ragged_linear_shapes=(70,),
    iters=1)
net = dict(dim=16, dim_mults=(1, 2), full_attn=(False, True))
slice_ = chip_smoke.phase_slice(torch, cpu, size=40, tile_size=32, steps=2,
                                batch_size=4, **net)
slice_pallas = chip_smoke.phase_slice_pallas(
    torch, cpu, size=40, tile_size=32, steps=2, batch_size=4, pair_rows=64,
    **net)
deep_cache = chip_smoke.phase_deep_cache(torch, cpu, size=40, tile_size=32,
                                        steps=4, batch_size=4, depth=1,
                                        forward_iters=1, **net)
families = chip_smoke.phase_families(
    torch, cpu, size=40, tile_size=32, batch_size=4, dpmpp_size=32,
    unet_dim=16, ddpm_unet_dim_mults='1,2', full_attn='False,True',
    learned_sinusoidal_dim=8, learned_schedule_net_hidden_dim=16)
serve = chip_smoke.phase_serve(torch, cpu, conf=sys.argv[1], seeded=(12, 10),
                               square=16, watch=(13, 7), lr_bucket=8,
                               tile_size=32, batch_size=4, steps=2)
train = chip_smoke.phase_train(torch, cpu, conf=sys.argv[2], images=4,
                               image_size=40, steps=3, save_every=2,
                               resume_to=4, grad_b=2,
                               grad_lin_shapes=((40, 32),),
                               grad_attn_shapes=((16, 64),), pallas_size=16)
int8 = chip_smoke.phase_int8(torch, cpu, conf=sys.argv[3], min_channels=32,
                             batch_size=4, tile_size=32, cal_batch=2,
                             cli_size=10, cli_steps=2, serve_size=8,
                             serve_steps=2, iters=1, forward_iters=1)
mesh = chip_smoke.phase_mesh(torch, cpu, size=40, tile_size=32, steps=2,
                             batch_size=4, train_conf=sys.argv[2], images=4,
                             image_size=40, cli_conf=sys.argv[1], cli_size=10,
                             **net)
# the probe's calibrated w8a8 mode takes about 7 minutes of a CPU on its
# 256-px tiles
from srgd_tpu_torch.tools import quality_probe
quality_probe.TILE_SIZE = 32
quality = chip_smoke.phase_quality(
    torch, cpu, lr=10, steps=4, dim=16,
    evidence_conf=sys.argv[2], evidence_hr=32, evidence_steps=2,
    evidence_tile=32, size=40, tile_size=32, batch_size=4, dpmpp_size=32,
    pth_conf=sys.argv[4], pth_dim=16, net_kw=net,
    conf_kw=dict(unet_dim=16, ddpm_unet_dim_mults='1,2',
                 full_attn='False,True', learned_sinusoidal_dim=8,
                 learned_schedule_net_hidden_dim=16))
convert = chip_smoke.phase_convert(torch, cpu, conf=sys.argv[4], dim=16,
                                  train_conf=sys.argv[5], images=4,
                                  image_size=40)
bench = chip_smoke.phase_bench(torch, cpu, lr_size=10, tile_size=32,
                               batch_size=4, forward_iters=1, **net)
profile = chip_smoke.phase_profile(torch, cpu, tile_size=32, batch_size=2,
                                   forwards=1, top=3, lin_shapes=((70, 32),),
                                   attn_shapes=((70, 64),),
                                   gn_shapes=((70, 32),),
                                   linear_shapes=(70,), flash_shapes=(70,),
                                   int8_conf=sys.argv[3], int8_min_channels=32,
                                   **net)
def foreign():
    return sorted(k for k in sys.modules if k.split('.')[0] in
                  ('jax', 'jaxlib', 'flax', 'srgd_tpu'))
smoke_imported = foreign()
import srgd_tpu_torch
for m in pkgutil.walk_packages(srgd_tpu_torch.__path__, 'srgd_tpu_torch.'):
    importlib.import_module(m.name)
from srgd_tpu_torch import infer
args = infer.parse_args(['-c', sys.argv[1], '-m', '', '--input_dir', 'x',
                         '--output_dir', 'y', '--device', 'cpu',
                         '--use_pallas', '--continuous_sampler', 'dpmpp'])
sampler = infer.build_sampler(args)
print(json.dumps({
    'smoke_imported': smoke_imported, 'port_imported': foreign(),
    'sampler': [type(sampler.wrapper).__name__, sampler.wrapper.sampler],
    'ok': [kernels['ok'], slice_['ok'], slice_pallas['ok'], deep_cache['ok'],
           families['ok'], serve['ok'], train['ok'], int8['ok'], mesh['ok'],
           quality['ok'], convert['ok'], bench['ok'], profile['ok']],
    'slice': slice_, 'slice_pallas': slice_pallas, 'bench': bench,
    'deep_cache': deep_cache, 'families': families, 'serve': serve,
    'train': train, 'int8': int8, 'mesh': mesh, 'quality': quality,
    'convert': convert,
    'kernel_cases': [[c['kernel'], c['b'], c.get('film'), c['dtype'], c['n'],
                      c['bitwise_repeat']] for c in kernels['cases']],
    'profile': profile,
    'summary': chip_smoke.summary(kernels, slice_, slice_pallas, deep_cache,
                                  families, serve, train, int8, mesh,
                                  quality, convert)}))
"""

TINY_YAML = """
model: conditional_continuous
unet_dim: 16
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_dim: 8
"""

# the serving YAML's int8 keys at a tiny size
TINY_INT8_YAML = TINY_YAML + """
compute_dtype: bfloat16
quantize: w8a8
quantize_min_channels: 512
"""

# the flagship geometry (4 stages) at dim 16, for the quality phase's .pth
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

# the training YAML's keys at a tiny size: 16-px HR and 4-px LR crops
TRAIN_KEYS = """
prefix: tiny_train
hr_image_size: 16
lr_image_size: 4
scale_size: 20
batch_size: 2
num_workers: 1
n_fold: 10
train_fold: '0'
epochs: 20
warmup_epochs: 1
ema_decay: 0.999
skip_val: true
test_target: best_loss
compute_dtype: bfloat16
"""
TINY_TRAIN_YAML = TINY_YAML + TRAIN_KEYS
# the convert phase's trainer: the flagship geometry at dim 16, so that its
# CLI runs, on 256-px tiles, keep full attention at the last stage
TINY_FLAGSHIP_TRAIN_YAML = TINY_FLAGSHIP_YAML + TRAIN_KEYS


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1', **extra)


@pytest.fixture(scope='module')
def rehearsal(tmp_path_factory):
    conf = tmp_path_factory.mktemp('hygiene') / 'tiny.yaml'
    conf.write_text(TINY_YAML)
    train_conf = conf.with_name('tiny_train.yaml')
    train_conf.write_text(TINY_TRAIN_YAML)
    int8_conf = conf.with_name('tiny_int8.yaml')
    int8_conf.write_text(TINY_INT8_YAML)
    flagship_conf = conf.with_name('tiny_flagship.yaml')
    flagship_conf.write_text(TINY_FLAGSHIP_YAML)
    flagship_train_conf = conf.with_name('tiny_flagship_train.yaml')
    flagship_train_conf.write_text(TINY_FLAGSHIP_TRAIN_YAML)
    res = subprocess.run([sys.executable, '-c', _SLICE, str(conf),
                          str(train_conf), str(int8_conf),
                          str(flagship_conf), str(flagship_train_conf)],
                         cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_port_and_chip_smoke_phases_import_no_jax(rehearsal):
    rep = rehearsal
    # neither chip_smoke.py's path, nor any module of the port, nor a CPU
    # build of the CLI's sampler imports JAX or the JAX package
    assert rep['smoke_imported'] == [], rep['smoke_imported']
    assert rep['port_imported'] == [], rep['port_imported']
    assert rep['sampler'] == ['ContinuousDiffusion', 'dpmpp']
    assert rep['ok'] == [True] * 13
    s = rep['slice']
    # downs_0_2 and ups_1_2 are linear; downs_1_2, mid_attn and ups_0_2 full
    assert s['forwards'] > 0
    assert (s['per_forward']['linattn_block'],
            s['per_forward']['attn_block']) == (2, 3)
    # the CPU takes the plain versions, which never count as launches
    assert set(s['launches'].values()) == {0}
    names = [k['name'] for k in rep['summary']['kernels']]
    assert names[:2] == ['linattn_block', 'attn_block']


def test_rehearsed_second_slice_routes_to_the_second_kernel_set(rehearsal):
    s = rehearsal['slice_pallas']
    assert s['forwards'] > 0 and s['sampler'] == 'ddim'
    # 2 stages: 11 ResnetBlocks of two Blocks; no whole-block kernel
    assert s['per_forward'] == {
        'linattn_block': 0, 'attn_block': 0, 'groupnorm_silu': 22,
        'attention': 3, 'linear_attention': 0, 'linear_attention_qkv': 2,
        'int8_conv': 0, 'act_amax': 0, 'quantize_act': 0}
    assert set(s['launches'].values()) == {0}
    assert set(s['dpmpp_launches'].values()) == {0}
    assert 0 < s['forward_rel_diff_vs_default_net'] <= 0.05
    assert 0 < s['attention_block_rel_diff_vs_default_net'] <= 0.05
    assert s['entry_pair']['drive_launches'] == 0
    assert all(s['checks'].values()), s['checks']


def test_rehearsed_deep_cache_phase_splits_the_net(rehearsal):
    """Depth 1 on the 2-stage net: the cached forward runs stage 0 and the
    final block only, so it keeps the two stage-0 linear attentions and 10
    of the 22 Blocks; the fresh cache repeats the full forward's bits on
    the CPU; the tiled run at interval 2 alternates full and cached steps."""
    dc = rehearsal['deep_cache']
    assert dc['ok'] and dc['depth'] == 1
    default, pallas = dc['nets']['default'], dc['nets']['use_pallas']
    assert default['per_cached_forward'] == {
        'linattn_block': 2, 'attn_block': 0, 'groupnorm_silu': 0,
        'attention': 0, 'linear_attention': 0, 'linear_attention_qkv': 0,
        'int8_conv': 0, 'act_amax': 0, 'quantize_act': 0}
    assert pallas['per_cached_forward'] == {
        'linattn_block': 0, 'attn_block': 0, 'groupnorm_silu': 10,
        'attention': 0, 'linear_attention': 0, 'linear_attention_qkv': 2,
        'int8_conv': 0, 'act_amax': 0, 'quantize_act': 0}
    for net in (default, pallas):
        assert net['fresh_cache_bitwise'] and net['fresh_cache_max_abs_diff'] == 0
        assert net['cache_shape'] == [4, 16, 32, 32]
        # 4 steps over 3 even and 1 odd chunk of 4 tiles: counters 0, 0, 1,
        # 1; interval 2 refreshes at 0
        assert net['expected_forwards'] == [4, 4]
        assert (net['forwards'], net['cached_forwards']) == (8, 4)
        assert net['full_forward_ms'] > 0 and net['cached_forward_ms'] > 0
        assert all(net['checks'].values()), net['checks']


def test_rehearsed_families_phase_runs_every_family(rehearsal):
    fam = rehearsal['families']
    assert fam['ok']
    runs = fam['runs']
    assert {k: v['wrapper'] for k, v in runs.items()} == {
        'gaussian_ddim_tiled': 'GaussianDiffusion',
        'elucidated_heun_tiled': 'ElucidatedDiffusion',
        'elucidated_dpmpp': 'ElucidatedDiffusion',
        'continuous_learned_tiled': 'ContinuousDiffusion'}
    # one forward per tile chunk (3 even, 1 odd) a step; Heun two a step
    # but the last; DPM++ one a step on one tile
    assert {k: v['forwards'] for k, v in runs.items()} == {
        'gaussian_ddim_tiled': 8, 'elucidated_heun_tiled': 15,
        'elucidated_dpmpp': 4, 'continuous_learned_tiled': 4}
    for run in runs.values():
        assert all(run['checks'].values()), run['checks']


def test_rehearsed_serve_phase_drives_the_daemon(rehearsal):
    """The daemon on the CPU: 2 steps on a 64 canvas of 9 even and 4 odd
    tiles of 32 px in chunks of 4 make 3 + 1 forwards a request alone; the
    coalesced pair's 18 and 8 tiles make 5 + 2, 3.5 a request; the watch
    pair's 32x64 canvases (padded to 64x96: 6 + 2 tiles a canvas) 3 + 1."""
    sv = rehearsal['serve']
    assert sv['ok'] and all(sv['checks'].values()), sv['checks']
    assert sv['alone']['forwards_per_request'] == 4
    assert sv['coalesced']['forwards_per_request'] == 3.5
    assert sv['watch']['forwards'] == 4
    # 3 seeded + 1 guided alone, the coalesced pair, the watch pair
    assert sv['forwards'] == sv['expected_forwards'] == 4 * 4 + 7 + 4
    assert sv['stats']['served'] == 6 and sv['stats']['errors'] == 2
    assert set(sv['launches'].values()) == {0}
    assert sv['healthz_ms_while_busy'] < 2000


def test_rehearsed_train_phase_trains_resumes_and_checks(rehearsal):
    """The train phase on the CPU: main path, resume, checkpoint handoff,
    the use_pallas refusal, remat and the Functions' gradients all hold; the
    plain versions launch no kernel, and the backward recompute runs once
    per attention block and step."""
    tr = rehearsal['train']
    assert tr['ok'] and all(tr['checks'].values()), tr['checks']
    assert tr['per_forward']['linattn_block'] == 2
    assert tr['per_forward']['attn_block'] == 3
    assert set(tr['launches'].values()) == {0}
    assert len(tr['losses']) == tr['resume_to'] == 4
    assert tr['ms_per_step'] > 0 and tr['data_path'] in ('native', 'pil')
    assert {'data', 'step', 'save'} <= set(tr['phase_breakdown'])
    assert {r['calls_per_step'] for r in tr['recompute_per_step'].values()} \
        == {2.0, 3.0}
    assert tr['remat']['plain']['losses'][0] == \
        tr['remat']['remat']['losses'][0]
    cases = {(c['kernel'], c['dtype']) for c in tr['grad_cases']}
    assert cases == {(k, d) for k in ('linattn_block', 'attn_block')
                     for d in ('bfloat16', 'float32')}


def test_rehearsed_mesh_phase_samples_trains_and_runs_the_cli(rehearsal):
    """The mesh phase at world 1 on the CPU (one gloo rank in the process):
    the mesh sampler gives the plain sampler's bits with the slice's
    per-forward routing, a mesh train step and its resume give one
    device's losses, first moment and parameters bit for bit, the
    ``--mesh 1,1`` CLI writes its PNG, and the ``--mesh 1,1`` daemon
    answers a request and exits 0 on SIGTERM."""
    m = rehearsal['mesh']
    assert (m['world'], m['shape']) == (1, [1, 1])
    assert m['bit_equal'] and m['max_abs_diff'] == 0.0
    assert m['checks']['sample_bit_equal_to_plain']
    assert (m['per_forward']['linattn_block'],
            m['per_forward']['attn_block']) == (2, 3)
    assert m['forwards'] > 0 and set(m['launches'].values()) == {0}
    assert m['ms_per_step_plain'] > 0 and m['ms_per_step_mesh'] > 0
    assert m['train_losses_bit_equal'] and m['train_params_bit_equal']
    assert len(m['train_losses']['mesh']) == 2
    first = m['train']['bfloat16']
    assert (first['mu_rel_l2'], first['param_max_abs'],
            first['param_bf16_casts_changed']) == (0.0, 0.0, 0)
    assert all(v for k, v in m['checks'].items() if k.startswith('train_'))
    assert m['checks']['cli_exit'] and m['checks']['cli_png']
    assert all(m['checks'][k] for k in ('serve_health_mesh', 'serve_png',
                                        'serve_exit'))


def test_rehearsed_quality_phase_probes_evaluates_captures_and_loads_a_pth(
        rehearsal):
    """The quality phase on the CPU: the probe's five modes on the
    flagship geometry at dim 16 (a 40-px canvas of 32-px tiles, 4 steps:
    6 forwards a mode, 3 of them on the cache under dc2.2; the bf16 and
    float32 nets route 6 / 3 a forward, the w8a8 nets every conv to
    int8_conv, which quantize_act feeds and, dynamic only, act_amax), its
    lines parsed; the evidence eval's three tables from a trainer
    checkpoint; both captures in every family, bit-equal to a run without
    them; the dim-16 flagship .pth with every key, through the CLI, and
    the same PNG in this process. The plain versions launch nothing."""
    q = rehearsal['quality']
    assert q['ok'], {k: {c: v for c, v in q[k]['checks'].items() if not v}
                     for k in ('probe', 'evidence', 'captures', 'pth')}
    assert set(q) >= {'probe', 'evidence', 'captures', 'pth', 'launches',
                      'seconds'}
    modes = q['probe']['modes']
    assert list(modes) == ['float32', 'bfloat16', 'w8a8dyn', 'w8a8',
                           'bfloat16+dc2.2']
    assert all(m['forwards'] == 6 for m in modes.values())
    assert [m['cached_forwards'] for m in modes.values()] == [0, 0, 0, 0, 3]
    for name in ('float32', 'bfloat16', 'bfloat16+dc2.2'):
        assert (modes[name]['per_forward']['linattn_block'],
                modes[name]['per_forward']['attn_block']) == (6, 3)
    dyn, cal = modes['w8a8dyn']['per_forward'], modes['w8a8']['per_forward']
    assert dyn['int8_conv'] == dyn['quantize_act'] == dyn['act_amax'] > 0
    assert cal['int8_conv'] == dyn['int8_conv'] and cal['act_amax'] == 0
    assert dyn['linattn_block'] == 0 and dyn['linear_attention_qkv'] == 6
    assert all('psnr' in m for name, m in modes.items() if name != 'float32')
    ev = q['evidence']['tables']
    assert (len(ev['per_class']), len(ev['ladder']), len(ev['cfg'])) == (
        3, 4, 9)
    runs = q['captures']['runs']
    assert set(runs) == {'slice', 'gaussian_ddim_tiled',
                         'elucidated_heun_tiled', 'elucidated_dpmpp',
                         'continuous_learned_tiled'}
    assert all(r['bit_equal'] and r['frame_bytes'] > 0 for r in runs.values())
    assert runs['gaussian_ddim_tiled']['frame_shape'][0] == 1 + 4 - 1
    pth = q['pth']
    assert (pth['missing'], pth['unexpected'], pth['max_abs_png_diff']) == (
        0, 0, 0)
    assert pth['keys'] == 280 and pth['cli_seconds'] > 0
    assert set(q['launches'].values()) == {0}
    # the summary counts the phase among the main paths
    import chip_smoke
    assert 'quality' in chip_smoke.MAIN_PATHS


def test_rehearsed_convert_phase_converts_both_ways(rehearsal):
    """The convert phase on the CPU at dim 16: the flagship-geometry .pth
    converted forward to a float32 and a bfloat16 directory holding its
    weights (bfloat16 rounded once), the CLI giving the .pth's PNG from the
    float32 directory and the bfloat16 .pth run's from the bfloat16 one; a
    2-step trainer directory exported with --reverse to float32 ``model.``
    entries equal to its EMA weights, the same PNG from both; every forward
    routed as its net says, and the phase counted among the main paths.
    The plain versions launch nothing."""
    c = rehearsal['convert']
    assert c['ok'], {k: v for k, v in c['checks'].items() if not v}
    assert set(c['checks']) >= {
        'dir_float32_weights', 'dir_bfloat16_weights', 'reverse_keys',
        'reverse_float32_bits', 'dir_float32_png_equal',
        'dir_bfloat16_png_equal', 'trained_dir_png_equal', 'forwards_route'}
    assert c['pth']['keys'] == 280 and c['pth']['bytes'] > 0
    assert c['exported_bytes'] > 0
    assert set(c['seconds']) >= {
        'write_pth', 'forward_float32', 'forward_bfloat16', 'cli_pth',
        'cli_dir_float32', 'cli_pth_bf16', 'cli_dir_bfloat16', 'train',
        'reverse', 'cli_trained_dir', 'cli_exported_pth', 'phase'}
    assert len(c['nets']) == 6 and all(n['forwards'] == 2 for n in c['nets'])
    assert all((n['per_forward']['linattn_block'],
                n['per_forward']['attn_block']) == (6, 3) for n in c['nets'])
    assert set(c['launches'].values()) == {0}
    import chip_smoke
    assert 'convert' in chip_smoke.MAIN_PATHS


def test_train_on_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """``--device cuda`` (the default) with no card raises before any
    work: no CPU fallback."""
    from srgd_tpu_torch.train import loop
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = loop.parse_args(['-c', os.path.join(REPO, 'conf',
                                               'trained_evidence_dim128_synth.yaml')])
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        loop.main(['-c', os.path.join(REPO, 'conf',
                                      'trained_evidence_dim128_synth.yaml'),
                   '--data_dir', str(tmp_path), '--out_dir',
                   str(tmp_path / 'run'), '--steps', '1'])
    assert not (tmp_path / 'run').exists()


def test_server_on_cuda_without_a_card_raises(monkeypatch):
    """``--device cuda`` (the default) with no card raises: no CPU
    fallback."""
    from srgd_tpu_torch import serve
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = serve.parse_args(['-c', os.path.join(REPO, 'conf', _yaml_cases()[0]),
                             '-m', '', '--mode', 'http'])
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.Server(args)


def test_rehearsed_summary_lists_six_kernels_with_every_key(rehearsal):
    """The six TPU kernels' ports, ``int8_conv``, which replaces the XLA
    int8 conv of QuantConv, and ``act_amax`` and ``quantize_act``, which
    replace its activation quantize, each with every key of the summary
    line."""
    ks = rehearsal['summary']['kernels']
    assert [k['name'] for k in ks] == [
        'linattn_block', 'attn_block', 'groupnorm_silu', 'attention',
        'linear_attention', 'linear_attention_qkv', 'int8_conv', 'act_amax',
        'quantize_act']
    keys = {'name', 'route', 'source', 'replaces', 'launches',
            'drive_launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms'}
    # the JAX line each replaces: a Pallas kernel's def, or QuantConv's
    # XLA conv, amax and quantize
    xla = {'int8_conv': 'lax.conv_general_dilated(',
           'act_amax': 'jnp.max(jnp.abs(xf))',
           'quantize_act': 'jnp.clip(jnp.round(xf / x_div)'}
    for k in ks:
        assert keys <= set(k), k
        assert k['route'] == 'cuda' and k['bound_by'] in ('bytes', 'operations')
        assert os.path.exists(os.path.join(REPO, k['source']))
        path, line = k['replaces'].split(':')
        with open(os.path.join(REPO, path)) as fp:
            text = fp.readlines()[int(line) - 1]
        assert ((xla[k['name']] in text) if k['name'] in xla
                else text.startswith('def fused_'))
        assert k['bound_ms'] > 0
        # one PyTorch call computes attention (SDPA) and the amax
        # (vector_norm at ord inf)
        assert (k['library_ms'] is not None) == (
            k['name'] in ('attention', 'act_amax'))
    bench = rehearsal['bench']
    for key in ('forward_ms', 'ms_per_step'):
        assert bench[key] > 0 and bench['pallas_' + key] > 0


def test_rehearsed_kernel_cases_cover_film_and_the_cfg_batch(rehearsal):
    """Every kernel at b and at 2 b (class CFG doubles the tile batch), both
    dtypes; ``groupnorm_silu`` with a FiLM (block1) and without (block2)."""
    import chip_smoke
    cases = rehearsal['kernel_cases']
    # int8_conv's and the quantize kernels' cases are the int8 phase's, at
    # its net's shapes
    for name in (k for k in chip_smoke.KERNELS
                 if k not in ('int8_conv', 'act_amax', 'quantize_act')):
        for b in (2, 4):
            assert {c[3] for c in cases if c[0] == name and c[1] == b} == {
                'bfloat16', 'float32'}, (name, b)
    gn = [c for c in cases if c[0] == 'groupnorm_silu']
    assert {(c[1], c[2]) for c in gn} == {(2, True), (2, False), (4, True),
                                          (4, False)}
    # groupnorm_silu is called twice on the same inputs and must repeat its
    # bits; the other kernels are not asked
    assert all(c[5] is True for c in gn)
    assert all(c[5] is None for c in cases if c[0] != 'groupnorm_silu')


def test_rehearsed_int8_phase_runs_the_quantized_path(rehearsal):
    """The int8 phase on the CPU at quantize_min_channels 32 on the (16, 32)
    net: the mid blocks, the 32-wide decoder stage's blocks and upsampler
    quantized (11 convs), nothing else; int8_conv's cases cover every
    distinct shape of that forward, bit for bit; both int8 forwards within
    0.10 of the bf16 one; the CLI calibrates once and then loads its cache;
    the daemon serves int8. The plain versions launch no kernel."""
    q = rehearsal['int8']
    assert q['ok'] and all(q['checks'].values()), q['checks']
    assert q['per_forward'] == {
        'linattn_block': 2, 'attn_block': 3, 'groupnorm_silu': 0,
        'attention': 0, 'linear_attention': 0, 'linear_attention_qkv': 0,
        'int8_conv': 11, 'act_amax': 11, 'quantize_act': 11}
    # calibrated: no QuantConv takes its amax any more
    assert q['per_forward_calibrated'] == {**q['per_forward'], 'act_amax': 0}
    cases = [c for c in q['kernel_cases'] if c['kernel'] == 'int8_conv']
    assert sum(c['calls_per_forward'] for c in cases) == 11
    assert len({(c['b'], c['n'], c['c'], c['cout'], c['ks'])
                for c in cases}) == len(cases)
    assert all(c['max_abs_err'] == 0 and c['bitwise'] and c['mma_bitwise']
               and c['accumulators_bitwise'] for c in cases)
    assert all(c['library_ms'] is None and c['bf16_conv2d_ms'] > 0
               and c['mma_ms'] > 0 and c['route'] == 'wgmma' for c in cases)
    ragged = q['ragged_int8_cases']
    assert [c['route'] for c in ragged] == ['mma', 'wgmma', 'mma', 'wgmma']
    assert all(c['bitwise'] and c['mma_bitwise'] for c in ragged)
    # the quantize kernels at each distinct activation of the forward, bit
    # for bit, dynamic, calibrated and smoothed
    for name in ('act_amax', 'quantize_act'):
        rows = [c for c in q['kernel_cases'] if c['kernel'] == name]
        assert sum(c['calls_per_forward'] for c in rows) == 11
        assert all(all(c['bitwise'].values()) and c['max_abs_err'] == 0
                   for c in rows)
        assert set(rows[0]['bitwise']) == {
            'amax', 'amax_per_channel', 'dynamic', 'calibrated', 'smoothed'}
    assert q['quantize_per_forward']['op_chain_ms'] > 0
    for name in ('dynamic', 'calibrated'):
        assert q['forwards'][name]['rel_err_vs_bf16'] < 0.10
    assert [r['calibrated'] for r in q['cli']] == [1, 1]
    assert all(r['shape'] == [1, 40, 40, 3] for r in q['cli'])
    assert q['serve']['model_info']['precision'] == 'int8'
    assert set(q['launches'].values()) == {0}


def test_chip_smoke_without_a_card_fails():
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=''),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert 'no CUDA device' in res.stderr


def test_profile_child_that_fails_fails_the_phase(monkeypatch):
    """``--profile`` runs ``phase_profile`` in a child process of
    chip_smoke.py; a child that exits non-zero (here: no card) or prints no
    profile line fails the phase, with its exit code and stderr."""
    import chip_smoke
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '')
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    monkeypatch.setattr(torch.cuda, 'empty_cache', lambda: None)
    res = chip_smoke.phase_profile_child(torch, torch.device('cpu'),
                                         timeout_s=300)
    assert res['phase'] == 'profile' and res['ok'] is False
    assert res['child_exit'] != 0 and 'no CUDA device' in res['child_stderr']


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path / 'empty'))
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setattr(_build, 'CUDA_BIN', str(tmp_path / 'cuda' / 'bin'))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_lib', None)
    with pytest.raises(RuntimeError, match='nvcc not found.*no fallback'):
        _build.load()
    assert not (tmp_path / 'build').exists()


def _port_sources():
    files = [os.path.join(REPO, f) for f in ('chip_smoke.py', 'kernel_ab.py')]
    for root, _, names in os.walk(os.path.join(REPO, 'srgd_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    """Statically: no import statement of the port or of chip_smoke.py names
    jax, jaxlib, flax or srgd_tpu (srgd_tpu_torch is another top-level name),
    nor the JAX package's scripts, tools/ and __graft_entry__ (the port's
    evaluation tools have their own copies of what they need)."""
    banned = {'jax', 'jaxlib', 'flax', 'srgd_tpu', 'tools', '__graft_entry__'}
    files = _port_sources()
    assert len(files) > 15
    # the mesh package and the evaluation tools too
    assert os.path.join(REPO, 'srgd_tpu_torch', 'parallel', 'mesh.py') in files
    assert os.path.join(REPO, 'srgd_tpu_torch', 'tools',
                        'quality_probe.py') in files
    for path in files:
        with open(path) as fp:
            tree = ast.parse(fp.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if n.split('.')[0] in banned]
            assert not bad, (path, node.lineno, bad)


def _yaml_cases():
    conf_dir = os.path.join(REPO, 'conf')
    return sorted(n for n in os.listdir(conf_dir) if n.endswith('.yaml'))


def _code_of(path: str, rename=('', '')) -> str:
    """The AST of a Python module without its docstrings, with import
    names starting ``rename[0]`` starting ``rename[1]`` instead."""
    with open(path) as fp:
        tree = ast.parse(fp.read())
    for node in ast.walk(tree):
        body = getattr(node, 'body', None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith(rename[0]):
            node.module = rename[1] + node.module[len(rename[0]):]
    return ast.dump(tree)


@pytest.mark.parametrize('case', ['defaults', 'converter', 'numeric_strings',
                                  'train_data', 'train_native_source',
                                  *_yaml_cases()])
def test_port_copies_equal_their_originals(case, tmp_path):
    """``srgd_tpu_torch/config.py``, the converter in
    ``srgd_tpu_torch/checkpoint/__init__.py``, ``train/data.py`` and
    ``train/native/degrade_native.c`` are the port's own copies: the same
    YAML through both ``load_config``s gives equal fields, a small JAX
    param tree through both converters gives equal state dicts, the data
    pipeline's code is the original's but for its docstrings and the import
    of the native helpers, and the C source is the original's, byte for
    byte."""
    import dataclasses

    import numpy as np

    from srgd_tpu import config as jconfig
    from srgd_tpu.checkpoint import torch_convert as jconvert
    from srgd_tpu_torch import checkpoint as tcheckpoint
    from srgd_tpu_torch import config as tconfig

    if case == 'train_data':
        assert _code_of(os.path.join(REPO, 'srgd_tpu_torch/train/data.py')) \
            == _code_of(os.path.join(REPO, 'srgd_tpu/train/data.py'),
                        ('srgd_tpu.train', 'srgd_tpu_torch.train'))
        return
    if case == 'train_native_source':
        name = 'train/native/degrade_native.c'
        with open(os.path.join(REPO, 'srgd_tpu_torch', name), 'rb') as a, \
                open(os.path.join(REPO, 'srgd_tpu', name), 'rb') as b:
            assert a.read() == b.read()
        return

    if case == 'converter':
        import jax
        import jax.numpy as jnp

        from srgd_tpu.nn.unet import SRUnet as JaxUnet
        assert tcheckpoint._BUFFER_KEYS.pattern == jconvert._BUFFER_KEYS.pattern
        for pixel_shuffle, classes in ((True, 3), (False, None)):
            params = JaxUnet(
                dim=8, dim_mults=(1, 2), full_attn=(False, True),
                learned_sinusoidal_cond=classes is not None,
                learned_sinusoidal_dim=8, num_classes=classes,
                pixel_shuffle_upsample=pixel_shuffle).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)),
                class_label=None if classes is None
                else jnp.zeros((1,), jnp.int32))['params']
            want = jconvert.flax_to_torch_unet_state_dict(
                params, pixel_shuffle_upsample=pixel_shuffle)
            got = tcheckpoint.flax_to_torch_unet_state_dict(
                params, pixel_shuffle_upsample=pixel_shuffle)
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            wrapped = {'model.' + k: v for k, v in want.items()}
            wrapped['betas'] = np.zeros(3)
            assert [sorted(d) for d in tcheckpoint.strip_wrapper_prefix(wrapped)] \
                == [sorted(d) for d in jconvert.strip_wrapper_prefix(wrapped)]
        return

    fields = lambda c: [(f.name, f.type, f.default)  # noqa: E731
                        for f in dataclasses.fields(c)]
    assert fields(tconfig.Config) == fields(jconfig.Config)
    if case == 'defaults':
        assert dataclasses.asdict(tconfig.Config()) == \
            dataclasses.asdict(jconfig.Config())
        with pytest.raises(TypeError):
            tconfig.Config(no_such_field=1)
        return
    if case == 'numeric_strings':
        path = tmp_path / 'c.yaml'
        path.write_text('lr: 1e-4\nepochs: "7"\nmodel: continuous\n'
                        'prefix: 1e-3\n')
    else:
        path = os.path.join(REPO, 'conf', case)
    got = tconfig.load_config(path)
    want = jconfig.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if case == 'numeric_strings':
        assert got.lr == 1e-4 and got.epochs == 7 and got.prefix == '1e-3'


def test_rehearsed_kernel_cases_hold_the_ragged_shapes(rehearsal):
    """The tensor-core kernels are also held at n that is no multiple of
    their 64-row tiles, in both dtypes, with an rms error beside the max."""
    cases = rehearsal['kernel_cases']
    for kernel, n in (('linattn_block', 70), ('attention', 70),
                      ('attention', 24), ('attn_block', 70),
                      ('attn_block', 24), ('linear_attention_qkv', 70),
                      ('linear_attention', 70)):
        assert {c[3] for c in cases if c[0] == kernel and c[4] == n} == {
            'bfloat16', 'float32'}, (kernel, n)
    for k in rehearsal['summary']['kernels']:
        assert 0 <= k['max_rms_err'] <= k['max_abs_err']


def test_rehearsed_profile_sums_each_kernel_and_times_single_calls(rehearsal):
    prof = rehearsal['profile']
    assert set(prof['nets']) == {'default', 'use_pallas', 'int8'}
    # the card's check that the int8 net quantizes in the port's kernels
    assert isinstance(prof['nets']['int8']['quantize_chain_kernels'], list)
    for net in prof['nets'].values():
        assert net['kernel_ms_per_forward'] > 0
        # the CPU runs the plain versions: no device kernel of the port
        assert net['by_kernel'] == {} and net['ms_in_float32_kernels'] == 0
        assert net['by_group']['port_kernels'] == 0
        assert abs(sum(net['by_group'].values())
                   - net['kernel_ms_per_forward']) < 1e-6
    assert set(prof['standalone_device_ms']) == {
        'linattn_block_70_32', 'attn_block_70_64', 'linear_attention_qkv_70',
        'attention_70', 'sdpa_70', 'groupnorm_silu_70_32'}
    assert all(v > 0 for v in prof['standalone_device_ms'].values())
    split = prof['standalone_by_device_kernel']
    assert set(split) == {'attn_block_70_64', 'linear_attention_qkv_70',
                          'groupnorm_silu_70_32'}
    # counted on the card; the CPU's plain versions are several ops
    assert set(prof['standalone_device_kernels_per_call']) == set(split)
    for net in prof['nets'].values():
        assert net['device_launches_per_forward'] == {}
    for name, by_fn in split.items():
        assert abs(sum(by_fn.values())
                   - prof['standalone_device_ms'][name]) < 1e-9


def test_profile_attributes_device_kernels_to_the_ports_kernels():
    import chip_smoke
    rows = [(2.0, 6, 'void (anonymous namespace)::phase_b_mma<1, 16, 8>(__nv_bfloat16 const*)'),
            (1.0, 6, 'void (anonymous namespace)::phase_a_mma<1, 16>(float*)'),
            (0.5, 6, 'void srgd::merge_kv_partials<__nv_bfloat16>(float const*)'),
            (0.3, 3, 'void (anonymous namespace)::attend<__nv_bfloat16>(int)'),
            (9.0, 40, 'void at::native::vectorized_elementwise_kernel<4>(int)')]
    got = chip_smoke._by_kernel(rows, 'linattn_block')
    assert set(got) == {'linattn_block', 'attn_block'}
    assert got['linattn_block']['ms'] == 3.5
    assert got['linattn_block']['device_kernels'] == {
        'phase_b_mma': 2.0, 'phase_a_mma': 1.0, 'merge_kv_partials': 0.5}
    assert chip_smoke._by_kernel(rows[2:3], 'linear_attention_qkv') == {
        'linear_attention_qkv': {'ms': 0.5,
                                 'device_kernels': {'merge_kv_partials': 0.5}}}


def test_kernel_ab_variants_and_shapes():
    """kernel_ab.py's variants set attributes of the kernel's wrapper
    module by JSON value, and every kernel it takes names a wrapper module
    and a shape argument of chip_smoke.phase_kernels."""
    import inspect

    import chip_smoke
    import kernel_ab
    assert kernel_ab.parse_variant('t32:TILE_BYTES=32768,L2_BYTES=0') == (
        't32', {'TILE_BYTES': 32768, 'L2_BYTES': 0})
    assert kernel_ab.parse_variant('plain:') == ('plain', {})
    params = inspect.signature(chip_smoke.phase_kernels).parameters
    for kernel, (module, arg) in kernel_ab.SHAPES.items():
        # the int8 path's kernels run at the int8 forward's shapes instead
        assert kernel in chip_smoke.KERNELS and (
            arg in params if arg else kernel in ('int8_conv', 'quantize_act'))
        assert os.path.exists(os.path.join(
            REPO, 'srgd_tpu_torch', 'kernels', module + '.py'))


def test_profile_counts_device_kernels_per_forward():
    """One ``groupnorm_silu_fused`` a Block: 38 device kernels of
    ``groupnorm_silu`` in a flagship forward; the shared merge goes to the
    kernel the net routes to; PyTorch's own kernels are not counted."""
    import chip_smoke
    rows = [(1.5, 38, 'void (anonymous namespace)::groupnorm_silu_fused<__nv_bfloat16, 8>(int)'),
            (0.3, 6, 'void (anonymous namespace)::kv_partials_mma<8>(int)'),
            (0.1, 6, 'void srgd::merge_kv_partials<__nv_bfloat16>(float const*)'),
            (9.0, 40, 'void at::native::vectorized_elementwise_kernel<4>(int)')]
    assert chip_smoke._launches_by_kernel(rows, 'linear_attention_qkv') == {
        'groupnorm_silu': 38, 'linear_attention_qkv': 12}
    assert chip_smoke.DEVICE_KERNELS['groupnorm_silu_fused'] == 'groupnorm_silu'
    assert not {'gn_stats', 'gn_fold', 'gn_apply'} & set(chip_smoke.DEVICE_KERNELS)


def test_profile_groups_every_device_kernel_once():
    import chip_smoke
    rows = [(2.0, 6, 'void (anonymous namespace)::phase_b_mma<1, 16, 2>(__nv_bfloat16 const*)'),
            (0.5, 6, 'void srgd::merge_kv_partials<__nv_bfloat16>(float const*)'),
            (3.0, 11, 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc'),
            (0.4, 4, 'nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN'),
            (13.0, 38, 'void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(long)'),
            (8.0, 38, 'void at::native::elementwise_kernel<128, 2, at::native::'
                      'gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(int)'),
            (9.0, 40, 'void at::native::vectorized_elementwise_kernel<4, silu>(int)'),
            (0.25, 1, 'void something_else(int)')]
    got = chip_smoke._by_group(rows)
    assert got == {'port_kernels': 2.5, 'convolutions': 3.0, 'gemm': 0.4,
                   'groupnorm_moments': 13.0, 'concatenations': 0.0,
                   'copies_and_casts': 8.0, 'reductions': 0.0,
                   'elementwise': 9.0, 'other': 0.25}
    assert sum(got.values()) == sum(r[0] for r in rows)


def test_profile_sessions_open_with_spin_kernels_left_out(monkeypatch):
    """On the card every profiler session opens with ``PROFILE_PAD`` spin
    kernels, which take the records the profiler drops at a session's
    start: their rows are left out, and the number dropped is counted."""
    import types

    import torch.profiler

    import chip_smoke
    from torch.autograd import DeviceType
    launched = []
    monkeypatch.setattr(torch.cuda, '_sleep', lambda n: launched.append(n))
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)

    def event(key, count, ms):
        return types.SimpleNamespace(key=key, count=count,
                                     self_device_time_total=ms * 1e3,
                                     device_type=DeviceType.CUDA)

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            # 4 of the pad's records dropped; the measured kernel whole
            return [event('spin_kernel(long)', chip_smoke.PROFILE_PAD - 4,
                          0.1),
                    event('void (anonymous namespace)::groupnorm_silu_fused'
                          '<__nv_bfloat16, 8>(int)', 5, 0.5)]
    monkeypatch.setattr(torch.profiler, 'profile', Profile)
    lost = []
    rows = chip_smoke._device_rows(torch, lambda: None, 5, True, lost)
    assert launched == [1] * chip_smoke.PROFILE_PAD and lost == [4]
    assert [chip_smoke._function(k) for _, _, k in rows] == [
        'groupnorm_silu_fused']
    assert rows[0][1] == 1.0
