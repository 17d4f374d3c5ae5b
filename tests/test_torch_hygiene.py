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
bench = chip_smoke.phase_bench(torch, cpu, lr_size=10, tile_size=32,
                               batch_size=4, forward_iters=1, **net)
profile = chip_smoke.phase_profile(torch, cpu, tile_size=32, batch_size=2,
                                   forwards=1, top=3, lin_shapes=((70, 32),),
                                   attn_shapes=((70, 64),),
                                   linear_shapes=(70,), flash_shapes=(70,),
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
    'ok': [kernels['ok'], slice_['ok'], slice_pallas['ok'], bench['ok'],
           profile['ok']],
    'slice': slice_, 'slice_pallas': slice_pallas, 'bench': bench,
    'kernel_cases': [[c['kernel'], c['b'], c.get('film'), c['dtype'], c['n']]
                     for c in kernels['cases']],
    'profile': profile,
    'summary': chip_smoke.summary(kernels, slice_, slice_pallas)}))
"""

TINY_YAML = """
model: conditional_continuous
unet_dim: 16
ddpm_unet_dim_mults: '1,2'
full_attn: 'False,True'
learned_sinusoidal_dim: 8
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1', **extra)


@pytest.fixture(scope='module')
def rehearsal(tmp_path_factory):
    conf = tmp_path_factory.mktemp('hygiene') / 'tiny.yaml'
    conf.write_text(TINY_YAML)
    res = subprocess.run([sys.executable, '-c', _SLICE, str(conf)], cwd=REPO,
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
    assert rep['ok'] == [True] * 5
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
        'attention': 3, 'linear_attention': 0, 'linear_attention_qkv': 2}
    assert set(s['launches'].values()) == {0}
    assert set(s['dpmpp_launches'].values()) == {0}
    assert 0 < s['forward_rel_diff_vs_default_net'] <= 0.05
    assert 0 < s['attention_block_rel_diff_vs_default_net'] <= 0.05
    assert s['entry_pair']['drive_launches'] == 0
    assert all(s['checks'].values()), s['checks']


def test_rehearsed_summary_lists_six_kernels_with_every_key(rehearsal):
    ks = rehearsal['summary']['kernels']
    assert [k['name'] for k in ks] == [
        'linattn_block', 'attn_block', 'groupnorm_silu', 'attention',
        'linear_attention', 'linear_attention_qkv']
    keys = {'name', 'route', 'source', 'replaces', 'launches',
            'drive_launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms'}
    for k in ks:
        assert keys <= set(k), k
        assert k['route'] == 'cuda' and k['bound_by'] in ('bytes', 'operations')
        assert os.path.exists(os.path.join(REPO, k['source']))
        path, line = k['replaces'].split(':')
        with open(os.path.join(REPO, path)) as fp:
            assert fp.readlines()[int(line) - 1].startswith('def fused_')
        assert k['bound_ms'] > 0
        assert (k['library_ms'] is not None) == (k['name'] == 'attention')
    bench = rehearsal['bench']
    for key in ('forward_ms', 'ms_per_step'):
        assert bench[key] > 0 and bench['pallas_' + key] > 0


def test_rehearsed_kernel_cases_cover_film_and_the_cfg_batch(rehearsal):
    """Every kernel at b and at 2 b (class CFG doubles the tile batch), both
    dtypes; ``groupnorm_silu`` with a FiLM (block1) and without (block2)."""
    import chip_smoke
    cases = rehearsal['kernel_cases']
    for name in chip_smoke.KERNELS:
        for b in (2, 4):
            assert {c[3] for c in cases if c[0] == name and c[1] == b} == {
                'bfloat16', 'float32'}, (name, b)
    gn = [c for c in cases if c[0] == 'groupnorm_silu']
    assert {(c[1], c[2]) for c in gn} == {(2, True), (2, False), (4, True),
                                          (4, False)}


def test_chip_smoke_without_a_card_fails():
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=''),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert 'no CUDA device' in res.stderr


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
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(os.path.join(REPO, 'srgd_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    """Statically: no import statement of the port or of chip_smoke.py names
    jax, jaxlib, flax or srgd_tpu (srgd_tpu_torch is another top-level name)."""
    banned = {'jax', 'jaxlib', 'flax', 'srgd_tpu'}
    files = _port_sources()
    assert len(files) > 15
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


@pytest.mark.parametrize('case', ['defaults', 'converter', 'numeric_strings',
                                  *_yaml_cases()])
def test_port_copies_equal_their_originals(case, tmp_path):
    """``srgd_tpu_torch/config.py`` and the converter in
    ``srgd_tpu_torch/checkpoint.py`` are the port's own copies: the same
    YAML through both ``load_config``s gives equal fields, and a small JAX
    param tree through both converters gives equal state dicts."""
    import dataclasses

    import numpy as np

    from srgd_tpu import config as jconfig
    from srgd_tpu.checkpoint import torch_convert as jconvert
    from srgd_tpu_torch import checkpoint as tcheckpoint
    from srgd_tpu_torch import config as tconfig

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
    for net in prof['nets'].values():
        assert net['kernel_ms_per_forward'] > 0
        # the CPU runs the plain versions: no device kernel of the port
        assert net['by_kernel'] == {} and net['ms_in_float32_kernels'] == 0
        assert net['by_group']['port_kernels'] == 0
        assert abs(sum(net['by_group'].values())
                   - net['kernel_ms_per_forward']) < 1e-6
    assert set(prof['standalone_device_ms']) == {
        'linattn_block_70_32', 'attn_block_70_64', 'linear_attention_qkv_70',
        'attention_70', 'sdpa_70'}
    assert all(v > 0 for v in prof['standalone_device_ms'].values())
    split = prof['standalone_by_device_kernel']
    assert set(split) == {'attn_block_70_64', 'linear_attention_qkv_70'}
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
