"""BENCHMARK.json against the files it names, and the rule that a cell, a
configuration or a per-layer metric is added by adding files only."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


@pytest.fixture(scope='module')
def spec():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def test_top_level_keys_and_limits(spec):
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert spec['command'] == ['python3', 'perfbench/run.py']
    assert spec['paths'] == ['perfbench']
    assert 1 <= spec['run_seconds'] <= 51
    runs = 2 + 14 * 24
    assert runs * (spec['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    fours = sum(w['chips'] == 4 for w in spec['workloads'])
    assert fours <= max(1, len(spec['workloads']) // 4)


def test_names_units_and_entries(spec):
    names = [c['name'] for c in spec['configs']]
    names += [w['name'] for w in spec['workloads']]
    names += [m['name'] for m in spec['end_to_end'] + spec['per_layer']]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in spec['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('perfbench/') and (ROOT / c['file']).is_file()
    for m in spec['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in spec['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert UNIT.match(m['unit'])
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


def test_every_cell_resolves_to_its_files(spec):
    e2e = {m['name']: m for m in spec['end_to_end']}
    for w in spec['workloads']:
        cell = harness.cell(w['name'])
        assert cell['config'] == w['config']
        assert cell['traffic'] == w['traffic']
        assert cell['chips'] == w['chips'] and cell['why'] == w['why']
        tr = harness.traffic(w['traffic'])
        harness.driver(tr['driver'])
        assert cell['limits']
        # setup_s, another end-to-end metric and a per-layer one
        own = harness.cell_metrics(w['name'], False, spec)
        assert 'setup_s' in {m['name'] for m in own} and len(own) >= 2
        layer = harness.cell_metrics(w['name'], True, spec)
        assert layer
        for m in layer:
            harness.metric_reader(m['name'])
            moved = e2e[m['moves']]
            assert 'workloads' not in moved or w['name'] in moved['workloads']


def test_the_serve_cell_reads_the_daemons_waits(spec):
    per_layer = {m['name']: m for m in spec['per_layer']}
    for name in ('queue_wait_ms.serve', 'coalesce_wait_ms.serve'):
        m = per_layer[name]
        assert (m['source'], m['moves'], m['workloads'], m['layer']) == (
            'program_span', 'request_p50_ms', ['serve-lr64-w8a8'],
            'serving daemon')
        assert harness.metric_reader(name).read(harness.Record()) is None


def test_the_serve_cells_p90_is_read_per_layer(spec):
    own = harness.cell_metrics('serve-lr64-w8a8', False, spec)
    assert {m['name'] for m in own} == {'request_p50_ms', 'setup_s'}
    m = {m['name']: m for m in spec['per_layer']}['request_p90_ms.serve']
    assert (m['source'], m['moves'], m['workloads']) == (
        'host_clock', 'request_p50_ms', ['serve-lr64-w8a8'])
    r = harness.Record()
    assert harness.metric_reader(m['name']).read(r) is None
    r.counters['request_p90_ms'] = 1700.0
    assert harness.metric_reader(m['name']).read(r) == 1700.0


def test_configuration_files_state_what_they_run(spec):
    for c in spec['configs']:
        data = json.loads((ROOT / c['file']).read_text())
        assert data['reduced'] == c['reduced'] == []
        assert data['precision'] in ('bf16', 'int8')
        for k in ('unet_dim', 'ddpm_unet_dim_mults', 'learned_sinusoidal_dim'):
            assert data['yaml'][k] == data['reference'][k]


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    """A new cell, traffic mix and metric reader in a copy of the harness:
    found by name, with no file of the harness edited."""
    shutil.copytree(ROOT / 'perfbench', tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    pb = tmp_path / 'perfbench'
    (pb / 'traffic' / 'offline-1k.json').write_text(json.dumps(
        dict(json.loads((pb / 'traffic' / 'offline-2k.json').read_text()),
             lr_size=[256, 256])))
    (pb / 'cells' / 'offline-1k-ancestral.json').write_text(json.dumps({
        'config': 'srgd-dim128-bf16', 'traffic': 'offline-1k', 'chips': 1,
        'why': 'a smaller photo', 'limits': {'rms_gap': 1.0,
                                             'max_gap': 1.0}}))
    (pb / 'metrics' / 'steps.offline.py').write_text(
        'def read(record):\n    return record.counters.get("steps")\n')
    code = (
        'import sys; sys.path.insert(0, sys.argv[1])\n'
        'from perfbench import harness\n'
        'from perfbench.run import load_cell\n'
        'c = load_cell("offline-1k-ancestral")\n'
        'r = harness.Record(); r.count("steps", 7)\n'
        'print(c["traffic_data"]["lr_size"], c["config_data"]["precision"],'
        ' harness.metric_reader("steps.offline").read(r))\n')
    out = subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ['[256,', '256]', 'bf16', '7']
