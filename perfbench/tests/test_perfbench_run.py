"""The command without a card, in a checkout without the program, and the
check that nothing of JAX or the JAX package is imported."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.run import judge  # noqa: E402

CMD = ['perfbench/run.py', '--workload', 'offline-2k-ancestral', '--seed',
       str(2 ** 31 + 12345), '--seconds', '1', '--trace', '0']


def run_in(cwd: Path):
    return subprocess.run([sys.executable, *CMD], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={'PATH': '/usr/bin:/bin', 'HOME': str(cwd),
                               'CUDA_VISIBLE_DEVICES': ''})


def test_no_card_exits_nonzero_with_no_result():
    p = run_in(ROOT)
    assert p.returncode != 0
    assert 'no CUDA device' in p.stderr
    assert p.stdout.strip() == ''


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copytree(ROOT / 'perfbench', tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    p = run_in(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ''


def test_unknown_workload_exits_nonzero():
    p = subprocess.run([sys.executable, 'perfbench/run.py', '--workload',
                        'no-such-cell', '--seed', '1', '--seconds', '1'],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and 'no cell' in p.stderr


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            mods.add(node.module)
    return {m.split('.')[0] for m in mods}


@pytest.mark.parametrize('path', sorted(
    p for p in (ROOT / 'perfbench').rglob('*.py')
    if '__pycache__' not in p.parts), ids=lambda p: str(
        p.relative_to(ROOT)))
def test_no_jax_by_whole_top_level_name(path):
    """Nothing the benchmark runs imports jax, jaxlib, flax or srgd_tpu
    (``srgd_tpu_torch`` shares the prefix and is the program under test);
    the reference imports nothing of the program either."""
    tops = _imports(path)
    assert not tops & set(harness.FORBIDDEN), tops
    if 'reference' in path.parts:
        assert 'srgd_tpu_torch' not in tops


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(['srgd_tpu_torch', 'srgd_tpu_torch.nn',
                                      'jaxtyping', 'flax_like']) == []
    assert harness.forbidden_modules(['jax.numpy', 'srgd_tpu.nn',
                                      'srgd_tpu_torch']) == ['jax',
                                                             'srgd_tpu']


def test_judge_needs_every_number_under_its_limit():
    assert judge({'a': 1.0}, {'a': 1.0})[0]
    assert not judge({'a': 1.5}, {'a': 1.0})[0]
    assert not judge({'a': float('nan')}, {'a': 1.0})[0]
    assert not judge({'a': 0.5}, {'a': 1.0, 'b': 0.0})[0]
    assert not judge({'a': 0.5, 'b': 0.0}, {'a': 1.0})[0]
