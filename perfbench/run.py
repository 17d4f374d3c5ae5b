"""Run one benchmark cell of ``srgd_tpu_torch`` once, in this process.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is ``perfbench/cells/<cell>.json``: its configuration
(``configs/``), its traffic mix (``traffic/``, which names the driver in
``drivers/``) and the limits of its check. The run sets up and warms up,
measures for ``--seconds`` (``--trace 1``: with the traced part and spans,
reporting the per-layer metrics of BENCHMARK.json through ``metrics/``),
checks the timed path's output against the plain reference, and prints the
numbers compared beside their limits on standard error and, as its last
line on standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), then
``checks``.

It exits non-zero and prints no result when there is no CUDA device or
fewer than the cell asks for, and when JAX or the JAX package
(``srgd_tpu``) is loaded in the process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import math       # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# import the harness as the package ``perfbench`` from the checkout, never
# its files as top-level modules
sys.path[:] = [p for p in sys.path
               if Path(p or '.').resolve() != CHECKOUT / 'perfbench']
sys.path.insert(0, str(CHECKOUT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> None:
    print(f'perfbench: {msg}', file=sys.stderr)
    sys.exit(code)


def load_cell(name: str) -> dict:
    from perfbench import harness
    c = harness.cell(name)
    c['traffic_data'] = harness.traffic(c['traffic'])
    return c


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    out, ok = {}, set(checks) == set(limits)
    for name in sorted(set(checks) | set(limits)):
        v, lim = checks.get(name, math.inf), limits.get(name, -math.inf)
        out[name] = {'value': v, 'limit': lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, out


def result_line(cell: dict, outcome: dict, trace: bool) -> tuple:
    """(result dict, checks dict) of one run."""
    from perfbench import harness
    correct, checks = judge(outcome['checks'], cell['limits'])
    metrics = {}
    if trace:
        record = outcome['record']
        for m in harness.cell_metrics(cell['name'], True):
            value = harness.metric_reader(m['name']).read(record)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = dict(outcome['e2e'], setup_s=outcome['setup_s'])
        for m in harness.cell_metrics(cell['name'], False):
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    device = dict(outcome['device'] or {})
    if trace:
        device['busy_s'] = outcome['record'].busy_s
        device['window_s'] = outcome['record'].window_s
    res = {'correct': correct, 'attempted': outcome['attempted'],
           'failed': outcome['failed'], 'metrics': metrics,
           'device': device}
    if trace and outcome['record'].breakdown:
        res['breakdown'] = outcome['record'].breakdown
    res['checks'] = checks
    return res, checks


def main(argv=None) -> None:
    args = parse_args(argv)
    from perfbench import harness
    harness.set_cache_env()
    try:
        cell = load_cell(args.workload)
    except KeyError as e:
        fail(str(e), 2)
    import torch
    harness.note({'t_start': T_START}, 'torch imported')
    if not torch.cuda.is_available():
        fail('no CUDA device: the benchmark measures the port on the card',
             3)
    if torch.cuda.device_count() < cell['chips']:
        fail(f'cell {args.workload} needs {cell["chips"]} CUDA devices, '
             f'{torch.cuda.device_count()} visible', 3)
    drv = harness.driver(cell['traffic_data']['driver'])
    outcome = drv.run(cell, {'seed': args.seed, 'seconds': args.seconds,
                             'trace': bool(args.trace), 'device': 'cuda',
                             't_start': T_START})
    bad = harness.forbidden_modules()
    if bad:
        fail(f'modules of JAX or of the JAX package are loaded: {bad}', 4)
    res, checks = result_line(cell, outcome, bool(args.trace))
    print(f'correct: {res["correct"]}', file=sys.stderr)
    for name, c in checks.items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
