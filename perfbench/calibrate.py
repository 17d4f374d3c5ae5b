"""Readings for the limits of a cell's check: the program's numbers over
many seeds, and the control's (the reference at the next precision down in
the program's place) over some of them, each against the float32 reference
at the cell's own size, on the card. Not part of a benchmark run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3] [--fault NAME]

Prints one JSON line per seed, each control reading with the harness's own
verdict on it (``run.judge`` against the cell's limits, the control's
numbers in place of the program's), and a summary: the largest program
reading and the smallest control reading of each number. Exits 1 when a
control comes out correct, 3 without a CUDA device."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:] = [p for p in sys.path
               if Path(p or '.').resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_verdict(cell: dict, reading: dict) -> dict:
    """The harness's verdict on a run whose numbers are the control's where
    it has one and the program's elsewhere: ``{'correct': bool,
    'checks': {name: {value, limit}}}``."""
    from perfbench.run import judge
    numbers = {k: v for k, v in reading['program'].items()
               if k in cell['limits']}
    numbers.update({k: v for k, v in reading['control'].items()
                    if k in cell['limits']})
    correct, checks = judge(numbers, cell['limits'])
    return {'correct': correct, 'checks': checks}


def main(argv=None):
    from perfbench import harness
    from perfbench.run import load_cell
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[0])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--fault', default=None)
    p.add_argument('--sweep', type=float, nargs='*', default=[],
                   help='rates to offer a daemon cell, each for '
                        '--sweep-seconds, on one set-up, before the seeds')
    p.add_argument('--sweep-seconds', type=float, default=30.0)
    args = p.parse_args(argv)
    harness.set_cache_env()
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print('perfbench: no CUDA device: the readings are taken on the card',
              file=sys.stderr)
        sys.exit(3)
    drv = harness.driver(cell['traffic_data']['driver'])
    if args.sweep:
        drv.sweep(cell, {'seed': args.seeds[0], 'device': 'cuda'},
                  args.sweep, args.sweep_seconds)
    prog, ctrl, passed = {}, {}, []
    for seed in args.seeds if not args.sweep else []:
        t0 = time.perf_counter()
        r = drv.readings(cell, {'seed': seed, 'device': 'cuda',
                                'fault': args.fault},
                         control=seed in args.control_seeds)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        if 'control' in r:
            r['control_verdict'] = control_verdict(cell, r)
            if r['control_verdict']['correct']:
                passed.append(seed)
        print(json.dumps(r), flush=True)
        for k, v in r['program'].items():
            prog[k] = max(prog.get(k, 0.0), v)
        for k, v in r.get('control', {}).items():
            ctrl[k] = min(ctrl.get(k, float('inf')), v)
    print(json.dumps({'workload': args.workload, 'fault': args.fault,
                      'program_max': prog, 'control_min': ctrl,
                      'control_correct_on_seeds': passed}))
    if passed:
        sys.exit(1)


if __name__ == '__main__':
    main()
