#!/usr/bin/env python3
"""Time one of the port's kernels against itself in another checkout, or
against variants of its own plan, on one NVIDIA GPU, in turns.

    python3 kernel_ab.py --kernel groupnorm_silu --other build/parent \\
        [--variant NAME:ATTR=VALUE[,ATTR=VALUE...]] [--iters 10] \\
        [--out chiprun_out/kernel_ab.json]

``--other`` is the root of another checkout of the repository (for example
a ``git archive`` of the parent commit unpacked under ``build/``, which is
gitignored). A variant is this checkout with attributes of the kernel's
wrapper module set before the first call (for example
``small:TILE_BYTES=32768,BLOCKS_PER_SM=2``). The runs go in the order
other, this, variants, then the same list reversed, each in a process of its
own whose ``srgd_tpu_torch`` is that checkout's, and each runs this
checkout's ``chip_smoke.phase_kernels`` at the flagship shapes of the
kernel alone (kernel against plain version, CUDA-event times with the L2
flushed before every call, the bound). Prints the card's name and power
limit and one JSON line per run, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel -> (wrapper module, the phase_kernels shape argument that holds it)
SHAPES = {
    'groupnorm_silu': ('groupnorm_silu', 'gn_shapes'),
    'linattn_block': ('linattn_block', 'lin_shapes'),
    'attn_block': ('attn_block', 'attn_shapes'),
    'attention': ('attention', 'flash_shapes'),
    'linear_attention_qkv': ('linear_attention', 'linear_shapes'),
}

_RUN = r"""
import importlib, importlib.util, json, sys
import torch
smoke_path, kernel, module, arg, sets, iters = sys.argv[1:7]
spec = importlib.util.spec_from_file_location('chip_smoke_ab', smoke_path)
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
mod = importlib.import_module('srgd_tpu_torch.kernels.' + module)
for attr, value in json.loads(sets).items():
    setattr(mod, attr, value)
device = torch.device('cuda', 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
shapes = dict.fromkeys(('lin_shapes', 'attn_shapes', 'gn_shapes',
                        'linear_shapes', 'flash_shapes',
                        'ragged_lin_shapes', 'ragged_flash_shapes',
                        'ragged_attn_shapes', 'ragged_linear_shapes'), ())
shapes[arg] = getattr(smoke, {'gn_shapes': 'GN_SHAPES',
                              'lin_shapes': 'LINATTN_SHAPES',
                              'attn_shapes': 'ATTN_SHAPES',
                              'flash_shapes': 'FLASH_SHAPES',
                              'linear_shapes': 'LINEAR_SHAPES'}[arg])
res = smoke.phase_kernels(torch, device, iters=int(iters), **shapes)
cases = [c for c in res['cases'] if c['kernel'] == kernel]
print(json.dumps({'ok': all(c['ok'] for c in cases), 'cases': cases}))
"""


def parse_variant(text: str) -> tuple[str, dict]:
    name, _, body = text.partition(':')
    sets = {}
    for item in filter(None, body.split(',')):
        attr, _, value = item.partition('=')
        sets[attr] = json.loads(value)
    return name, sets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--kernel', default='groupnorm_silu', choices=SHAPES)
    ap.add_argument('--other', help='root of another checkout')
    ap.add_argument('--variant', action='append', default=[])
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--out', default=os.path.join(REPO, 'chiprun_out',
                                                  'kernel_ab.json'))
    args = ap.parse_args()
    module, arg = SHAPES[args.kernel]
    runs = ([('other', os.path.abspath(args.other), {})] if args.other else [])
    runs.append(('this', REPO, {}))
    runs += [(name, REPO, sets) for name, sets in map(parse_variant, args.variant)]
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results, ok = [], True
    for turn, (label, root, sets) in enumerate(runs + runs[::-1]):
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, '-c', _RUN, os.path.join(REPO, 'chip_smoke.py'),
             args.kernel, module, arg, json.dumps(sets), str(args.iters)],
            cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        ok = ok and res['ok']
        row = {'turn': turn, 'run': label, 'root': root, 'sets': sets,
               'ok': res['ok'],
               'ms': {f"{c['n']}x{c['c']} b{c['b']} {c['dtype']}"
                      f"{' film' if c.get('film') else ''}": c['ms']
                      for c in res['cases']},
               'cases': res['cases']}
        results.append(row)
        print(json.dumps({k: row[k] for k in ('turn', 'run', 'sets', 'ok', 'ms')}),
              flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as fp:
        json.dump({'nvidia_smi': smi, 'kernel': args.kernel, 'runs': results},
                  fp, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
