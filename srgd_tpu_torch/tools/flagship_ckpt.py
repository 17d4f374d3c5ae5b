"""A reference-format checkpoint at flagship width through the port: the
counterpart of ``tools/flagship_ckpt_dryrun.py``.

    python -m srgd_tpu_torch.tools.flagship_ckpt [WORKDIR] [--device cuda]
        [--dim 128 --conf conf/conditional_continuous_linear_df8kost_dim128.yaml]

1. writes a ``.pth`` as the reference's trainer saved it,
   ``torch.save({'ema_model': {'model.' + k: v}})``, of the port's
   ``SRUnet`` at the shipped geometry (dim 128, mults 1,2,4,8, full
   attention at the last stage, learned sinusoidal 32, 3 classes) with
   weights from a seed: 137,569,939 parameters, 550 MB;
2. reads it back through ``checkpoint.load_reference_checkpoint`` and
   ``factory.load_unet_state(strict=True)``: no key missing, none left over;
3. runs the CLI, ``python -m srgd_tpu_torch.infer`` with the shipped YAML
   and this ``.pth``, on one 16-px PNG (2 steps, ``--test_label 0``), which
   must come out at 64 px.

WORKDIR defaults to a new temporary directory. ``--dim`` narrows the net
(then ``--conf`` names a YAML of that width; the size checks hold at 128). The released checkpoint
cannot be fetched here; this shows that one at its width loads with every
key and samples through the CLI.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from srgd_tpu_torch.checkpoint import load_reference_checkpoint
from srgd_tpu_torch.config import load_config
from srgd_tpu_torch.factory import load_unet_state
from srgd_tpu_torch.infer import resolve_device
from srgd_tpu_torch.nn.unet import build_unet_from_config
from srgd_tpu_torch.tools.quality_probe import flagship_conf

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHIPPED_YAML = os.path.join(
    REPO, 'conf', 'conditional_continuous_linear_df8kost_dim128.yaml')
FLAGSHIP_PARAMS = 137_569_939
# the released epoch-300 file holds 550,400,570 bytes of float32 EMA weights
FLAGSHIP_BYTES = (400e6, 700e6)
CLI_ARGS = ('--num_sample_steps', '2', '--test_label', '0')


def flagship_state_dict(dim: int = 128, seed: int = 0) -> dict:
    """The reference's ``ema_model`` entries of an ``SRUnet`` at the
    flagship geometry (``quality_probe.flagship_conf``) and width ``dim``,
    weights from ``seed``."""
    net = build_unet_from_config(flagship_conf(dim))
    net.init_weights(torch.Generator().manual_seed(seed))
    return {f'model.{k}': v for k, v in net.state_dict().items()}


def write_pth(path: str, dim: int = 128, seed: int = 0) -> dict:
    """Save the flagship ``.pth``; returns its keys, parameters, bytes and
    seconds."""
    t0 = time.perf_counter()
    sd = flagship_state_dict(dim, seed)
    torch.save({'ema_model': sd}, path)
    return {'keys': len(sd), 'params': sum(v.numel() for v in sd.values()),
            'bytes': os.path.getsize(path),
            'seconds': time.perf_counter() - t0}


def load_pth(path: str, conf_path: str) -> dict:
    """Load ``path`` into the net of ``conf_path`` with ``load_strict``;
    returns the missing and unexpected keys, parameters and seconds."""
    t0 = time.perf_counter()
    sd = load_reference_checkpoint(path)
    net = build_unet_from_config(load_config(conf_path))
    want = set(net.state_dict())
    missing, unexpected = sorted(want - set(sd)), sorted(set(sd) - want)
    load_unet_state(net, sd, strict=True)
    return {'missing': missing, 'unexpected': unexpected,
            'params': sum(v.numel() for v in sd.values()),
            'seconds': time.perf_counter() - t0}


def run_cli(pth: str, conf_path: str, workdir: str, device: str) -> dict:
    """The CLI on one seeded 16-px PNG; returns the paths, the output's
    size and the seconds."""
    from PIL import Image
    in_dir = os.path.join(workdir, 'in')
    out_dir = os.path.join(workdir, 'out')
    os.makedirs(in_dir, exist_ok=True)
    image = os.path.join(in_dir, 'x.png')
    Image.fromarray((np.random.default_rng(0).random((16, 16, 3)) * 255)
                    .astype(np.uint8)).save(image)
    out_png = os.path.join(out_dir, 'x_out.png')
    if os.path.exists(out_png):
        os.remove(out_png)
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (REPO, env.get('PYTHONPATH')) if p)
    cmd = [sys.executable, '-m', 'srgd_tpu_torch.infer', '-c', conf_path,
           '-m', pth, '--input_dir', in_dir, '--output_dir', out_dir,
           *CLI_ARGS, '--device', device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f'the CLI exited {proc.returncode}:\n'
                           f'{proc.stderr[-4000:]}')
    with Image.open(out_png) as im:
        size = im.size
    return {'cmd': cmd, 'input': image, 'output': out_png, 'size': size,
            'seconds': time.perf_counter() - t0}


def run(workdir: str, *, conf_path: str = SHIPPED_YAML, device: str = 'cuda',
        dim: int = 128, seed: int = 0) -> dict:
    """Write, load and sample the ``.pth``; at dim 128 it must hold the
    flagship's parameters and bytes. Returns each step's record."""
    os.makedirs(workdir, exist_ok=True)
    pth = os.path.join(workdir, 'flagship_synth.pth')
    saved = write_pth(pth, dim, seed)
    print(f'state dict: {saved["keys"]} keys, {saved["params"]:,} params, '
          f'{saved["bytes"] / 1e6:.1f} MB on disk '
          f'({saved["seconds"]:.1f}s)', flush=True)
    if dim == 128:
        assert saved['params'] == FLAGSHIP_PARAMS, saved['params']
        lo, hi = FLAGSHIP_BYTES
        assert lo < saved['bytes'] < hi, 'not flagship-sized'
    loaded = load_pth(pth, conf_path)
    print(f'loaded: {loaded["params"]:,} params, missing='
          f'{loaded["missing"]}, unexpected={loaded["unexpected"]} '
          f'({loaded["seconds"]:.1f}s)', flush=True)
    assert not loaded['missing'] and not loaded['unexpected'], loaded
    assert loaded['params'] == saved['params']
    cli = run_cli(pth, conf_path, workdir, device)
    assert cli['size'] == (64, 64), cli['size']
    print(f'CLI end-to-end OK: 16px -> {cli["size"]} in '
          f'{cli["seconds"]:.1f}s', flush=True)
    return {'pth': pth, 'saved': saved, 'loaded': loaded, 'cli': cli}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('workdir', nargs='?', default=None)
    p.add_argument('--device', default='cuda')
    p.add_argument('--dim', type=int, default=128)
    p.add_argument('--conf', default=SHIPPED_YAML)
    args = p.parse_args(argv)
    resolve_device(args.device)        # no card for --device cuda: raise now
    workdir = args.workdir or tempfile.mkdtemp(prefix='flagship_ckpt_')
    run(workdir, conf_path=args.conf, device=args.device, dim=args.dim)
    print('FLAGSHIP DRY-RUN PASSED')


if __name__ == '__main__':
    main()
