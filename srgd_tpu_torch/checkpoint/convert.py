"""Checkpoint conversion CLI: reference ``.pth`` <-> the port's checkpoint
directory. The counterpart of ``srgd_tpu/checkpoint/convert.py``, with its
flags.

Forward (default): a reference ``.pth`` becomes a checkpoint directory of
the port, read once so that repeated runs skip the wrapper-prefix strip and
the key checks:

    python -m srgd_tpu_torch.checkpoint.convert \\
        -c conf/conditional_continuous_linear_df8kost_dim128.yaml \\
        -m model.pth -o converted_ckpt/ [--param_dtype bfloat16]

The weights are loaded as ``factory.get_model`` loads the ``.pth`` (entries
outside the U-Net logged and left out, U-Net keys the net lacks raising
under the config's ``load_strict`` and left out otherwise, a missing
parameter raising), stored in ``--param_dtype`` (default: the config's
``param_dtype``) and written by ``save_params`` as ``{'ema_params': state
dict}``: the layout of a trainer checkpoint's EMA weights, so
``load_trained_checkpoint``, the one loader of a directory, reads both.

Reverse (``--reverse``): a checkpoint directory (a trainer state, whose EMA
weights are taken as the reference saves its EMA shadow, or a
forward-converted one) becomes a reference-format ``.pth``, so that models
trained with ``srgd_tpu_torch.train.loop`` go back to the reference's torch
stack and to ``srgd_tpu``:

    python -m srgd_tpu_torch.checkpoint.convert -c conf.yaml --reverse \\
        -m trained_ckpt_dir/ -o exported.pth

The file is ``{'ema_model': state dict}`` in float32: the U-Net's tensors
under ``model.`` (``net.`` for the elucidated family), a learned log-SNR
schedule under its ``log_snr.net.*`` keys, and no schedule buffers or int8
calibration statistics, key for key what ``export_torch_state_dict`` of
``srgd_tpu/checkpoint/torch_convert.py`` writes.

Conversion is file I/O on the host: everything is loaded with
``map_location='cpu'`` and no device work is launched, in both directions.
No kernel is on this path, so the CPU is where it runs, not a fallback.
"""

from __future__ import annotations

import argparse
import logging

import torch

from srgd_tpu_torch.checkpoint import save_params
from srgd_tpu_torch.config import load_config
from srgd_tpu_torch.factory import ELUCIDATED_MODELS, get_model

logger = logging.getLogger('srgd_tpu_torch.convert')

def loaded_state_dict(conf, ckpt_path: str, param_dtype: str) -> dict:
    """The weights ``factory.get_model`` loads from ``ckpt_path`` (a
    reference ``.pth`` or a checkpoint directory) into the net of ``conf``,
    in ``param_dtype``, as the port's state dict: the U-Net's entries, and
    a learned schedule's under ``log_snr.``. The quantized convs' calibration
    statistics are not persistent, so an int8 config's entries are the
    float net's."""
    conf.param_dtype = param_dtype
    wrapper, net = get_model(conf, ckpt_path, device='cpu')
    sd = dict(net.state_dict())
    log_snr = getattr(wrapper, 'log_snr', None)
    if log_snr is not None:
        sd.update({f'log_snr.{k}': v
                   for k, v in log_snr.state_dict().items()})
    return sd


def convert(conf, ckpt_path: str, out_dir: str, param_dtype: str = '') -> dict:
    """Forward: the ``.pth`` at ``ckpt_path`` as the checkpoint directory
    ``out_dir``; returns its entries, parameters and dtype."""
    dtype = param_dtype or conf.param_dtype
    sd = loaded_state_dict(conf, ckpt_path, dtype)
    save_params(out_dir, {'ema_params': sd})
    return {'keys': len(sd), 'params': sum(v.numel() for v in sd.values()),
            'dtype': dtype}


def reference_state_dict(conf, sd: dict) -> dict:
    """The port's state dict ``sd`` as the reference's ``ema_model`` in
    float32: U-Net entries under the family's wrapper prefix, the learned
    schedule's ``log_snr.*`` entries as they are."""
    prefix = 'net.' if conf.model in ELUCIDATED_MODELS else 'model.'
    return {(k if k.startswith('log_snr.') else prefix + k):
            v.to(torch.float32) for k, v in sd.items()}


def export(conf, ckpt_path: str, out_path: str) -> dict:
    """Reverse: the checkpoint directory ``ckpt_path`` as the reference
    ``.pth`` ``out_path``; returns its keys and parameters."""
    sd = reference_state_dict(conf, loaded_state_dict(conf, ckpt_path,
                                                      'float32'))
    torch.save({'ema_model': sd}, out_path)
    return {'keys': len(sd), 'params': sum(v.numel() for v in sd.values())}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(message)s')
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('-c', '--conf', required=True, help='model config YAML')
    p.add_argument('-m', '--ckpt_path', required=True,
                   help='reference .pth (forward) / checkpoint dir (reverse)')
    p.add_argument('-o', '--out_dir', required=True,
                   help='checkpoint dir (forward) / .pth path (reverse)')
    p.add_argument('--param_dtype', default='',
                   help='float32 / bfloat16 (default: config param_dtype; '
                        'reverse always exports float32, the torch format)')
    p.add_argument('--reverse', action='store_true',
                   help='export a checkpoint dir back to the reference .pth '
                        'layout instead')
    args = p.parse_args(argv)
    conf = load_config(args.conf)
    if args.reverse:
        rec = export(conf, args.ckpt_path, args.out_dir)
        logger.info('exported %s -> %s (%.1fM params, %d torch keys)',
                    args.ckpt_path, args.out_dir, rec['params'] / 1e6,
                    rec['keys'])
        return
    rec = convert(conf, args.ckpt_path, args.out_dir, args.param_dtype)
    logger.info('converted %s -> %s (%.1fM params, dtype=%s, %d keys)',
                args.ckpt_path, args.out_dir, rec['params'] / 1e6,
                rec['dtype'], rec['keys'])


if __name__ == '__main__':
    main()
