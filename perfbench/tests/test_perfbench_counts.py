"""The frozen counts against PERF.md's bound column (chip_smoke.py's
kernel_cases and int8_case), and the model FLOPs recounted."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.counts import formulas  # noqa: E402


def test_linattn_block_bound():
    nbytes, flops = formulas.linattn_block(8, 65536, 128)
    assert round(nbytes / 1e6, 1) == 268.6 and round(flops / 1e9, 1) == 77.3
    assert formulas.bound_s(nbytes, flops, 'bfloat16') == \
        pytest.approx(0.0802e-3, rel=2e-3)


def test_attn_block_bound():
    nbytes, flops = formulas.attn_block(8, 1024, 512)
    assert round(flops / 1e9, 2) == 8.59 and round(nbytes / 1e6, 1) == 17.3


def test_int8_conv_bound():
    nbytes, ops = formulas.int8_conv(8192, 512, 512, 3)
    assert round(ops / 1e9, 1) == 38.7 and round(nbytes / 1e6, 1) == 14.9
    assert formulas.bound_s(nbytes, ops, 'int8') == \
        pytest.approx(0.0195e-3, rel=1e-2)


def test_forward_bounds_scale_with_the_tile_batch():
    one = formulas.forward_bound_s('int8_conv', 1)
    eight = formulas.forward_bound_s('int8_conv', 8)
    assert one < eight < 8 * one
    c = formulas.unet_counts()
    assert len(c['linattn_block']) == 6 and len(c['attn_block']) == 3
    assert sum(row[-1] for row in c['int8_conv']) == 25


def test_model_flops_recounted():
    from torch.utils.flop_counter import FlopCounterMode
    from perfbench.reference.unet import RefUNet, param_shapes
    cfg = dict(unet_dim=128, ddpm_unet_dim_mults='1,2,4,8',
               learned_sinusoidal_dim=32, channels=3, num_classes=3,
               full_attn='False,False,False,True')
    sd = {k: torch.empty(s, device='meta')
          for k, (s, _) in param_shapes(cfg).items()}
    x = torch.empty(1, 3, 256, 256, device='meta')
    with FlopCounterMode(display=False) as fc:
        RefUNet(cfg, sd)(x, torch.empty(1, device='meta'), x,
                         torch.zeros(1, dtype=torch.long, device='meta'))
    assert fc.get_total_flops() == \
        formulas.unet_counts()['model_flops_per_tile']
