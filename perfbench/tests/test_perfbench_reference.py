"""The frozen reference against the port's plain path (its CPU versions of
the kernels) at dim 16 and 64 px, on the benchmark's weights and noise."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.reference.sampler import tiled_sample  # noqa: E402
from perfbench.reference.unet import (  # noqa: E402
    Precision, RefUNet, param_shapes, quant_sites)
from perfbench.reference.weights import make_weights  # noqa: E402

torch.set_num_threads(1)
CFG = dict(unet_dim=16, ddpm_unet_dim_mults='1,2,4,8', learned_sinusoidal_dim=32,
           channels=3, num_classes=3, full_attn='False,False,False,True')


def port(quant_min=None, **conf_kw):
    from srgd_tpu_torch.config import Config
    from srgd_tpu_torch.factory import get_model
    conf = Config(unet_dim=16, model='conditional_continuous', **conf_kw)
    cfg = dict(CFG)
    if quant_min is not None:
        conf.quantize, conf.quantize_min_channels = 'w8a8', quant_min
        cfg['quant_min_channels'] = quant_min
    sd = make_weights(cfg, 5, 'cpu')
    wrapper, net = get_model(conf, device='cpu', state_dict=sd)
    return wrapper, net, sd, cfg


def test_parameter_names_and_count_are_the_ports():
    _, net, sd, _ = port()
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    full = dict(CFG, unet_dim=128)
    assert sum(int(np.prod(s)) for s, _ in param_shapes(full).values()) \
        == 137_569_939


def test_quant_sites_are_the_ports():
    from srgd_tpu_torch.nn.quant import quant_convs
    _, net, _, cfg = port(quant_min=32)
    assert {n for n, _ in quant_convs(net)} == quant_sites(cfg)
    full = dict(CFG, unet_dim=128, quant_min_channels=512)
    assert len(quant_sites(full)) == 25


@pytest.mark.parametrize('quant_min,tol', [(None, 1e-4), (32, 2e-2)])
def test_forward_matches_the_port(quant_min, tol):
    """float32: to rounding; W8A8: an activation code flips now and then
    where float32 drift meets a half-integer, so a looser bound."""
    _, net, sd, cfg = port(quant_min)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 64, 64, generator=g)
    c = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    t, lab = torch.tensor([-3.0, 2.0]), torch.tensor([0, 2])
    with torch.no_grad():
        a = net(x.contiguous(memory_format=torch.channels_last), t, cond=c,
                class_label=lab)
        b = RefUNet(cfg, sd)(x, t, c, lab)
    assert (a - b).abs().max().item() <= tol * b.abs().max().item()


def test_controls_round_below_the_reference():
    _, _, sd, cfg = port(quant_min=32)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 64, 64, generator=g)
    args = (x, torch.tensor([0.5]), x * 0.3, torch.tensor([1]))
    with torch.no_grad():
        ref = RefUNet(cfg, sd)(*args)
        gaps = [float((RefUNet(cfg, sd, p)(*args) - ref).abs().max())
                for p in (Precision('fp8'), Precision('float32', 7))]
    assert all(gap > 1e-3 for gap in gaps)


@pytest.mark.parametrize('sampler,eta,start,hw', [
    ('ancestral', 0.0, 6, (96, 80)), ('ddim', 1.0, 0, (32, 32))])
def test_tiled_sample_matches_the_port(sampler, eta, start, hw):
    """Alternating grid with a margin (96x80 at tile 32) and a single tile;
    the benchmark's noise source on both sides."""
    wrapper, _, sd, cfg = port(continuous_sampler=sampler, ddim_eta=eta)
    img = torch.from_numpy(harness.photo(9, *hw)).float()[None] / 255
    img = torch.cat([img, img.flip(1)])
    lab = torch.tensor([0, 2])
    a = wrapper.tiled_sample(img, lab, batch_size=8, tile_size=32,
                             num_sample_steps=10,
                             generation_start_steps=start,
                             noise=harness.SeededNoise(7, 'cpu'))
    ref = RefUNet(cfg, sd)
    b = tiled_sample(ref, img, lab, harness.SeededNoise(7, 'cpu'),
                     n_steps=10, start=start, tile=32, sampler=sampler,
                     eta=eta)
    assert (a - b).abs().max().item() < 1e-4


def test_inputs_are_the_clis():
    """The reference's bicubic and bucket pad give the port's bits."""
    from PIL import Image
    from srgd_tpu_torch.infer import upscale_bicubic
    from srgd_tpu_torch.serve import bucket_pad
    from perfbench.reference import inputs
    lr = harness.photo(3, 52, 60)
    padded, _ = bucket_pad(Image.fromarray(lr), 64)
    mine = inputs.bucket_pad(lr, 64)
    assert np.array_equal(np.asarray(padded), mine)
    a = np.asarray(upscale_bicubic(padded), np.float32) / 255.0
    assert np.array_equal(a, inputs.upscale(mine))
