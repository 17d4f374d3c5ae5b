"""LPIPS perceptual metric (VGG16 backbone).

Counterpart of ``srgd_tpu/utils/lpips.py``, with the same math as the
richzhang/PerceptualSimilarity reference implementation:

  scale inputs -> VGG16 conv features at relu1_2/relu2_2/relu3_3/relu4_3/
  relu5_3 -> unit-normalize channels -> squared difference -> learned 1x1
  linear heads -> spatial mean -> sum over the five layers.

The pretrained VGG16 and LPIPS linear weights are not in the repository and
cannot be fetched, so ``lpips`` takes an explicit params dict:
``{'vgg': {'conv_{b}_{i}': {'weight': OIHW, 'bias': (C,)}}, 'lin':
{'lin{k}': (C,)}}``. ``params_from_torch_state_dicts`` builds it from the
official torchvision VGG16 ``features`` and lpips ``lin`` state dicts;
``save_lpips_params``/``load_lpips_params`` keep the JAX package's ``.npz``
layout (HWIO kernels), so one file serves both packages. Requesting
best_lpips without weights raises a clear error in the trainer
(``srgd_tpu_torch/train/loop.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature config: (convs per block, width); features tapped after the
# last ReLU of each block, pre-pool.
VGG_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# torchvision ``vgg16().features`` indices of the convolutions, per block
VGG_CONV_INDICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))

# LPIPS input scaling layer constants (richzhang's ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def vgg16_features(params, x):
    """x: (B, H, W, 3) in [-1, 1], after the scaling layer. Returns the 5 tap
    feature maps, NCHW."""
    feats = []
    h = x.permute(0, 3, 1, 2)
    for bi, (n_convs, _width) in enumerate(VGG_BLOCKS):
        for ci in range(n_convs):
            p = params[f'conv_{bi}_{ci}']
            h = F.relu(F.conv2d(h, p['weight'].to(h.dtype),
                                p['bias'].to(h.dtype), padding=1))
        feats.append(h)
        if bi < len(VGG_BLOCKS) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def _unit_normalize(f, eps=1e-10):
    norm = torch.sqrt(torch.sum(torch.square(f), dim=1, keepdim=True))
    return f / (norm + eps)


def lpips(a, b, params):
    """LPIPS(VGG) distance between image batches a, b in [0, 1], NHWC.
    Returns (B,) distances (lower = more similar)."""
    shift = torch.tensor(_SHIFT, device=a.device)
    scale = torch.tensor(_SCALE, device=a.device)

    def prep(x):
        return (x * 2.0 - 1.0 - shift) / scale

    fa = vgg16_features(params['vgg'], prep(a))
    fb = vgg16_features(params['vgg'], prep(b))
    total = 0.0
    for k, (xa, xb) in enumerate(zip(fa, fb)):
        d = torch.square(_unit_normalize(xa) - _unit_normalize(xb))
        w = params['lin'][f'lin{k}'].to(d.dtype)[None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return total


def params_from_torch_state_dicts(vgg_features_state: dict,
                                  lin_state: dict) -> dict:
    """The params dict from the official state dicts: torchvision
    ``vgg16().features.state_dict()`` (keys '{idx}.weight' OIHW and
    '{idx}.bias') and ``lpips.LPIPS(net='vgg')``'s lin state dict (keys
    'lin{k}.model.1.weight' of shape (1, C, 1, 1))."""
    vgg = {}
    for bi, idxs in enumerate(VGG_CONV_INDICES):
        for ci, idx in enumerate(idxs):
            vgg[f'conv_{bi}_{ci}'] = {
                'weight': torch.as_tensor(vgg_features_state[f'{idx}.weight'],
                                          dtype=torch.float32),
                'bias': torch.as_tensor(vgg_features_state[f'{idx}.bias'],
                                        dtype=torch.float32)}
    lin = {f'lin{k}': torch.as_tensor(lin_state[f'lin{k}.model.1.weight'],
                                      dtype=torch.float32).reshape(-1)
           for k in range(len(VGG_BLOCKS))}
    return {'vgg': vgg, 'lin': lin}


def save_lpips_params(path: str, params: dict) -> None:
    """The JAX package's ``.npz`` layout: 'vgg.{conv}.kernel' HWIO,
    'vgg.{conv}.bias', 'lin.lin{k}'."""
    flat = {}
    for name, p in params['vgg'].items():
        flat[f'vgg.{name}.kernel'] = np.transpose(
            p['weight'].cpu().numpy(), (2, 3, 1, 0))
        flat[f'vgg.{name}.bias'] = p['bias'].cpu().numpy()
    for name, w in params['lin'].items():
        flat[f'lin.{name}'] = w.cpu().numpy()
    np.savez(path, **flat)


def load_lpips_params(path: str, device=None) -> dict:
    data = np.load(path)
    vgg, lin = {}, {}
    for key in data.files:
        if key.startswith('vgg.'):
            _, name, leaf = key.split('.')
            arr = data[key]
            if leaf == 'kernel':
                vgg.setdefault(name, {})['weight'] = torch.from_numpy(
                    np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1))))
            else:
                vgg.setdefault(name, {})['bias'] = torch.from_numpy(arr)
        else:
            lin[key.split('.', 1)[1]] = torch.from_numpy(data[key])
    params = {'vgg': vgg, 'lin': lin}
    return _to(params, device) if device is not None else params


def _to(params, device):
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    return params.to(device)


def random_lpips_params(gen: torch.Generator, device=None) -> dict:
    """Random-weight params with the right structure, drawn on the CPU from
    ``gen``: for tests only (the metric is meaningless without the
    pretrained weights)."""
    vgg, lin = {}, {}
    c_in = 3
    for bi, (n_convs, width) in enumerate(VGG_BLOCKS):
        for ci in range(n_convs):
            vgg[f'conv_{bi}_{ci}'] = {
                'weight': torch.randn((width, c_in, 3, 3), generator=gen)
                * 0.05,
                'bias': torch.zeros((width,))}
            c_in = width
        lin[f'lin{bi}'] = torch.abs(torch.randn((width,), generator=gen))
    params = {'vgg': vgg, 'lin': lin}
    return _to(params, device) if device is not None else params
