"""The CUDA kernels on the card. They have no CPU mode, so every test here
is marked ``cuda`` and skips without a card. The file imports no JAX, so
it runs on a machine that has only PyTorch (``--noconftest`` skips
tests/conftest.py, which sets up JAX):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

chip_smoke.py makes the same comparison at the flagship shapes."""

import pytest
import torch

import chip_smoke
from srgd_tpu_torch.kernels import attn_block as ab
from srgd_tpu_torch.kernels import linattn_block as lb


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_kernels_match_plain_on_ragged_shapes(cuda_device, dtype):
    """n not a multiple of the tiles, c not a multiple of 128, tiny b."""
    res = chip_smoke.phase_kernels(
        torch, cuda_device, b=2, lin_shapes=((1000, 128), (256, 192)),
        attn_shapes=((1000, 512), (64, 128)), iters=1)
    cases = [c for c in res['cases'] if c['dtype'] == dtype]
    assert cases and all(c['ok'] for c in cases), cases


@pytest.mark.cuda
def test_each_call_counts_one_launch(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 64, 128, generator=g, device=cuda_device)
    ones = torch.ones(128, device=cuda_device)
    w = torch.randn(128, 128, generator=g, device=cuda_device) / 16
    before = (lb.launches, ab.launches)
    lb.linattn_block(x, ones, w, w, w, w, ones, ones, dim_head=32)
    ab.attn_block(x, ones, torch.cat([w, w, w], 1), w, ones)
    torch.cuda.synchronize()
    assert (lb.launches, ab.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_kernels_raise_on_shapes_they_do_not_take(cuda_device):
    x = torch.zeros(1, 64, 128, device=cuda_device)
    ones = torch.ones(128, device=cuda_device)
    w = torch.zeros(128, 128, device=cuda_device)
    with pytest.raises(ValueError, match='dim_head 32'):
        lb.linattn_block(x, ones, w, w, w, w, ones, ones, dim_head=16)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        lb.linattn_block(x.half(), ones, w, w, w, w, ones, ones)
    with pytest.raises(ValueError, match='dim_head 32'):
        ab.attn_block(x, ones, torch.zeros(128, 192, device=cuda_device),
                      torch.zeros(64, 128, device=cuda_device), ones,
                      heads=4, dim_head=16)
