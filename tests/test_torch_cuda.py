"""The CUDA kernels on the card. They have no CPU mode, so every test here
is marked ``cuda`` and skips without a card. The file imports no JAX, so
it runs on a machine that has only PyTorch (``--noconftest`` skips
tests/conftest.py, which sets up JAX):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

chip_smoke.py makes the same comparison at the flagship shapes."""

import pytest
import torch

import chip_smoke
from srgd_tpu_torch.kernels import attention as at
from srgd_tpu_torch.kernels import attn_block as ab
from srgd_tpu_torch.kernels import groupnorm_silu as gs
from srgd_tpu_torch.kernels import linattn_block as lb
from srgd_tpu_torch.kernels import linear_attention as la


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
        attn_shapes=((1000, 512), (64, 128)), gn_shapes=((1000, 24), (63, 1024)),
        linear_shapes=(1000, 31), flash_shapes=(1000, 50), iters=1)
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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_groupnorm_silu_scalar_path_and_no_film(cuda_device, dtype):
    """c = 18 (no 16-byte vectors) and a misaligned base pointer both take
    the one-element path; film=None skips the FiLM."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for c, groups, offset in ((18, 6, 0), (32, 8, 1)):
        flat = torch.randn(offset + 3 * 50 * c, generator=g,
                           device=cuda_device).to(dtype)
        x = flat[offset:].view(3, 50, c)
        assert x.is_contiguous() and (offset == 0 or x.data_ptr() % 16)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=g, device=cuda_device)
        got = gs.groupnorm_silu(x, gamma, beta, groups=groups)
        want = gs.groupnorm_silu_plain(x, gamma, beta, groups=groups)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_each_new_wrapper_counts_one_launch(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 64, 128, generator=g, device=cuda_device)
    ones = torch.ones(128, device=cuda_device)
    qkv = torch.randn(2, 64, 384, generator=g, device=cuda_device)
    q4 = torch.randn(2, 4, 64, 32, generator=g, device=cuda_device)
    chip_smoke.reset_counts()
    gs.groupnorm_silu(x, ones, ones)
    assert chip_smoke.read_counts()['groupnorm_silu'] == 1
    at.attention(q4, q4, q4)
    la.linear_attention_qkv(qkv)
    la.linear_attention(x, x, x)
    torch.cuda.synchronize()
    assert chip_smoke.read_counts() == {
        'linattn_block': 0, 'attn_block': 0, 'groupnorm_silu': 1,
        'attention': 1, 'linear_attention': 1, 'linear_attention_qkv': 1}


@pytest.mark.cuda
def test_linear_attention_entries_agree_bitwise(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 1000, 384, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    assert torch.equal(la.linear_attention(q, k, v),
                       la.linear_attention_qkv(qkv))


@pytest.mark.cuda
def test_attention_writes_heads_merged_layout(cuda_device):
    """The output is (b, heads, n, d) laid out (b, n, heads, d), so the
    caller's merge of the heads is a view."""
    q = torch.randn(2, 4, 64, 32, device=cuda_device)
    out = at.attention(q, q, q)
    assert out.shape == q.shape
    merged = out.transpose(1, 2).reshape(2, 64, 128)
    assert merged.data_ptr() == out.data_ptr()


@pytest.mark.cuda
def test_new_kernels_raise_on_what_they_do_not_take(cuda_device):
    x = torch.zeros(2, 64, 128, device=cuda_device)
    ones = torch.ones(128, device=cuda_device)
    before = chip_smoke.read_counts()
    with pytest.raises(ValueError, match='does not copy'):
        gs.groupnorm_silu(x.transpose(1, 2), ones[:64], ones[:64])
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        gs.groupnorm_silu(x.half(), ones, ones)
    with pytest.raises(ValueError, match='divisible by groups'):
        gs.groupnorm_silu(x, ones, ones, groups=7)
    with pytest.raises(ValueError, match=r'film must be \(b, 2, c\)'):
        gs.groupnorm_silu(x, ones, ones, torch.zeros(2, 128, device=cuda_device))
    q = torch.zeros(2, 4, 64, 16, device=cuda_device)
    with pytest.raises(ValueError, match='d = 32'):
        at.attention(q, q, q)
    q = torch.zeros(2, 4, 64, 64, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match='unit channel stride'):
        at.attention(q, q, q)
    with pytest.raises(ValueError, match='contiguous q, k, v'):
        la.linear_attention(*torch.zeros(2, 64, 384, device=cuda_device)
                            .chunk(3, dim=-1))
    with pytest.raises(ValueError, match='multiple of 32 up to 128'):
        la.linear_attention_qkv(torch.zeros(2, 64, 3 * 160, device=cuda_device))
    with pytest.raises(ValueError, match='dim_head 32'):
        la.linear_attention_qkv(torch.zeros(2, 64, 384, device=cuda_device),
                                dim_head=16)
    with pytest.raises(ValueError, match='does not copy'):
        la.linear_attention_qkv(
            torch.zeros(2, 64, 768, device=cuda_device)[..., :384])
    assert chip_smoke.read_counts() == before


@pytest.mark.cuda
def test_flagged_net_runs_on_the_card(cuda_device):
    """A small flagged net on the card: every Block's conv output is
    channels-last (groupnorm_silu raises otherwise) and the result tracks
    the default net's."""
    res = chip_smoke.phase_slice_pallas(
        torch, cuda_device, size=320, tile_size=256, steps=2, batch_size=4,
        dim=32, dim_mults=(1, 2), full_attn=(False, True))
    assert res['ok'], res
    assert res['launches']['groupnorm_silu'] == 22 * res['forwards']


@pytest.mark.cuda
@pytest.mark.parametrize('hw', [16, 24, 5])
def test_flagged_linear_attention_launches_at_any_n(cuda_device, hw):
    """n = 576 and n = 25 are no multiples of 256: the module still goes
    through the kernel, once, and agrees with the plain version."""
    from srgd_tpu_torch.nn.layers import LinearAttention
    mod = LinearAttention(64, dtype=torch.bfloat16, device=cuda_device,
                          use_pallas=True)
    g = torch.Generator(device=cuda_device).manual_seed(hw)
    x = torch.randn(2, 64, hw, hw, generator=g, device=cuda_device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    chip_smoke.reset_counts()
    with torch.inference_mode():
        got = mod(x)
    counts = chip_smoke.read_counts()
    assert counts.pop('linear_attention_qkv') == 1 and not any(counts.values())
    with torch.inference_mode():
        want = mod.cpu()(x.cpu())
    err = (got.float().cpu() - want.float()).abs().max().item()
    assert err <= chip_smoke.BF16_RTOL * want.float().abs().max().item()
