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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_tensor_core_kernels_on_ragged_shapes_at_full_width(cuda_device, dtype):
    """chip_smoke.py's ragged cases: ``attention`` at n = 1000 and n = 24,
    ``linattn_block`` at n = 4096 + 40, c = 256, ``attn_block`` at n = 1000
    and 24, c = 512, and both linear-attention entries at n = 4096 + 40: the
    last 64-row tile of each ends in a masked tail."""
    res = chip_smoke.phase_kernels(
        torch, cuda_device, b=8, lin_shapes=(), attn_shapes=(), gn_shapes=(),
        linear_shapes=(), flash_shapes=(), iters=1)
    cases = [c for c in res['cases'] if c['dtype'] == dtype]
    assert {(c['kernel'], c['n']) for c in cases} == {
        ('attention', 1000), ('attention', 24), ('linattn_block', 4136),
        ('attn_block', 1000), ('attn_block', 24),
        ('linear_attention_qkv', 4136), ('linear_attention', 4136)}
    assert all(c['ok'] for c in cases), cases


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,heads,n', [(2, 4, 200), (16, 4, 130), (1, 64, 70)])
def test_attention_on_contiguous_operands_and_many_heads(cuda_device, dtype, b,
                                                         heads, n):
    """Plain contiguous (b, heads, n, 32) operands (not the transposed views
    of a projection), up to b x heads = 64."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    q, k, v = (torch.randn(b, heads, n, 32, generator=g,
                           device=cuda_device).to(dtype) for _ in range(3))
    assert q.is_contiguous()
    want = at.attention_plain(q, k, v).float()
    tol = (chip_smoke.BF16_RTOL * want.abs().max().item()
           if dtype == torch.bfloat16 else chip_smoke.F32_ATOL)
    out = at.attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    assert (out.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_bf16_kernels_raise_on_what_their_copies_cannot_take(cuda_device):
    """The bfloat16 kernels copy 16 bytes at a time and multiply in steps of
    16 channels: a misaligned view or a width that is no multiple of 16
    raises; nothing goes to the float32 code quietly."""
    def bf16(*shape, offset=0):
        n = offset + int(torch.tensor(shape).prod())
        flat = torch.zeros(n, device=cuda_device, dtype=torch.bfloat16)
        return flat[offset:].view(*shape)

    before = chip_smoke.read_counts()
    q = bf16(2, 4, 64, 32, offset=4)
    with pytest.raises(ValueError, match='16-byte aligned'):
        at.attention(q, q, q)
    ones = torch.ones(128, device=cuda_device)
    x, w = bf16(1, 64, 24), bf16(24, 128)
    with pytest.raises(ValueError, match='multiple of 16'):
        lb.linattn_block(x, ones[:24], w, w, w, w.t().contiguous(), ones[:24],
                         ones[:24])
    xa, wqkv, wo = bf16(1, 64, 24), bf16(24, 384), bf16(128, 24)
    with pytest.raises(ValueError, match='multiple of 16'):
        ab.attn_block(xa, ones[:24], wqkv, wo, ones[:24])
    with pytest.raises(ValueError, match='16-byte aligned'):
        ab.attn_block(bf16(1, 64, 128, offset=4), ones, bf16(128, 384),
                      bf16(128, 128), ones)
    q = bf16(2, 64, 128, offset=4)
    with pytest.raises(ValueError, match='16-byte aligned'):
        la.linear_attention(q, q, q)
    assert chip_smoke.read_counts() == before
    # the same widths in float32 are taken
    out = lb.linattn_block(x.float(), ones[:24], w.float(), w.float(),
                           w.float(), w.t().contiguous().float(), ones[:24],
                           ones[:24])
    out_a = ab.attn_block(xa.float(), ones[:24], wqkv.float(), wo.float(),
                          ones[:24])
    torch.cuda.synchronize()
    assert out.shape == x.shape and out_a.shape == xa.shape


@pytest.mark.cuda
@pytest.mark.parametrize('hidden', [32, 64, 96])
def test_linattn_block_bf16_with_fewer_heads(cuda_device, hidden):
    """hidden < 128: the packed weights are zero past hidden and the kernel
    stores no partial for the missing heads."""
    g = torch.Generator(device=cuda_device).manual_seed(hidden)
    c, n = 64, 300
    x = torch.randn(2, n, c, generator=g, device=cuda_device).bfloat16()
    ws = [(torch.randn(c, hidden, generator=g, device=cuda_device)
           / c ** 0.5).bfloat16() for _ in range(3)]
    wout = (torch.randn(hidden, c, generator=g, device=cuda_device)
            / hidden ** 0.5).bfloat16()
    g1 = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
    bout = 0.1 * torch.randn(c, generator=g, device=cuda_device)
    got = lb.linattn_block(x, g1, *ws, wout, bout, g1, dim_head=32).float()
    want = lb.linattn_block_plain(x, g1, *ws, wout, bout, g1,
                                  dim_head=32).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        chip_smoke.BF16_RTOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_redesigned_kernels_match_plain_at_full_width(cuda_device, dtype):
    """``attn_block`` at c = 512 and 1024 (n = 1024 and a ragged 1000) and
    both linear-attention entries at n = 16384 and a ragged 1000, b = 8."""
    res = chip_smoke.phase_kernels(
        torch, cuda_device, b=8, lin_shapes=(), gn_shapes=(), flash_shapes=(),
        attn_shapes=((1024, 512), (1024, 1024), (1000, 1024)),
        linear_shapes=(16384, 1000), ragged_lin_shapes=(),
        ragged_flash_shapes=(), ragged_attn_shapes=(),
        ragged_linear_shapes=(), iters=1)
    cases = [c for c in res['cases'] if c['dtype'] == dtype]
    assert len(cases) == 3 + 4 + 1 + 2, cases
    assert all(c['ok'] for c in cases), cases


@pytest.mark.cuda
def test_bf16_redesigned_kernels_count_one_launch_each(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 100, 512, generator=g, device=cuda_device).bfloat16()
    ones = torch.ones(512, device=cuda_device)
    wqkv = (torch.randn(512, 384, generator=g, device=cuda_device)
            / 512 ** 0.5).bfloat16()
    wout = (torch.randn(128, 512, generator=g, device=cuda_device)
            / 128 ** 0.5).bfloat16()
    qkv = torch.randn(2, 100, 384, generator=g, device=cuda_device).bfloat16()
    chip_smoke.reset_counts()
    ab.attn_block(x, ones, wqkv, wout, ones)
    la.linear_attention_qkv(qkv)
    torch.cuda.synchronize()
    assert chip_smoke.read_counts() == {
        'linattn_block': 0, 'attn_block': 1, 'groupnorm_silu': 0,
        'attention': 0, 'linear_attention': 0, 'linear_attention_qkv': 1}


@pytest.mark.cuda
@pytest.mark.parametrize('c', [32, 80, 208])
def test_attn_block_bf16_at_widths_under_a_column_block(cuda_device, c):
    """c = 32 (a small net's attention block), 80 and 208: the last 64-column
    block of to_out is partial; its extra columns are neither stored nor
    read from the bias."""
    g = torch.Generator(device=cuda_device).manual_seed(c)
    n = 200
    x = torch.randn(2, n, c, generator=g, device=cuda_device).bfloat16()
    wqkv = (torch.randn(c, 384, generator=g, device=cuda_device)
            / c ** 0.5).bfloat16()
    wout = (torch.randn(128, c, generator=g, device=cuda_device)
            / 128 ** 0.5).bfloat16()
    g1 = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
    bout = 0.1 * torch.randn(c, generator=g, device=cuda_device)
    got = ab.attn_block(x, g1, wqkv, wout, bout).float()
    want = ab.attn_block_plain(x, g1, wqkv, wout, bout, heads=4,
                               dim_head=32).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        chip_smoke.BF16_RTOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize('heads', [1, 2, 3])
def test_attn_block_bf16_with_fewer_heads(cuda_device, heads):
    """hidden < 128: the wrapper zero-pads q, k, v to 128 columns each
    (``pack_qkv``) and the attention runs over the first heads only."""
    g = torch.Generator(device=cuda_device).manual_seed(heads)
    c, n, hidden = 192, 300, 32 * heads
    x = torch.randn(2, n, c, generator=g, device=cuda_device).bfloat16()
    wqkv = (torch.randn(c, 3 * hidden, generator=g, device=cuda_device)
            / c ** 0.5).bfloat16()
    wout = (torch.randn(hidden, c, generator=g, device=cuda_device)
            / hidden ** 0.5).bfloat16()
    g1 = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
    bout = 0.1 * torch.randn(c, generator=g, device=cuda_device)
    got = ab.attn_block(x, g1, wqkv, wout, bout, heads=heads).float()
    want = ab.attn_block_plain(x, g1, wqkv, wout, bout, heads=heads,
                               dim_head=32).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        chip_smoke.BF16_RTOL * want.abs().max().item()
