"""The CUDA kernels on the card. They have no CPU mode, so every test here
is marked ``cuda`` and skips without a card. The file imports no JAX, so
it runs on a machine that has only PyTorch (``--noconftest`` skips
tests/conftest.py, which sets up JAX):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

chip_smoke.py makes the same comparison at the flagship shapes."""

import copy

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


# groupnorm_silu.cu's two entries: the use_pallas Block's folded arithmetic
# and the default Block's chain
GN_ENTRIES = ('groupnorm_silu', 'block_norm_silu')


@pytest.mark.cuda
@pytest.mark.parametrize('entry', GN_ENTRIES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_groupnorm_silu_scalar_path_and_no_film(cuda_device, dtype, entry):
    """c = 18 (no 16-byte vectors) and a misaligned base pointer both take
    the one-element path; film=None skips the FiLM."""
    kern, plain = getattr(gs, entry), getattr(gs, entry + '_plain')
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for c, groups, offset in ((18, 6, 0), (32, 8, 1)):
        flat = torch.randn(offset + 3 * 50 * c, generator=g,
                           device=cuda_device).to(dtype)
        x = flat[offset:].view(3, 50, c)
        assert x.is_contiguous() and (offset == 0 or x.data_ptr() % 16)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=g, device=cuda_device)
        got = kern(x, gamma, beta, groups=groups)
        want = plain(x, gamma, beta, groups=groups)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('entry', GN_ENTRIES)
@pytest.mark.parametrize('b', [1, 16])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_groupnorm_silu_ragged_rows_repeat_bitwise(cuda_device, dtype, b,
                                                   entry):
    """Rows that are no multiple of the tile, at b = 1 (one sample: the
    apply waits on the whole statistics) and b = 16: inside the kernel
    tolerances, and a second call on the same inputs gives the same bits.
    A bfloat16 FiLM is read in its own dtype and gives the bits of the same
    values in float32."""
    kern, plain = getattr(gs, entry), getattr(gs, entry + '_plain')
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for rows, c in ((4096 + 40, 256), (1000, 128), (65536 + 8, 128)):
        x = (torch.randn(b, rows, c, generator=g, device=cuda_device) * 1.5
             + 0.3).to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=g, device=cuda_device)
        film = (0.2 * torch.randn(b, 2, c, generator=g, device=cuda_device)
                ).to(torch.bfloat16)
        tile_rows, ntile, _, _ = gs._plan(b, rows, c, x.element_size(),
                                          gs._sms(cuda_device))
        assert ntile > 1 and rows % tile_rows
        got = kern(x, gamma, beta, film)
        again = kern(x, gamma, beta, film)
        f32_film = kern(x, gamma, beta, film.float())
        want = plain(x, gamma, beta, film)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, f32_film)
        ref_max = want.float().abs().max().item()
        ok, tol = chip_smoke._within(
            (got.float() - want.float()).abs().max().item(), ref_max, dtype,
            torch)
        assert ok, (rows, c, tol)


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
    gs.block_norm_silu(x, ones, ones)
    assert chip_smoke.read_counts() == {
        'linattn_block': 0, 'attn_block': 0, 'groupnorm_silu': 1,
        'block_norm_silu': 1, 'attention': 1, 'linear_attention': 1,
        'linear_attention_qkv': 1, 'int8_conv': 0, 'act_amax': 0,
        'quantize_act': 0}


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
    for kern in (gs.groupnorm_silu, gs.block_norm_silu):
        with pytest.raises(ValueError, match='does not copy'):
            kern(x.transpose(1, 2), ones[:64], ones[:64])
        with pytest.raises(TypeError, match='float32 or bfloat16'):
            kern(x.half(), ones, ones)
        with pytest.raises(ValueError, match='divisible by groups'):
            kern(x, ones, ones, groups=7)
        with pytest.raises(ValueError, match=r'film must be \(b, 2, c\)'):
            kern(x, ones, ones, torch.zeros(2, 128, device=cuda_device))
        with pytest.raises(TypeError, match='film takes float32 or bfloat16'):
            kern(x, ones, ones,
                 torch.zeros(2, 2, 128, device=cuda_device).half())
        with pytest.raises(ValueError, match='film contiguous'):
            kern(x, ones, ones, torch.zeros(
                2, 128, 2, device=cuda_device).transpose(1, 2))
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
        'block_norm_silu': 0, 'attention': 0, 'linear_attention': 0,
        'linear_attention_qkv': 1, 'int8_conv': 0, 'act_amax': 0,
        'quantize_act': 0}


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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_block_functions_give_the_plain_gradients_on_the_card(cuda_device,
                                                              dtype):
    """``linattn_block`` and ``attn_block`` on CUDA tensors: the forward is
    the kernel, the backward the plain version's VJP, equal to
    ``torch.autograd`` of the plain version (chip_smoke's train phase holds
    them at the flagship shapes)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for kind, n, c in (('linattn_block', 1000, 128), ('attn_block', 256, 512)):
        case = chip_smoke._grad_case(torch, cuda_device, kind, 2, n, c, dtype,
                                     gen)
        assert case['ok'] and case['dtypes_kept'], case


@pytest.mark.cuda
def test_backward_through_the_blocks_launches_no_kernel(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 64, 128, generator=g, device=cuda_device,
                    requires_grad=True)
    ones = torch.ones(128, device=cuda_device, requires_grad=True)
    w = (torch.randn(128, 128, generator=g, device=cuda_device) / 16) \
        .requires_grad_()
    out = lb.linattn_block(x, ones, w, w, w, w, ones, ones, dim_head=32) + \
        ab.attn_block(x, ones, torch.cat([w, w, w], 1), w, ones)
    before = (lb.launches, ab.launches)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (lb.launches, ab.launches) == before
    assert all(torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
               for t in (x, ones, w))


@pytest.mark.cuda
def test_forward_only_kernels_raise_on_backward_on_the_card(cuda_device):
    for kern in (gs.groupnorm_silu, gs.block_norm_silu):
        x = torch.randn(2, 8, 8, 64, device=cuda_device, requires_grad=True)
        out = kern(x, torch.ones(64, device=cuda_device),
                   torch.zeros(64, device=cuda_device))
        with pytest.raises(RuntimeError, match='has no gradient'):
            out.sum().backward()


@pytest.mark.cuda
def test_block_norm_silu_matches_plain_at_the_flagship_shapes(cuda_device):
    """The default Block's entry at the seven shapes of a flagship forward
    (b = 8, the largest also at 16), with and without FiLM, bf16 and f32:
    within the kernels' bounds of its plain version, and a second call
    repeats the bits."""
    res = chip_smoke.phase_kernels(
        torch, cuda_device, lin_shapes=(), attn_shapes=(), linear_shapes=(),
        flash_shapes=(), ragged_lin_shapes=(), ragged_flash_shapes=(),
        ragged_attn_shapes=(), ragged_linear_shapes=(), iters=1)
    cases = [c for c in res['cases'] if c['kernel'] == 'block_norm_silu']
    assert len(cases) == 2 * 2 * (len(chip_smoke.GN_SHAPES) + 1)
    assert all(c['ok'] and c['bitwise_repeat'] for c in cases), [
        c for c in cases if not c['ok']]


def _flagship_forward_inputs(b=2, size=64):
    g = torch.Generator(device='cuda').manual_seed(3)
    x = torch.randn(b, 3, size, size, generator=g, device='cuda')
    t = torch.rand(b, generator=g, device='cuda')
    return x, t, dict(cond=torch.rand(b, 3, size, size, generator=g,
                                      device='cuda') * 2 - 1,
                      class_label=torch.arange(b, device='cuda') % 3)


@pytest.mark.cuda
def test_block_norm_silu_launches_once_a_block_when_sampling(cuda_device):
    """The flagship net (38 Blocks): one forward with autograd recording
    nothing launches ``block_norm_silu`` 38 times and nothing of
    ``groupnorm_silu``; a training forward with autograd recording launches
    it none, and its backward runs; the two forwards agree."""
    net = chip_smoke.build_flagship(torch, cuda_device).net
    x, t, fwd = _flagship_forward_inputs()
    with torch.inference_mode():
        out, launched = chip_smoke._launched(
            torch, cuda_device, lambda: net(x, t, **fwd))
    per_forward = chip_smoke._per_forward(list(net.modules()))
    assert launched == per_forward and launched['block_norm_silu'] == 38
    assert launched['groupnorm_silu'] == 0
    trained, launched = chip_smoke._launched(
        torch, cuda_device, lambda: net(x, t, **fwd))
    assert launched == chip_smoke._per_forward(list(net.modules()),
                                               grad=True)
    assert launched['block_norm_silu'] == 0
    trained.float().square().mean().backward()
    grad = net.init_conv.weight.grad
    assert grad is not None and torch.isfinite(grad).all()
    err = (out.float() - trained.detach().float()).abs().max().item()
    assert err <= chip_smoke.BF16_RTOL * trained.detach().float().abs().max()


@pytest.mark.cuda
def test_deep_cache_forward_routes_every_block_it_runs(cuda_device):
    """A DeepCache forward at depth 2 runs the Blocks of the two shallow
    stages and the final block, each through ``block_norm_silu``."""
    net = chip_smoke.build_flagship(torch, cuda_device).net
    x, t, fwd = _flagship_forward_inputs()
    with torch.inference_mode():
        (full, cache), _ = chip_smoke._launched(
            torch, cuda_device,
            lambda: net(x, t, **fwd, cache_depth=2, return_cache=True))
        cached, launched = chip_smoke._launched(
            torch, cuda_device,
            lambda: net(x, t, **fwd, cache_depth=2, deep_cache=cache))
    want = chip_smoke._cached_per_forward(net, 2)
    assert launched == want and 0 < want['block_norm_silu'] < 38
    err = (cached.float() - full.float()).abs().max().item()
    assert err <= chip_smoke.BF16_RTOL * full.float().abs().max().item()


# ---------------------------------------------------------------------------
# int8_conv: the W8A8 convolution of QuantConv
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('out_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [
    # (b, h, w, cin, cout, ks): ragged M, Cout and K tails, a Cin under and
    # over one 16-byte piece, and a net shape
    (3, 7, 9, 40, 200, 3), (2, 5, 11, 48, 130, 1), (1, 3, 3, 3, 5, 3),
    (8, 32, 32, 512, 1024, 3)])
def test_int8_conv_bitwise_equal_to_plain(cuda_device, shape, out_dtype):
    from srgd_tpu_torch.kernels import int8_conv as ic
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    case = chip_smoke.int8_case(torch, cuda_device, shape, g)
    assert torch.equal(case['acc'](), case['acc_plain']())
    b, h, w, cin, cout, ks = shape
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=g,
                       device=cuda_device, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, ks, ks, cin), generator=g,
                       device=cuda_device, dtype=torch.int8)
    scale = torch.rand(cout, generator=g, device=cuda_device) * 1e-3
    bias = torch.randn(cout, generator=g, device=cuda_device)
    for bb in (bias, None):
        kw = dict(padding=ks // 2, out_dtype=out_dtype)
        before = ic.launches
        got = ic.int8_conv(xq, wq, scale, bb, **kw)
        assert ic.launches == before + 1
        assert torch.equal(got, ic.int8_conv_plain(xq, wq, scale, bb, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize('alpha', [0.0, 0.5])
def test_quantconv_kernel_route_equals_plain_route(cuda_device, alpha):
    """One QuantConv on the same input: the card's route (the kernel) and the
    plain route (int8_conv_plain on the card's own codes) give the same
    bits."""
    from srgd_tpu_torch.kernels import int8_conv as ic
    from srgd_tpu_torch.nn.quant import QuantConv
    torch.manual_seed(0)
    m = QuantConv(96, 160, 3, padding=1, smooth_alpha=alpha,
                  dtype=torch.bfloat16, device=cuda_device)
    x = torch.randn(4, 96, 20, 12, device=cuda_device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        before = ic.launches
        got = m(x)
        assert ic.launches == before + 1
        xq, wq, scale = m.quantize(x)
        want = ic.int8_conv_plain(xq, wq, scale.contiguous(), m.bias.float(),
                                  padding=1, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.permute(0, 2, 3, 1), want)


@pytest.mark.cuda
def test_int8_conv_raises_on_what_it_does_not_take(cuda_device):
    from srgd_tpu_torch.kernels import int8_conv as ic
    xq = torch.zeros(1, 4, 4, 32, dtype=torch.int8, device=cuda_device)
    wq = torch.zeros(8, 3, 3, 32, dtype=torch.int8, device=cuda_device)
    scale = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match='contiguous'):
        ic.int8_conv(xq.permute(0, 2, 1, 3), wq, scale, padding=1)
    with pytest.raises(ValueError, match='one device'):
        ic.int8_conv(xq, wq, scale.cpu(), padding=1)


# ---------------------------------------------------------------------------
# int8_conv's Hopper kernel and the activation quantize kernels
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('shape, calls', chip_smoke.INT8_NET_SHAPES)
def test_int8_conv_wgmma_bitwise_at_the_net_shapes(cuda_device, shape, calls):
    """The 12 shapes of an int8 forward take the Hopper kernel, whose output
    and accumulators equal the plain version's bit for bit."""
    from srgd_tpu_torch.kernels import int8_conv as ic
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    case = chip_smoke.int8_case(torch, cuda_device, shape, g)
    assert case['route'] == 'wgmma' and calls > 0
    before = ic.launches_wgmma
    assert torch.equal(case['kern'](), case['plain']())
    assert torch.equal(case['acc'](), case['acc_plain']())
    assert ic.launches_wgmma == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize('shape', chip_smoke.RAGGED_INT8_SHAPES)
def test_int8_conv_both_kernels_bitwise_at_ragged_shapes(cuda_device, shape):
    """The first (mma.sync) kernel at ragged widths, and whichever kernel
    the route picks, equal the plain version bit for bit; a width no
    multiple of 16 takes the first kernel."""
    from srgd_tpu_torch.kernels import int8_conv as ic
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    case = chip_smoke.int8_case(torch, cuda_device, shape, g)
    assert case['route'] == ('wgmma' if shape[3] % 16 == 0 else 'mma')
    before = ic.launches_mma
    want = case['plain']()
    assert torch.equal(case['mma'](), want)
    assert torch.equal(case['acc_mma'](), case['acc_plain']())
    assert ic.launches_mma == before + 2
    assert torch.equal(case['kern'](), want)
    assert torch.equal(case['acc'](), case['acc_plain']())


@pytest.mark.cuda
def test_int8_conv_wgmma_raises_on_what_it_does_not_take(cuda_device):
    from srgd_tpu_torch.kernels import int8_conv as ic
    xq = torch.zeros(1, 4, 4, 24, dtype=torch.int8, device=cuda_device)
    wq = torch.zeros(8, 3, 3, 24, dtype=torch.int8, device=cuda_device)
    scale = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match='wgmma kernel takes'):
        ic.int8_conv(xq, wq, scale, padding=1, kernel='wgmma')


def _activation_shapes():
    acts = {}
    for (b, h, w, cin, _, _), calls in chip_smoke.INT8_NET_SHAPES:
        acts[(b, h, w, cin)] = acts.get((b, h, w, cin), 0) + calls
    return list(acts)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', _activation_shapes()
                         + [(2, 5, 7, 24), (1, 3, 3, 12), (3, 9, 11, 40)])
def test_quant_act_kernels_bitwise(cuda_device, shape):
    """act_amax (whole tensor and per channel) and quantize_act (dynamic,
    calibrated and smoothed divisors) equal their plain versions bit for
    bit, at the net's activations and at widths no multiple of 8."""
    from srgd_tpu_torch.kernels import quant_act as qa
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    q = chip_smoke.quant_case(torch, cuda_device, shape, g)
    before = (qa.launches_amax, qa.launches)
    for name, (kern, plain) in (('amax', q['amax']),
                                ('amax_per_channel', q['amax_per_channel']),
                                *q['quantize'].items()):
        got, want = kern(), plain()
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert (qa.launches_amax, qa.launches) == (before[0] + 2, before[1] + 3)
    # float32 activations too
    x = torch.randn(shape, generator=g, device=cuda_device) * 3
    div = qa.act_amax_plain(x) / 127.0 + 1e-12
    assert torch.equal(qa.act_amax(x), qa.act_amax_plain(x))
    assert torch.equal(qa.quantize_act(x, div), qa.quantize_act_plain(x, div))


@pytest.mark.cuda
def test_quant_act_raises_on_what_it_does_not_take(cuda_device):
    from srgd_tpu_torch.kernels import quant_act as qa
    x = torch.randn(2, 4, 4, 16, device=cuda_device).to(torch.bfloat16)
    d = torch.ones((), device=cuda_device)
    with pytest.raises(ValueError, match='contiguous'):
        qa.quantize_act(x.permute(0, 2, 1, 3), d)
    with pytest.raises(ValueError, match='contiguous'):
        qa.act_amax(x.transpose(1, 2))
    with pytest.raises(ValueError, match='divisor must be float32'):
        qa.quantize_act(x, torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError, match='activation\'s device'):
        qa.quantize_act(x, d.cpu())


def _plain_route(monkeypatch):
    """QuantConv's kernels swapped for their plain versions, on the card."""
    from srgd_tpu_torch.kernels import int8_conv as ic
    from srgd_tpu_torch.kernels import quant_act as qa
    from srgd_tpu_torch.nn import quant as tq
    monkeypatch.setattr(tq, 'act_amax', qa.act_amax_plain)
    monkeypatch.setattr(tq, 'quantize_act', qa.quantize_act_plain)
    monkeypatch.setattr(tq, 'int8_conv', ic.int8_conv_plain)


@pytest.mark.cuda
@pytest.mark.parametrize('alpha', [0.0, 0.5])
@pytest.mark.parametrize('calibrated', [False, True])
def test_quantconv_card_route_equals_its_cpu_route(cuda_device, alpha,
                                                   calibrated, monkeypatch):
    """One QuantConv on the card, through the three kernels, equals the same
    module on the card through their plain versions bit for bit, and the
    same module on the CPU within a code flip: the card computes the scale
    arithmetic (``/ 127``, SmoothQuant's powers) with PyTorch's CUDA ops,
    which may round a scale one ulp away from the CPU's."""
    from srgd_tpu_torch.kernels import int8_conv as ic
    from srgd_tpu_torch.kernels import quant_act as qa
    from srgd_tpu_torch.nn.quant import QuantConv, calibrate_quant
    torch.manual_seed(0)
    m = QuantConv(128, 256, 3, padding=1, smooth_alpha=alpha,
                  dtype=torch.bfloat16, device=cuda_device)
    x = (torch.randn(4, 128, 16, 16, device=cuda_device) * 2).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    if calibrated:
        calibrate_quant(m, [((x * 1.5,), {})])
    before = (ic.launches_wgmma, qa.launches, qa.launches_amax)
    with torch.no_grad():
        got = m(x)
    assert (ic.launches_wgmma, qa.launches, qa.launches_amax) == (
        before[0] + 1, before[1] + 1, before[2] + (not calibrated))
    with monkeypatch.context() as mp:
        _plain_route(mp)
        with torch.no_grad():
            want = m(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    cpu = copy.deepcopy(m).cpu()
    with torch.no_grad():
        on_cpu = cpu(x.cpu())
    diff = (got.float().cpu() - on_cpu.float()).abs().max().item()
    assert diff <= 2e-2 * on_cpu.float().abs().max().item()
