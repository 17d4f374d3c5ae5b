"""The bfloat16 CUDA paths of ``attn_block`` and the linear-attention core,
repeated in plain PyTorch, against the plain versions and the JAX package.

The tensor-core kernels round a few intermediates to bfloat16 that the
JAX functions keep in float32 (ROADMAP Queue 3). Each ``_model`` below
repeats one kernel's arithmetic, tile by tile where the kernel streams, and
is held inside the card's bfloat16 tolerance (chip_smoke.py's
``max|err| <= 2e-2 * max|ref|``) of the plain version and of the Pallas
kernel in interpret mode (``interpret=True`` per call). Also here: the
``attn_block`` plain version against the JAX kernel at c = 512, the weight
packing of the bfloat16 ``attn_block`` kernel, and a check that every CUDA
kernel is known to chip_smoke.py's profile."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from srgd_tpu.kernels.attn_block import _xla_attn_block, fused_attn_block
from srgd_tpu.kernels.linear_attention import (fused_linear_attention,
                                               fused_linear_attention_qkv)
from srgd_tpu_torch.kernels import attention as at
from srgd_tpu_torch.kernels import attn_block as ab
from srgd_tpu_torch.kernels import linattn_block as lb
from srgd_tpu_torch.kernels import linear_attention as la

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

BF16_RTOL = chip_smoke.BF16_RTOL
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'srgd_tpu_torch', 'csrc')


def _bf(t):
    return t.to(torch.bfloat16).float()


def _attention_model(q, k, v, tile_k=at.TILE_K):
    """flash.cuh's loop: the unscaled bf16 product in float32, scale and
    log2(e) on the score, an online softmax over tiles of ``tile_k`` keys with
    exp2, p rounded to bf16 before P V (its row sum from the float p), the
    division by the sum last. Returns float32."""
    n, d = q.shape[-2:]
    sl = d ** -0.5 * 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, n, tile_k):
        s = (qf @ kf[..., k0:k0 + tile_k, :].transpose(-1, -2)) * sl
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        al = torch.exp2(m - mn)
        p = torch.exp2(s - mn)
        l = l * al + p.sum(dim=-1, keepdim=True)
        acc = acc * al + _bf(p) @ vf[..., k0:k0 + tile_k, :]
        m = mn
    return acc / l


def _attn_block_model(x, g1, wqkv, wout, bout, heads=4, dim_head=32):
    """The bfloat16 ``attn_block`` kernel: y and qkv rounded as
    ``_xla_attn_block`` rounds them (y from x times the reciprocal of its
    norm), the attention as ``_attention_model``, so p is rounded before its
    division by l, o rounded, to_out in float32 plus the bias."""
    b, n, c = x.shape
    hidden = heads * dim_head
    xf = x.float()
    inv = 1 / torch.clamp_min(torch.sqrt((xf * xf).sum(-1, keepdim=True)),
                              1e-12)
    y = _bf(xf * inv * (g1.float() * c ** 0.5))
    qkv = _bf(y @ _bf(wqkv))
    q, k, v = (qkv[..., i * hidden:(i + 1) * hidden]
               .reshape(b, n, heads, dim_head).transpose(1, 2)
               for i in range(3))
    o = _bf(_attention_model(q, k, v)).transpose(1, 2).reshape(b, n, hidden)
    return (o @ _bf(wout) + bout.float()).to(x.dtype)


def _attn_inputs(b, n, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    g1 = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    wqkv = (rng.normal(size=(c, 384)) / np.sqrt(c)).astype(np.float32)
    wout = (rng.normal(size=(128, c)) / np.sqrt(128)).astype(np.float32)
    bout = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, g1, wqkv, wout, bout


def _jax_torch(arrays, dtype):
    """(jax arrays, torch tensors): x and the weights in ``dtype``, the gain
    and the bias in float32, as the modules pass them."""
    f32 = (1, 4)
    ja = [jnp.asarray(a).astype(jnp.float32 if i in f32 else dtype)
          for i, a in enumerate(arrays)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ta = [torch.from_numpy(a).to(torch.float32 if i in f32 else tdt)
          for i, a in enumerate(arrays)]
    return ja, ta


def _within(got, want):
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.asarray(want, np.float32)))
    err = (got.float() - want).abs().max().item()
    return err <= BF16_RTOL * want.abs().max().item()


@pytest.mark.parametrize('n', [64, 40, 136])
def test_attn_block_rounding_model_fits_the_bf16_tolerance(n):
    """A whole 64-key tile, a ragged one and several tiles with a ragged
    tail, at c = 128."""
    ja, ta = _jax_torch(_attn_inputs(2, n, 128, seed=n), jnp.bfloat16)
    model = _attn_block_model(*ta)
    assert model.dtype == torch.bfloat16 and model.shape == (2, n, 128)
    plain = ab.attn_block_plain(*ta, heads=4, dim_head=32)
    pallas = fused_attn_block(*ja, heads=4, dim_head=32, interpret=True)
    xla = _xla_attn_block(*ja, heads=4, dim_head=32)
    for want in (plain, pallas, xla):
        assert _within(model, want)
    # the model is not the plain version under another name
    assert not torch.equal(model, plain)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attn_block_plain_matches_jax_kernel_at_c512(dtype):
    """The width of ``downs_3``: float32 atol 1e-4, bfloat16 atol 2e-2, the
    bars of test_torch_kernels.py::test_plain_matches_jax_kernel."""
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    ja, ta = _jax_torch(_attn_inputs(1, 64, 512, seed=3), jdt)
    plain = ab.attn_block_plain(*ta, heads=4, dim_head=32)
    assert plain.dtype == ta[0].dtype and plain.shape == (1, 64, 512)
    atol = 1e-4 if dtype == 'float32' else 2e-2
    for want in (fused_attn_block(*ja, heads=4, dim_head=32, interpret=True),
                 _xla_attn_block(*ja, heads=4, dim_head=32)):
        np.testing.assert_allclose(plain.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=atol, rtol=0)
    assert torch.equal(ab.attn_block(*ta, heads=4, dim_head=32), plain)


def _linear_attention_model(q, k, v, dim_head=32):
    """The bfloat16 linear-attention kernel: pass A over the splits of
    ``_split`` and 64-row tiles with an online column max, exp(k - m)
    rounded to bf16 before its division by z (z from the float
    exponentials), ctx += ek^T v in float32 rescaled by alpha; the merge in
    split order; the normalised context (scale folded in) rounded to bf16;
    the per-head q softmax shifted by the row max over all heads, rounded to
    bf16; the product in float32. Returns q's dtype."""
    b, n, c = q.shape
    rows, nsplit = lb._split(b, n)
    kf, vf = k.float(), v.float()
    mask = lb._head_mask(c, dim_head, 'cpu')
    parts = []
    for s in range(nsplit):
        m = torch.full((b, 1, c), -1e30)
        z = torch.zeros((b, 1, c))
        ctx = torch.zeros((b, c, c))
        end = min((s + 1) * rows, n)
        for r0 in range(s * rows, end, lb.TILE_ROWS):
            kt = kf[:, r0:min(r0 + lb.TILE_ROWS, end)]
            vt = vf[:, r0:min(r0 + lb.TILE_ROWS, end)]
            mn = torch.maximum(m, kt.amax(dim=1, keepdim=True))
            al = torch.exp(m - mn)
            e = torch.exp(kt - mn)
            z = z * al + e.sum(dim=1, keepdim=True)
            ctx = ctx * al.transpose(1, 2) + _bf(e).transpose(1, 2) @ vt
            m = mn
        parts.append((m, z, ctx))
    mx = torch.stack([p[0] for p in parts]).amax(dim=0)
    z = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
    ctx = sum(p[2] * torch.exp(p[0] - mx).transpose(1, 2) for p in parts)
    cn = _bf(ctx / z.transpose(1, 2) * mask * dim_head ** -0.5)
    qf = q.float()
    eq = torch.exp(qf - qf.amax(dim=-1, keepdim=True))
    qn = _bf(eq / (eq @ mask))
    return (qn @ cn).to(q.dtype)


@pytest.mark.parametrize('b,n', [(2, 256), (2, 200), (16, 2000)],
                         ids=['one_tile_a_split', 'ragged',
                              'two_tiles_a_split'])
@pytest.mark.parametrize('packed', [False, True], ids=['qkv3', 'packed'])
def test_linear_attention_rounding_model_fits_the_bf16_tolerance(packed, b, n):
    """Splits of one 64-row tile, a ragged sequence, and splits of two tiles
    with a ragged last split (b = 16, n = 2000: 16 splits of 128 rows)."""
    rng = np.random.default_rng(n)
    qkv = rng.normal(size=(b, n, 384)).astype(np.float32)
    qkv[..., 128:256] *= 2.0     # a k column max that moves between tiles
    tq = torch.from_numpy(qkv).bfloat16()
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    q, k, v = (t.contiguous() for t in tq.chunk(3, dim=-1))
    if packed:
        plain = la.linear_attention_qkv_plain(tq)
        pallas = fused_linear_attention_qkv(jq, dim_head=32, interpret=True)
    else:
        plain = la.linear_attention_plain(q, k, v)
        pallas = fused_linear_attention(
            *(jq[..., i * 128:(i + 1) * 128] for i in range(3)), dim_head=32,
            interpret=True)
    model = _linear_attention_model(q, k, v)
    assert model.dtype == torch.bfloat16 and model.shape == (b, n, 128)
    if b == 16:
        rows, nsplit = lb._split(b, n)
        assert rows == 2 * lb.TILE_ROWS
        assert (nsplit - 1) * rows < n < nsplit * rows
    for want in (plain, pallas):
        assert _within(model, want)
    assert not torch.equal(model, plain)


def _kernels_of(path):
    """(name, templated on T) of every __global__ in a CUDA source."""
    src = open(path).read()
    pat = re.compile(r'(template\s*<\s*typename\s+T\s*>\s*)?__global__\s+void'
                     r'(?:\s+__launch_bounds__\((?:[^()]|\([^()]*\))*\))?'
                     r'\s+(\w+)\s*\(')
    return [(m.group(2), m.group(1) is not None) for m in pat.finditer(src)]


def _float_only(path):
    """The __global__s of a source that only its float32 entry reaches: those
    templated on the element type T when the source never launches its
    T-templated path with bfloat16."""
    src = open(path).read()
    bf16_t = re.search(r'launch<\s*(__nv_bfloat16|bf16)\b', src) is not None
    return {name for name, templ in _kernels_of(path) if templ and not bf16_t}


CU_FILES = sorted(f for f in os.listdir(CSRC) if f.endswith('.cu'))


@pytest.mark.parametrize('name', CU_FILES)
def test_every_device_kernel_is_charged_to_a_port_kernel(name):
    """The profile charges a device kernel to one of the port's kernels by
    its function name (``DEVICE_KERNELS``); a bfloat16 net must spend no time
    in a float32-only one (``F32_ONLY_KERNELS``)."""
    path = os.path.join(CSRC, name)
    found = _kernels_of(path)
    assert found, name
    for fn, _ in found:
        assert fn in chip_smoke.DEVICE_KERNELS or fn == 'merge_kv_partials', fn
    owners = {chip_smoke.DEVICE_KERNELS[fn] for fn, _ in found}
    kernel = name[:-len('.cu')]
    # a source named for no single kernel holds the entries of one function
    assert kernel in owners or (kernel, owners) in (
        ('linear_attention', {'linear_attention_qkv'}),
        ('quant_act', {'act_amax', 'quantize_act'}))
    f32 = _float_only(path)
    assert f32 <= set(chip_smoke.F32_ONLY_KERNELS), (name, f32)
    both = {fn for fn, _ in found} - f32
    assert not both & set(chip_smoke.F32_ONLY_KERNELS)


def test_float_only_kernels_are_exactly_the_listed_ones():
    found = set().union(*(_float_only(os.path.join(CSRC, f))
                          for f in CU_FILES))
    assert found == set(chip_smoke.F32_ONLY_KERNELS)
    assert {'qkv_proj', 'attend', 'kv_partials', 'out_rows'} <= found
    merge = [n for f in os.listdir(CSRC) if f.endswith('.cuh')
             for n, _ in _kernels_of(os.path.join(CSRC, f))]
    assert merge == ['merge_kv_partials']


@pytest.mark.parametrize('hidden', [128, 64, 32])
def test_attn_block_qkv_packing_round_trips(hidden):
    """``pack_qkv`` puts q, k and v at columns 0, 128 and 256, zero past
    ``hidden``; slicing returns wqkv, and the block computed from the
    slices equals the original."""
    rng = np.random.default_rng(hidden)
    c = 64
    wqkv = torch.from_numpy(rng.normal(size=(c, 3 * hidden))
                            .astype(np.float32)).bfloat16()
    packed = ab.pack_qkv(wqkv, hidden)
    assert packed.shape == (c, 384) and packed.dtype == torch.bfloat16
    assert (packed is wqkv) == (hidden == 128)
    back = torch.cat([packed[:, i * 128:i * 128 + hidden] for i in range(3)],
                     dim=1)
    assert torch.equal(back, wqkv)
    assert torch.isclose(packed.float().abs().sum(), wqkv.float().abs().sum(),
                         rtol=1e-6)
    x = torch.from_numpy(rng.normal(size=(1, 24, c)).astype(np.float32))
    x = x.bfloat16()
    wout = torch.from_numpy(rng.normal(size=(hidden, c)).astype(np.float32))
    g, bout = torch.ones(c), torch.zeros(c)
    heads = hidden // 32
    assert torch.equal(
        ab.attn_block_plain(x, g, back, wout.bfloat16(), bout, heads=heads,
                            dim_head=32),
        ab.attn_block_plain(x, g, wqkv, wout.bfloat16(), bout, heads=heads,
                            dim_head=32))
