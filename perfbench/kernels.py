"""Which device kernels are the port's, and what PyTorch's own kernels are
doing, by name (copied from chip_smoke.py's ``DEVICE_KERNELS`` and
``OP_GROUPS``)."""

from __future__ import annotations

from perfbench.tracing import function

# device kernel function -> the port's kernel it belongs to
DEVICE_KERNELS = {
    'phase_a': 'linattn_block', 'phase_b': 'linattn_block',
    'phase_a_mma': 'linattn_block', 'phase_b_mma': 'linattn_block',
    'qkv_proj': 'attn_block', 'attend': 'attn_block',
    'qkv_proj_mma': 'attn_block', 'attn_block_flash': 'attn_block',
    'out_proj_mma': 'attn_block',
    'groupnorm_silu_fused': 'groupnorm_silu', 'flash': 'attention',
    'flash_mma': 'attention', 'kv_partials': 'linear_attention_qkv',
    'out_rows': 'linear_attention_qkv',
    'kv_partials_mma': 'linear_attention_qkv',
    'out_rows_mma': 'linear_attention_qkv', 'int8_conv_kernel': 'int8_conv',
    'int8_conv_wgmma': 'int8_conv', 'act_amax_partial': 'act_amax',
    'act_amax_final': 'act_amax', 'quantize_act_kernel': 'quantize_act'}
# the partial merge shared by linattn_block and linear_attention_qkv
SHARED_MERGE = 'merge_kv_partials'

# what PyTorch's device kernels do, by the first substring of the kernel's
# name that matches
OP_GROUPS = (
    ('convolutions', ('xmma', 'convolve', 'cudnn', 'conv')),
    ('gemm', ('nvjet', 'gemm', 'cutlass')),
    ('groupnorm_moments', ('RowwiseMoments',)),
    ('concatenations', ('CatArray',)),
    ('copies_and_casts', ('copy_kernel',)),
    ('reductions', ('reduce_kernel',)),
    ('elementwise', ('elementwise',)),
)


def owner(key: str, merge_owner: str | None = None):
    """The port's kernel a device kernel (profiler key) belongs to, or
    None; the shared merge goes to ``merge_owner``."""
    fn = function(key)
    if fn == SHARED_MERGE:
        return merge_owner
    return DEVICE_KERNELS.get(fn)


def group(key: str) -> str:
    """'port_kernels', one of ``OP_GROUPS`` or 'other'."""
    fn = function(key)
    if fn in DEVICE_KERNELS or fn == SHARED_MERGE:
        return 'port_kernels'
    return next((g for g, subs in OP_GROUPS
                 if any(sub in key for sub in subs)), 'other')
