"""Autograd wiring shared by the kernel wrappers.

Two kinds of kernel, as in the JAX package:

- ``linattn_block`` and ``attn_block`` carry a ``jax.custom_vjp`` there
  (``srgd_tpu/kernels/linattn_block.py``, ``srgd_tpu/kernels/attn_block.py``):
  the forward is the kernel, the backward is the VJP of the XLA formulation
  recomputed from the primal inputs. Here that is :func:`recompute_backward`,
  called from each wrapper's ``torch.autograd.Function``.
- ``groupnorm_silu``, ``attention`` and the linear-attention cores have no
  VJP, so JAX cannot differentiate them. Here :func:`forward_only` runs them
  through a Function whose backward raises, so that a training run that
  routes to one of them fails at its first ``backward()`` instead of
  training a net whose graph the kernel's raw output cut.
"""

from __future__ import annotations

import torch

NO_GRADIENT = (
    '{name} has no gradient: the JAX package cannot differentiate this '
    'kernel either (no Pallas autodiff, docs/TRAINING.md). It runs when the '
    'config sets use_pallas_kernels (groupnorm_silu, linear_attention_qkv), '
    'or flash_attn where attn_block does not take the block (fused_linattn: '
    'false, or float32 compute); train with those off.')


def recompute_range(name: str) -> str:
    """The ``torch.profiler`` range around a kernel's backward recompute."""
    return f'{name}.backward_recompute'


def recompute_backward(name, plain, inputs, needs, grad_out, **kw):
    """Gradients of ``plain(*inputs, **kw)`` against ``grad_out``, recomputed
    from the detached primal inputs under ``torch.enable_grad()``: the
    counterpart of ``_fused_*_bwd``. Returns one entry per input, None where
    ``needs`` is False; each gradient in its input's dtype. Runs inside the
    profiler range ``recompute_range(name)``."""
    with torch.enable_grad(), \
            torch.profiler.record_function(recompute_range(name)):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        out = plain(*leaves, **kw)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return [next(grads) if need else None for need in needs]


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, message, fn, *inputs):
        ctx.message = message
        return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(ctx.message)


def forward_only(name: str, fn, *inputs, message: str = NO_GRADIENT):
    """``fn(*inputs)`` through a Function whose backward raises ``message``
    (:data:`NO_GRADIENT` by default) with ``name`` filled in; forward-only
    callers see no difference."""
    return _ForwardOnly.apply(message.format(name=name), fn, *inputs)
