"""The W8A8 convolution: int8 activations times int8 weights, summed in
int32, then dequantized. Two CUDA kernels, routed by shape, and their plain
version.

Replaces ``srgd_tpu/nn/quant.py:165-173``: QuantConv's
``lax.conv_general_dilated(xq, wq, preferred_element_type=int32)`` and its
epilogue ``acc * (s_x * s_w) + bias``, an XLA op in the JAX package (not a
Pallas kernel) for which PyTorch has no CUDA counterpart. The CUDA source is
``srgd_tpu_torch/csrc/int8_conv.cu``: an implicit GEMM over M = B*H*W output
pixels, N = Cout and K = ks*ks*Cin, with the halo taps read as zero and the
epilogue fused. Two kernels compute it:

- ``int8_conv_wgmma`` (route ``'wgmma'``: Cin % 16 == 0, 16-byte aligned
  ``xq`` and ``wq``, ks 1 or 3; every conv of the net): a persistent,
  warp-specialised kernel for Hopper. One producer warp keeps a ring of four
  shared-memory stages filled by TMA (a 4-D box of the NHWC activation per
  tap, whose halo TMA fills with zeros, and a 3-D box of ``wq``); two
  consumer warpgroups issue ``wgmma`` m64n256k32 s8 products on each stage
  and write the epilogue from their registers while the next tile loads.
- ``int8_conv_kernel`` (route ``'mma'``: the first version, for what the
  other does not take, such as the tests' ragged widths and Cin = 3):
  ``mma.sync`` m16n8k32 s8 products on tiles gathered with ``cp.async``.

The route is a function of the shape and the operands' alignment alone
(:func:`route`); neither route ever gives way to the plain version or the
CPU. ``launches`` counts every launch, ``launches_wgmma`` and
``launches_mma`` each route's.

What bounds it on the H100: operations at the net's 3x3 convs (2 M N K
against the 1,979 TOP/s int8 peak), bytes at the 1x1 convs of a 128-channel
input (reading ``xq`` and ``wq`` and writing the output once). Layouts:
``xq`` NHWC, ``wq`` (Cout, ks, ks, Cin), output NHWC, stride 1 and "same"
padding, as QuantConv's convs are.

The result is exact: every product and partial sum is an integer, and the
epilogue is ``float(acc) * scale`` then ``+ bias`` as two float32 operations
rounded to nearest, then the cast. So both kernels and the plain version
agree bit for bit, on the card and against the CPU. Times: PERF.md.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from srgd_tpu_torch.kernels import _build

launches = 0         # kernel launches through int8_conv, either route
launches_wgmma = 0   # of them, int8_conv_wgmma's
launches_mma = 0     # of them, int8_conv_kernel's

ROUTES = ('wgmma', 'mma')

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _check(xq, wq, scale, bias, padding, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f'int8_conv takes int8 xq and wq, got {xq.dtype} and '
                        f'{wq.dtype}')
    if xq.dim() != 4 or wq.dim() != 4 or wq.shape[3] != xq.shape[3]:
        raise ValueError(f'int8_conv takes xq (B, H, W, Cin) and wq (Cout, '
                         f'ks, ks, Cin); got {tuple(xq.shape)} and '
                         f'{tuple(wq.shape)}')
    ks = wq.shape[1]
    if wq.shape[2] != ks or ks % 2 == 0 or padding != ks // 2:
        raise ValueError(f'int8_conv computes square odd kernels at stride 1 '
                         f'with "same" padding; got a {wq.shape[1]}x'
                         f'{wq.shape[2]} kernel with padding {padding}')
    if out_dtype not in _OUT_KIND:
        raise TypeError(f'int8_conv writes float32, bfloat16 or the int32 '
                        f'accumulators, not {out_dtype}')
    if out_dtype == torch.int32:
        if scale is not None or bias is not None:
            raise ValueError('int8_conv: the int32 accumulators take no '
                             'scale or bias')
    elif scale is None:
        raise ValueError('int8_conv: a float output needs the scale')
    for name, v in (('scale', scale), ('bias', bias)):
        if v is not None and (v.dtype != torch.float32
                              or tuple(v.shape) != (wq.shape[0],)):
            raise ValueError(f'int8_conv: {name} must be float32 (Cout,), got '
                             f'{v.dtype} {tuple(v.shape)}')


def int8_conv_plain(xq, wq, scale=None, bias=None, *, padding: int,
                    out_dtype=torch.float32):
    """Plain PyTorch version: ``F.unfold`` of xq, a float64 matmul with wq
    (exact: every product and partial sum is an integer below 2^53) cast to
    int32, then ``acc.float() * scale``, ``+ bias`` and the cast, as
    separate ops. ``out_dtype`` torch.int32 returns the accumulators."""
    _check(xq, wq, scale, bias, padding, out_dtype)
    b, h, w, _ = xq.shape
    cout, ks = wq.shape[0], wq.shape[1]
    cols = F.unfold(xq.permute(0, 3, 1, 2).double(), ks, padding=padding)
    # unfold's rows run (c, ky, kx); wq's (ky, kx, c)
    wmat = wq.permute(0, 3, 1, 2).reshape(cout, -1).double()
    acc = (wmat @ cols).to(torch.int32)                   # (b, Cout, h*w)
    acc = acc.transpose(1, 2).reshape(b, h, w, cout)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def route(cin: int, ks: int, x_ptr: int, w_ptr: int) -> str:
    """The kernel a CUDA call takes: ``'wgmma'`` for Cin % 16 == 0 (TMA's
    strides are multiples of 16 bytes), ``xq`` and ``wq`` at 16-byte aligned
    addresses and ks 1 or 3, else ``'mma'``."""
    if cin % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0 and ks in (1, 3):
        return 'wgmma'
    return 'mma'


def int8_conv(xq, wq, scale=None, bias=None, *, padding: int,
              out_dtype=torch.float32, kernel: str | None = None):
    """xq (B, H, W, Cin) int8, wq (Cout, ks, ks, Cin) int8, ``scale`` and
    ``bias`` float32 (Cout,) -> (B, H, W, Cout) in ``out_dtype``:

        acc[m, o] = sum_{ky, kx, c} xq[b, y + ky - p, x + kx - p, c] wq[o, ky, kx, c]
        out[m, o] = (float(acc[m, o]) * scale[o] + bias[o]) in out_dtype

    (``out_dtype`` torch.int32: ``acc`` itself, no scale or bias). A CPU
    tensor takes the plain version, a CUDA tensor the kernel that
    :func:`route` picks, or ``kernel`` ('wgmma' or 'mma') if given; a kernel
    needs contiguous operands and raises rather than fall back or copy."""
    global launches, launches_wgmma, launches_mma
    _check(xq, wq, scale, bias, padding, out_dtype)
    if kernel is not None and kernel not in ROUTES:
        raise ValueError(f'int8_conv: kernel must be one of {ROUTES}, got '
                         f'{kernel!r}')
    if xq.device.type == 'cpu':
        return int8_conv_plain(xq, wq, scale, bias, padding=padding,
                               out_dtype=out_dtype)
    if xq.device.type != 'cuda':
        raise RuntimeError(f'int8_conv: no kernel for device {xq.device}')
    operands = [t for t in (xq, wq, scale, bias) if t is not None]
    if any(t.device != xq.device for t in operands):
        raise ValueError('int8_conv: every operand must be on one device')
    if not all(t.is_contiguous() for t in operands):
        raise ValueError('int8_conv kernel needs contiguous operands; it '
                         'does not copy')
    b, h, w, cin = xq.shape
    cout, ks = wq.shape[0], wq.shape[1]
    if b * h * w >= 2 ** 31:
        raise ValueError(f'int8_conv: {b}x{h}x{w} pixels are past the '
                         'kernel\'s int index range')
    chosen = route(cin, ks, xq.data_ptr(), wq.data_ptr())
    if kernel == 'wgmma' and chosen != 'wgmma':
        raise ValueError(f'int8_conv: the wgmma kernel takes Cin % 16 == 0, '
                         f'16-byte aligned operands and ks 1 or 3; got Cin '
                         f'{cin}, ks {ks}')
    chosen = kernel or chosen
    out = torch.empty((b, h, w, cout), device=xq.device, dtype=out_dtype)
    args = [xq.data_ptr(), wq.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, ks, padding, _OUT_KIND[out_dtype]]
    if chosen == 'wgmma':
        fn = _build.entry('srgd_int8_conv_wgmma', 5, 8)
    else:
        fn = _build.entry('srgd_int8_conv', 5, 9)
        args.append(int(cin % 16 == 0 and xq.data_ptr() % 16 == 0
                        and wq.data_ptr() % 16 == 0))   # 16-byte cp.async
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(*args, stream)
    _build.check(err, fn.__name__)
    launches += 1
    if chosen == 'wgmma':
        launches_wgmma += 1
    else:
        launches_mma += 1
    return out
