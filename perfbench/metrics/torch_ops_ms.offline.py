"""Device ms a forward in PyTorch's own kernels other than convolutions and
GEMMs: the float32 GroupNorm chain (moments, casts and copies, FiLM, SiLU),
concatenations and the rest; from the forwards of the profiled call."""

from perfbench.readers import group_ms_per_forward


def read(record):
    return group_ms_per_forward(
        record, ('port_kernels', 'convolutions', 'gemm'))
