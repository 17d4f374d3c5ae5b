"""ms a sampler step outside the U-Net: the window's wall time less the
forwards' CUDA-event spans, over the steps (tiling, noise, the update, the
copy to the host and the host's gaps)."""

from perfbench.readers import span_ms


def read(record):
    c, fwd = record.counters, span_ms(record, 'forward')
    if not c.get('steps') or not fwd:
        return None
    return (c['window_s'] * 1e3 - sum(fwd)) / c['steps']
