"""The whole step's share of the chip's bf16 peak while the daemon samples:
model FLOPs of every tile forward of the window's samples (one tile a
canvas a step) over the wall time those samples took (host-clock spans
around the daemon's ``Sampler.sample``, each ending in its copy to the
host), in %. At a load below capacity the window's own length is set by
the arrivals, so the samples' time is what a faster step shortens."""

from perfbench.counts import formulas


def read(record):
    spans = record.spans.get('sample', [])
    steps = record.counters.get('steps_per_sample')
    if not spans or not steps:
        return None
    busy_s = sum(ms for ms, _ in spans) / 1e3
    tiles = sum(rows for _, rows in spans) * steps
    flops = tiles * formulas.unet_counts()['model_flops_per_tile']
    return flops / (busy_s * formulas.peaks()['flops_per_s']['bfloat16']) \
        * 100.0
