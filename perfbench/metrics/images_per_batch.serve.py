"""Canvases a coalesced sample holds: the daemon's batcher counters
(``batched_images`` over ``batches``) over the window."""


def read(record):
    c = record.counters
    if not c.get('batches'):
        return None
    return c['batched_images'] / c['batches']
