"""Faults planted under a run, for the test that sees ``correct`` come out
false: each breaks the timed path of a ``infer.Sampler`` (the offline
driver's, or the daemon's ``server.sampler``), or the trainer's step, at
the point named."""

from __future__ import annotations

import numpy as np

FAULTS = ('state_unchanged', 'half_batch', 'answer_altered')


def apply(fault: str, sampler) -> None:
    wrapper = sampler.wrapper
    if fault == 'state_unchanged':
        # every step returns the canvas it was given
        wrapper.p_sample_tiles = lambda x, *a, **k: (x, x)
    elif fault == 'half_batch':
        # the second half of every tile batch is left out of the forward
        plain = wrapper.net_apply

        def half(x, *a, **k):
            h = max(x.shape[0] // 2, 1)
            args = [t[:h] if hasattr(t, 'shape') and t.dim() and
                    t.shape[0] == x.shape[0] else t for t in a]
            out = plain(x[:h], *args, **k)
            pad = out.new_zeros((x.shape[0] - h, *out.shape[1:]))
            return out if h == x.shape[0] else __import__('torch').cat(
                [out, pad])
        wrapper.net_apply = half
    elif fault == 'answer_altered':
        # one 4x4 patch of every answer moved by half the range
        plain_sample = sampler.sample

        def altered(*a, **k):
            out = np.array(plain_sample(*a, **k))
            out[:, :4, :4, :] = np.mod(out[:, :4, :4, :] + 0.5, 1.0)
            return out
        sampler.sample = altered
    else:
        raise ValueError(f'unknown fault {fault!r}')


TRAIN_FAULTS = ('state_unchanged', 'half_batch', 'labels_shifted')


class _Relabelled:
    """The feed with every label moved to the next class, where the data
    stage hands its batches over."""

    def __init__(self, feed, classes: int):
        self.feed, self.classes, self._thread = feed, classes, feed._thread

    def __next__(self):
        hr, cond, label = next(self.feed)
        return hr, cond, (label + 1) % self.classes

    def close(self):
        self.feed.close()


def apply_train(fault: str, t: dict) -> None:
    """``t``: the training driver's set-up (wrapper, state)."""
    if fault == 'state_unchanged':
        # the optimizer leaves every parameter and its own state as it was
        t['state'].optimizer.step = lambda *a, **k: None
    elif fault == 'half_batch':
        # the loss is the mean over the first half of the batch
        wrapper = t['wrapper']
        plain = wrapper.loss

        def half(img, cond, label=None, **kw):
            h = max(img.shape[0] // 2, 1)
            return plain(img[:h], cond[:h],
                         None if label is None else label[:h], **kw)
        wrapper.loss = half
    elif fault == 'labels_shifted':
        t['feed'] = _Relabelled(t['feed'], t['conf'].num_classes)
    else:
        raise ValueError(f'unknown training fault {fault!r}')
