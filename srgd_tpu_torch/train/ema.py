"""EMA shadow parameters.

Counterpart of ``srgd_tpu/train/ema.py``: timm ModelEmaV2 semantics,
ema = decay * ema + (1 - decay) * w, on float32 tensors. The shadow is a
plain dict of tensors keyed like the parameters, updated in place.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_update(ema_params: dict, params: dict, decay: float) -> None:
    """In place: each ``ema_params[k] = decay * ema_params[k] + (1 - decay)
    * params[k]``, in the JAX expression's order."""
    for name, e in ema_params.items():
        e.mul_(decay).add_(params[name].detach() * (1.0 - decay))
