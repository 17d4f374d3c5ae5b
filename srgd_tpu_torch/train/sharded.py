"""Training state over a (data, model) mesh.

Counterpart of what ``shard_params`` and ``batch_sharding`` give the JAX
trainer (``srgd_tpu/train/loop.py:322-363``), one process per device:

- **data**: each rank takes its data coordinate's rows of the global batch
  (``local_rows``); the step's draws are drawn at the global batch shape and
  sliced the same way (``RowDraws``), so the loss is the one-device loss.
  Gradients and the loss are averaged with an all-reduce.
- **model**: the parameters ``parallel.mesh.param_spec`` selects keep their
  master copy as a ``DTensor`` sharded on dim 0 over the model sub-mesh;
  the optimizer state and the EMA copy are made from the masters, so they
  are sharded the same way. The modules keep whole weights for the forward
  and backward (the kernels' autograd Functions see whole weights); after
  each optimizer step the shards are all-gathered back into them. Ranks of
  one data coordinate compute the same rows, so every gradient is averaged
  over the whole world, which keeps the replicas bit-equal.

``full_state`` turns any of this back into whole CPU tensors, for the
single-file checkpoint a one-device run writes; ``load_full`` re-shards a
checkpoint's optimizer and EMA state on resume.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from srgd_tpu_torch.parallel.mesh import sharded_names


def local_rows(batch: int, mesh) -> slice:
    """The data coordinate's rows of a global batch of ``batch``."""
    if batch % mesh.data_size:
        raise ValueError(f'batch_size {batch} does not divide by the '
                         f'mesh data axis {mesh.data_size}')
    n = batch // mesh.data_size
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


class RowDraws:
    """A draw source whose per-sample draws are made at the global batch
    shape and cut to this rank's rows: a draw whose leading dim is the
    local batch is drawn with ``global_batch`` rows instead; whole-batch
    draws pass through."""

    def __init__(self, draws, global_batch: int, rows: slice):
        self.draws, self.global_batch, self.rows = draws, global_batch, rows
        self.local = rows.stop - rows.start

    def _draw(self, fn, name, shape, *args):
        shape = tuple(shape)
        if shape and shape[0] == self.local:
            return fn(name, (self.global_batch, *shape[1:]), *args)[self.rows]
        return fn(name, shape, *args)

    def uniform(self, name, shape):
        return self._draw(self.draws.uniform, name, shape)

    def normal(self, name, shape):
        return self._draw(self.draws.normal, name, shape)

    def randint(self, name, shape, high):
        return self._draw(self.draws.randint, name, shape, high)


class MeshParams:
    """The trainable parameters (name -> the modules' own tensors) under a
    mesh: ``master`` holds, by the same names, a dim-0 ``DTensor`` shard over
    the model sub-mesh for each name ``param_spec`` shards and the module's
    parameter for the rest. The optimizer and the EMA take ``master``."""

    def __init__(self, live: dict, mesh):
        self.live, self.mesh = live, mesh
        # a list, in the parameters' order: every rank runs the gathers
        # in the same order
        self.sharded = sharded_names(live, mesh.model_size)
        self.model_mesh = mesh.device_mesh['model']
        self.master = {k: self._shard(v.detach()) if k in self.sharded else v
                       for k, v in live.items()}

    def _rows(self, t):
        n = t.shape[0] // self.mesh.model_size
        return slice(self.mesh.model_rank * n, (self.mesh.model_rank + 1) * n)

    def _shard(self, full: torch.Tensor) -> DTensor:
        """A dim-0 shard of ``full`` (a copy) over the model sub-mesh."""
        local = full[self._rows(full)].clone()
        return DTensor.from_local(local, self.model_mesh, [Shard(0)],
                                  run_check=False)

    def reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """After the backward: every gradient averaged over the world, the
        sharded ones handed to their masters as shards; returns the global
        mean of ``loss``."""
        world = dist.get_world_size()
        loss = loss.detach().float()
        if world > 1:
            grads = [p.grad for p in self.live.values() if p.grad is not None]
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.reshape(1)])
            dist.all_reduce(flat)
            flat /= world
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            loss = flat[-1]
        for k in self.sharded:
            g = self.live[k].grad
            if g is not None:
                self.master[k].grad = self._shard(g)
        return loss

    @torch.no_grad()
    def gather(self) -> None:
        """The updated shards back into the modules' whole parameters."""
        for k in self.sharded:
            self.live[k].copy_(self.master[k].full_tensor())

    @torch.no_grad()
    def load_full(self, params: dict, ema: dict, ema_full: dict,
                  optimizer, opt_state: dict | None) -> None:
        """A one-device checkpoint's whole tensors into this state: the
        modules' parameters and the masters from ``params``, the EMA
        (``ema``, made from the masters) from ``ema_full``, and the
        optimizer from ``opt_state`` with each sharded parameter's state
        cut to its shard."""
        for k, p in self.live.items():
            p.copy_(params[k])
            if k in self.sharded:
                self.master[k].to_local().copy_(params[k][self._rows(p)])
            dst = ema[k].to_local() if k in self.sharded else ema[k]
            src = ema_full[k]
            dst.copy_(src[self._rows(src)] if k in self.sharded else src)
        if opt_state is None:
            return
        names = list(self.master)
        state = {}
        for idx, st in opt_state['state'].items():
            k = names[int(idx)]
            full_shape = self.live[k].shape
            state[idx] = {s: (self._shard(v) if k in self.sharded
                              and torch.is_tensor(v)
                              and v.shape == full_shape else v)
                          for s, v in st.items()}
        optimizer.load_state_dict({**opt_state, 'state': state})


def full_state(obj):
    """A copy of ``obj`` with every tensor whole and on the CPU (a
    ``DTensor`` all-gathered: every rank of its mesh must call this)."""
    if isinstance(obj, DTensor):
        obj = obj.full_tensor()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: full_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full_state(v) for v in obj)
    return obj
