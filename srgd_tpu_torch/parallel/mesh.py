"""Device mesh: one process per device through ``torch.distributed``.

Counterpart of ``srgd_tpu/parallel/mesh.py``. A mesh is (data, model): rank
r sits at data coordinate r // model and model coordinate r % model, the
row-major layout of ``make_mesh``'s device array. On the card each rank
owns the GPU ``cuda:LOCAL_RANK`` and talks NCCL; on the CPU each rank is a
gloo process.

- **data**: tiled sampling gives each data rank a contiguous block of the
  tile chunks (``diffusion.base.run_tile_chunks``) and all-gathers the
  results; training splits the global batch over it and averages the
  gradients.
- **model**: inference replicates the weights over it, so model ranks of
  one data coordinate compute the same chunks, as JAX's replicated weights
  do. Training keeps the master copy, the optimizer state and the EMA of the
  parameters ``param_spec`` selects as dim-0 shards over it
  (``train.sharded``); the forward sees whole weights.

The entry points start the ranks themselves (``launch``): under
``torchrun`` each process reads its environment; otherwise a mesh of more
than one rank is spawned with ``torch.multiprocessing`` (start method
``spawn``) around a ``file://`` store in a temporary directory, and a rank
that fails fails the whole command.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import pickle
import signal
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

AXES = ('data', 'model')
TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK')


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh. ``device_mesh`` is the
    ``torch.distributed`` DeviceMesh with axes ``AXES``; ``timeout_s`` the
    process group's timeout, which bounds every collective's wait."""
    shape: tuple
    device: torch.device
    rank: int
    device_mesh: object
    timeout_s: float = 1800.0

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape[1]

    @property
    def data_group(self):
        """The ranks of this model coordinate, one per data coordinate."""
        return self.device_mesh.get_group('data')

    @property
    def is_writer(self) -> bool:
        """Rank 0: the only rank that writes files or owns a front-end."""
        return self.rank == 0

    def gather_data_rows(self, local: torch.Tensor, counts) -> torch.Tensor:
        """Every data rank's rows, concatenated in data-rank order: data
        rank d holds ``counts[d]`` of them (this rank: ``local``). One
        all-gather, padded to the largest count; none at data size 1."""
        if self.data_size == 1:
            return local
        padded = local.new_zeros((max(counts), *local.shape[1:]))
        padded[:local.shape[0]] = local
        parts = [torch.empty_like(padded) for _ in range(self.data_size)]
        dist.all_gather(parts, padded, group=self.data_group)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    def all_ok(self, ok: bool) -> bool:
        """Whether every rank of this data group passed ``ok``: an
        all-reduce, so the group's ranks go on, or raise, together."""
        flag = torch.tensor([int(ok)], device=self.device)
        dist.all_reduce(flag, dist.ReduceOp.MIN, group=self.data_group)
        return bool(flag.item())


class MeshSampleError(RuntimeError):
    """A data rank failed its share of a sample, and every rank of its data
    group raised this at the same point: their collectives stay in step."""


def parse_shape(text: str):
    """'D,M' -> (D, M); '' -> None."""
    return tuple(int(x) for x in text.split(',')) if text else None


def device_count(device_type: str) -> int:
    """The devices a mesh spans: the visible GPUs on the card, the ranks of
    the process group on the CPU (one gloo process each)."""
    if device_type == 'cuda':
        return torch.cuda.device_count()
    return dist.get_world_size() if dist.is_initialized() else 1


def check_shape(shape, n: int):
    """``make_mesh``'s rule: every device on ``data`` by default, and the
    shape must cover exactly ``n`` devices."""
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    if shape[0] * shape[1] != n:   # JAX's assert, kept under python -O
        raise AssertionError(f'mesh {shape} != {n} devices')
    return shape


def make_mesh(shape=None, device_type: str = 'cuda',
              n_devices: int | None = None) -> Mesh:
    """This rank's ``Mesh`` of ``shape`` (default: every device on
    ``data``) over ``n_devices`` devices (default ``device_count``: JAX's
    ``devices=jax.devices()[:n]``). Needs the default process group, of
    one rank per device."""
    n = device_count(device_type) if n_devices is None else n_devices
    shape = check_shape(shape, n)
    world = dist.get_world_size()
    if world != n:
        raise AssertionError(
            f'mesh {shape} != {world} ranks in the process group')
    from torch.distributed.device_mesh import init_device_mesh
    device = (torch.device('cuda', torch.cuda.current_device())
              if device_type == 'cuda' else torch.device('cpu'))
    dm = init_device_mesh(device_type, shape, mesh_dim_names=AXES)
    return Mesh(shape, device, dist.get_rank(), dm)


def mesh_from_config(conf, device_type: str = 'cuda') -> Mesh:
    """``make_mesh`` of ``conf.mesh_shape`` ('D,M'; '' = the default)."""
    return make_mesh(parse_shape(conf.mesh_shape), device_type)


# ---------------------------------------------------------------------------
# Sharding rule
# ---------------------------------------------------------------------------

def param_spec(name_shape, tp: int):
    """JAX's tensor-parallel rule for one parameter, as placements over the
    ``model`` axis: a weight the JAX package calls a ``kernel`` is sharded
    on its output channels when their count divides by ``tp`` and is at
    least ``2 * tp``; everything else (biases, norms, embeddings) is
    replicated. ``name_shape``: (the JAX leaf name, ``checkpoint.jax_leaf``,
    the port's shape). The output channels are dim 0 here (OIHW convs,
    (out, in) linears), the last dim in JAX."""
    name, shape = name_shape
    if tp > 1 and name == 'kernel' and len(shape) >= 2 and \
            shape[0] % tp == 0 and shape[0] >= 2 * tp:
        return (Shard(0),)
    return (Replicate(),)


def partition_params(params: dict, tp: int) -> dict:
    """``param_spec`` of every entry of ``params`` (state-dict name ->
    tensor), by name."""
    from srgd_tpu_torch.checkpoint import jax_leaf
    return {k: param_spec((jax_leaf(k), tuple(v.shape)), tp)
            for k, v in params.items()}


def sharded_names(params: dict, tp: int) -> list:
    """The names ``partition_params`` shards."""
    return [k for k, spec in partition_params(params, tp).items()
            if isinstance(spec[0], Shard)]


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------

def under_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


def launch(fn, shape, device_type: str, args=(), *,
           n_devices: int | None = None, timeout_s: float = 1800.0,
           join_s: float | None = None, threads: int | None = None):
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh over
    ``n_devices`` devices (None: the default; see ``make_mesh``) and return
    this process's result: its own rank's under ``torchrun`` or in a mesh
    of one rank, which runs here; rank 0's (pickled back) when the ranks
    were spawned.

    A mesh of more than one rank outside ``torchrun`` is spawned (one
    process per rank, start method ``spawn``; SIGTERM and SIGINT are passed
    on to every rank) and joined within ``join_s`` seconds (None: no
    deadline; the leftover ranks are killed when it passes); a rank that
    fails raises here. A spawned rank starts with this process's float32
    precision settings (``float32_flags``). ``timeout_s`` is the process
    group's timeout; ``threads`` caps each rank's PyTorch threads."""
    if under_torchrun():
        return _rank_main(int(os.environ['LOCAL_RANK']), fn, shape,
                          device_type, 'env://', args, timeout_s, threads,
                          n_devices)
    if device_type == 'cuda':
        n = torch.cuda.device_count() if n_devices is None else n_devices
    else:
        n = math.prod(shape or (1,))
    world = math.prod(check_shape(shape, n))
    with tempfile.TemporaryDirectory(prefix='srgd_mesh_') as tmp:
        init = f'file://{os.path.join(tmp, "store")}'
        if world == 1:
            return _rank_main(0, fn, shape, device_type, init, args,
                              timeout_s, threads, 1)
        result = os.path.join(tmp, 'result.pkl')
        spawn(_spawned_rank, world, (fn, shape, device_type, init, args,
                                     timeout_s, threads, world, result,
                                     float32_flags()), join_s)
        if os.path.exists(result):
            with open(result, 'rb') as f:
                return pickle.load(f)
    return None


def spawn(fn, nprocs: int, args=(), join_s: float | None = None) -> None:
    """``fn(i, *args)`` in ``nprocs`` spawned processes; raises when one
    fails (the others are terminated) or when ``join_s`` passes first (all
    are killed). SIGTERM and SIGINT are passed on to every process."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method='spawn')

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev = {}
    if threading.current_thread() is threading.main_thread():
        prev = {s: signal.signal(s, forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    deadline = None if join_s is None else time.monotonic() + join_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f'{nprocs} ranks did not finish within '
                                   f'{join_s} s')
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def float32_flags() -> tuple:
    """This process's float32 precision settings: the matmul precision
    and whether cuDNN's convolutions may use TF32."""
    return (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


def _spawned_rank(local_rank, *args) -> None:
    """A spawned rank: ``_rank_main``, then out of the process at once.
    ``destroy_process_group`` leaves the process groups' gloo threads
    running for a while, and the interpreter's teardown then aborts the
    process now and then ('terminate called without an active exception',
    SIGABRT; about one world in 30 under load on the CPU) after the rank's
    result was written, which would fail a run that succeeded. So a rank
    that finished flushes its output and leaves with ``os._exit(0)``; one
    that raised takes ``torch.multiprocessing``'s error path."""
    _rank_main(local_rank, *args)
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _rank_main(local_rank, fn, shape, device_type, init_method, args,
               timeout_s, threads, n_devices, result=None, flags=None):
    """One rank: its device first, then the process group, the mesh and
    (on the card) the kernels, built by rank 0 while the others wait.
    Rank 0 pickles its result to ``result`` when that is given; ``flags``:
    the launching process's ``float32_flags``."""
    if threads is not None:
        torch.set_num_threads(threads)
    if flags is not None:
        torch.set_float32_matmul_precision(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
    if device_type == 'cuda':
        torch.cuda.set_device(local_rank)
    kw = {}
    if init_method != 'env://':
        kw = dict(rank=local_rank, world_size=math.prod(
            check_shape(shape, n_devices or math.prod(shape or (1,)))))
    dist.init_process_group('nccl' if device_type == 'cuda' else 'gloo',
                            init_method=init_method,
                            timeout=timedelta(seconds=timeout_s), **kw)
    try:
        mesh = dataclasses.replace(make_mesh(shape, device_type, n_devices),
                                   timeout_s=timeout_s)
        if device_type == 'cuda':
            if mesh.rank == 0:
                from srgd_tpu_torch.kernels import _build
                _build.build()
            barrier(mesh)
        out = fn(mesh, *args)
        if result is not None and mesh.rank == 0 and out is not None:
            with open(result, 'wb') as f:
                pickle.dump(out, f)
        return out
    finally:
        dist.destroy_process_group()


def barrier(mesh: Mesh) -> None:
    if mesh.device.type == 'cuda':
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """``obj`` from rank ``src`` on every rank (pickled)."""
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=src, device=mesh.device)
    return box[0]
