"""Serving daemon of the PyTorch port: the flag surface of ``srgd_tpu.serve``.

    python -m srgd_tpu_torch.serve -c conf.yaml -m ckpt.pth --mode http \\
        [--port 8471 --lr_bucket 64 --coalesce_window 0.5 --device cuda ...]

It loads the model once, keeps it resident on the device, and serves through
either front-end, or both at once:

- **watch**: polls ``--input_dir`` and writes 4x outputs to ``--output_dir``
  with the batch CLI's skip-existing and '.png' -> '_out.png' rules, so a
  pass is idempotent and resumable; a file that fails ``--max_failures``
  times in a row is quarantined and retried after ``--retry_after_polls``
  polls;
- **http**: ``POST /v1/sr`` (image body in, PNG out; query ``seed``,
  ``label``, and per-request guidance ``cond_scale`` or
  ``class_cond_scale``, not both), ``GET /healthz`` (503 ``stalled`` once a
  sample has run past ``--stall_timeout_seconds``), ``GET /stats`` and
  ``GET /metrics`` (Prometheus text, ``srgd_*``).

``/stats`` and ``/metrics`` count ``served`` images, ``errors``, ``mpix``
out, and ``sample_seconds``: each request's time from its submission to its
output, which for a coalesced request holds its waits in the queue and in
the coalescing window as well as the sample. With ``--coalesce_window``
they add the batcher's ``batches``, ``batched_images`` and why each batch
closed: ``batches_closed_full`` (``--max_batch_images`` reached),
``batches_closed_deadline`` (the window ran out) and
``batches_closed_mismatch`` (another canvas shape or label kind came next).
Each request is timed by stage, on the host clock, and each stage has a
total ``serve_<stage>_seconds`` and a count ``serve_<stage>_count`` of the
requests timed (the spans ``serve.<stage>`` of ``utils.profiling``, one
entry a request under its id and its batch's, written when it succeeds):

- ``decode``: the uploaded body, once read, to an RGB image;
- ``prepare``: the bucket pad and the bicubic upscale to the float
  condition;
- ``queue_wait``: from the batcher's queue to the worker taking the request
  (as a batch's head or member; a request that closed the previous batch
  by its geometry waits until it heads the next one);
- ``coalesce_wait``: from then until its batch's sample starts;
- ``sample``: the sample, whole, shared by the batch's requests;
- ``encode``: the crop back to 4x the upload and the PNG in memory;
- ``total``: from ``POST /v1/sr``'s handler entered to the response
  written.

Seeded, guided and watched requests bypass the batcher and have no
``queue_wait`` or ``coalesce_wait``; a watched file has neither ``decode``
nor ``total``, and its ``encode`` is the crop alone. The warm-up
(``--warmup_sizes``) writes none.

Inputs are reflect-padded to a multiple of ``--lr_bucket`` and the output is
cropped back, so requests of nearby sizes share one tile geometry.
Concurrent seedless unguided requests of one canvas shape and label kind
are stacked into one batched canvas (``--coalesce_window``), which pools
their tiles into the tile minibatch; a seeded request re-seeds and runs
alone (the reference's per-image re-seeding), and so does a guided one. One
sample runs at a time; health stays answerable while it does.

``--mesh D,M`` serves from D x M ranks, one process per device
(``parallel.mesh``): rank 0 owns the front-ends, the batcher and the
health endpoints, and before each sample sends (conds, labels, seed,
guidance) to the other ranks, which run a follower loop; every rank calls
``Sampler.sample``, whose data ranks split the tile chunks. While the
daemon idles, rank 0 sends a heartbeat every quarter of the process
group's timeout, so no follower's wait for the next sample reaches it. A
sample that one data rank fails is failed by all of them at one agreed
point, and the mesh serves on; any other failure inside a sample leaves
the ranks' collectives out of step, and the daemon stops with an error.
SIGTERM drains rank 0, which then sends the followers a stop message.
``/healthz`` and ``/stats`` report the mesh shape.

Port differences: ``--device`` (default cuda; cuda without a card raises).
``--precision`` is bf16 by default, which clears a YAML's ``quantize``;
``--precision int8`` and the ``--quant*`` flags are the batch CLI's
(``srgd_tpu_torch.infer``): the model is quantized, and calibrated with
``--quant_calibrate``, once at start-up. ``--exec_mode`` is accepted and not
read.
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import logging
import os
import queue
import signal
import threading
import time

import numpy as np
from torch.profiler import record_function

from srgd_tpu_torch.diffusion.base import GeneratorNoise
from srgd_tpu_torch.infer import add_quant_args, log_config
from srgd_tpu_torch.utils.profiling import SPANS

logger = logging.getLogger('srgd_tpu_torch.serve')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='srgd_tpu_torch serving daemon')
    p.add_argument('-c', '--conf', required=True)
    p.add_argument('-m', '--ckpt_path', type=str, required=True)
    p.add_argument('--mode', type=str, default='watch',
                   choices=['watch', 'http', 'both'])
    # watch front-end
    p.add_argument('--input_dir', type=str, default=None)
    p.add_argument('--output_dir', type=str, default=None)
    p.add_argument('--poll_interval', type=float, default=2.0)
    p.add_argument('--max_failures', type=int, default=3,
                   help='consecutive failures before a watched file is '
                        'quarantined')
    p.add_argument('--retry_after_polls', type=int, default=30,
                   help='polls after which a quarantined file is retried')
    # http front-end
    p.add_argument('--port', type=int, default=8471)
    p.add_argument('--host', type=str, default='127.0.0.1')
    # serving behaviour
    p.add_argument('--lr_bucket', type=int, default=64,
                   help='reflect-pad LR inputs up to a multiple of this many '
                        'pixels so requests share tile geometries (0 = off)')
    p.add_argument('--coalesce_window', type=float, default=0.0,
                   help='seconds to wait for same-geometry seedless requests '
                        'to sample as ONE batched canvas (0 = off); they '
                        'share the server seed\'s noise stream')
    p.add_argument('--max_batch_images', type=int, default=8,
                   help='cap on canvases coalesced into one batch')
    p.add_argument('--warmup_sizes', type=str, default='',
                   help="comma-separated square LR sizes to run once at "
                        "startup, e.g. '64,128'")
    # sampling knobs (same meaning as srgd_tpu_torch.infer)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--num_sample_steps', type=int, default=250)
    p.add_argument('--continuous_sampler', type=str, default=None,
                   choices=[None, 'ancestral', 'ddim', 'dpmpp'],
                   help='override the continuous-family sampler; the fast '
                        'profile is ddim with --ddim_eta 1.0 '
                        '--num_sample_steps 25')
    p.add_argument('--ddim_eta', type=float, default=None,
                   help='stochasticity of --continuous_sampler ddim (0 '
                        'deterministic, 1 the ancestral posterior variance)')
    p.add_argument('--tile_size', type=int, default=256)
    p.add_argument('--cond_scale', type=float, default=1.0)
    p.add_argument('--class_cond_scale', type=float, default=1.0)
    p.add_argument('--guidance_start_steps', type=int, default=0)
    p.add_argument('--class_guidance_start_steps', type=int, default=0)
    p.add_argument('--generation_start_steps', type=int, default=0)
    p.add_argument('--test_label', type=int, default=None)
    p.add_argument('--seed', type=int, default=71)
    p.add_argument('--interpolation', type=str, default='bicubic')
    p.add_argument('--exec_mode', type=str, default='host',
                   choices=['host', 'scan'],
                   help='accepted; the port always runs a Python step loop')
    p.add_argument('--precision', type=str, default='bf16',
                   choices=['fp32', 'bf16', 'int8'])
    add_quant_args(p)
    p.add_argument('--deep_cache', type=int, default=0,
                   help='>1: DeepCache sampling, the U-Net deep half '
                        'recomputed only every Nth step')
    p.add_argument('--deep_cache_depth', type=int, default=2)
    p.add_argument('--deep_cache_schedule', type=str, default='',
                   help="refresh positions as COUNTxINTERVAL segments, e.g. "
                        "'0.5x3/0.5x1'")
    p.add_argument('--mesh', type=str, default='')
    p.add_argument('--stall_timeout_seconds', type=float, default=600.0,
                   help='healthz answers 503 "stalled" once a device sample '
                        'has been in flight this long, so a liveness probe '
                        'can restart a wedged daemon; 0 disables')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device to run on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# Geometry bucketing
# ---------------------------------------------------------------------------

def bucket_pad(image, bucket: int):
    """Reflect-pad a PIL image up to the next multiple of ``bucket`` on each
    side. Returns (padded PIL image, (orig_w, orig_h))."""
    if bucket <= 0:
        return image, image.size
    from PIL import Image
    w, h = image.size
    bw = -(-w // bucket) * bucket
    bh = -(-h // bucket) * bucket
    if (bw, bh) == (w, h):
        return image, (w, h)
    arr = np.pad(np.asarray(image), ((0, bh - h), (0, bw - w), (0, 0)),
                 mode='reflect')
    return Image.fromarray(arr), (w, h)


def bucket_crop(sr_image, orig_size, scale: int = 4):
    """Crop a bucketed SR output back to scale * the original size."""
    w, h = orig_size
    if sr_image.size == (w * scale, h * scale):
        return sr_image
    return sr_image.crop((0, 0, w * scale, h * scale))


def _to_image(out):
    """(H, W, C) in [0, 1] -> uint8 PIL image, rounded as the batch CLI."""
    from PIL import Image
    return Image.fromarray(np.clip(np.round(out * 255.0), 0, 255)
                           .astype(np.uint8))


# ---------------------------------------------------------------------------
# Request spans
# ---------------------------------------------------------------------------

# a request's stages, each the span ``serve.<stage>`` (module docstring)
STAGES = ('decode', 'prepare', 'queue_wait', 'coalesce_wait', 'sample',
          'encode', 'total')
_request_ids = itertools.count()    # unique in the process


# ---------------------------------------------------------------------------
# Request coalescing
# ---------------------------------------------------------------------------

class _Request:
    def __init__(self, cond, label):
        self.cond = cond            # (1, H, W, C) float32 in [0, 1]
        self.label = label
        self.done = threading.Event()
        self.result = None
        self.error = None
        # host clock: queued, taken by the worker, its batch's sample
        self.put_at = self.taken_at = self.start_at = self.end_at = None
        self.batch = None


class BatchingQueue:
    """Coalesce same-geometry requests into one batched tiled sample.

    One worker thread takes the oldest request, waits up to ``window``
    seconds for more with the same canvas shape and label kind, stacks up to
    ``max_images`` of them and calls ``sample_batch(cond (B, H, W, C),
    labels (B,) or None)`` once.

    ``stats``: ``batches`` and ``batched_images``, and why each batch
    closed: ``batches_closed_full`` (``max_images`` reached),
    ``batches_closed_deadline`` (the window ran out) and
    ``batches_closed_mismatch`` (a request of another canvas shape or label
    kind came next; it heads the next batch). A batch is numbered by the
    count of batches before it."""

    def __init__(self, sample_batch, window: float, max_images: int):
        self.sample_batch = sample_batch
        self.window = window
        self.max_images = max_images
        self.q = queue.Queue()
        self.stats = {'batches': 0, 'batched_images': 0,
                      'batches_closed_full': 0, 'batches_closed_deadline': 0,
                      'batches_closed_mismatch': 0}
        self._stash = None          # first non-matching request, next head
        self._drain_lock = threading.Lock()   # submit may drain post-exit
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def submit(self, cond, label, trace=None):
        """Blocks until the batch holding this request ran; returns its
        (H, W, C) output or raises the batch's error. ``trace``
        (``utils.profiling.Trace``) gets the request's ``serve.queue_wait``
        (queued until the worker takes it), ``serve.coalesce_wait`` (taken
        until its batch's sample starts) and ``serve.sample``, and the
        batch's number."""
        if self.stop.is_set():
            raise RuntimeError('server shutting down')
        req = _Request(cond, label)
        req.put_at = time.perf_counter()
        self.q.put(req)
        # the worker may exit, and its final drain run, between the stop
        # check above and the put: poll, so such a request is failed too
        while not req.done.wait(0.5):
            if self.stop.is_set() and not self.thread.is_alive():
                self._fail_pending()
        if req.error is not None:
            raise req.error
        if trace is not None:
            trace.add('serve.queue_wait', req.taken_at - req.put_at)
            trace.add('serve.coalesce_wait', req.start_at - req.taken_at)
            trace.add('serve.sample', req.end_at - req.start_at)
            trace.batch = req.batch
        return req.result

    def shutdown(self):
        self.stop.set()
        self.q.put(None)            # wake the worker
        # the worker finishes its batch in flight, then only it may drain
        # (it owns _stash); samples can take minutes
        self.thread.join(timeout=600)
        self._fail_pending()

    def _fail_pending(self):
        """Fail every queued request so no submitter hangs. Called only once
        the worker has exited; the lock serialises late submitters."""
        with self._drain_lock:
            leftovers, self._stash = (
                [] if self._stash is None else [self._stash]), None
            while True:
                try:
                    r = self.q.get_nowait()
                except queue.Empty:
                    break
                if r is not None:
                    leftovers.append(r)
            for r in leftovers:
                r.error = RuntimeError('server shutting down')
                r.done.set()

    def _collect(self, head):
        group = [head]
        deadline = time.time() + self.window
        closed = 'deadline'
        while len(group) < self.max_images:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                req = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                closed = None       # shutdown: counted under no reason
                break
            if (req.cond.shape == head.cond.shape
                    and (req.label is None) == (head.label is None)):
                req.taken_at = time.perf_counter()
                group.append(req)
            else:   # another geometry or label kind heads the next group
                self._stash = req
                closed = 'mismatch'
                break
        if len(group) >= self.max_images:
            closed = 'full'
        if closed is not None:
            self.stats[f'batches_closed_{closed}'] += 1
        return group

    def _worker(self):
        while not self.stop.is_set():
            if self._stash is not None:
                # a stashed request waited in the queue's place until now
                head, self._stash = self._stash, None
            else:
                head = self.q.get()
            if head is None:
                continue
            if self.stop.is_set():
                self._stash = head   # _fail_pending picks it up
                break
            head.taken_at = time.perf_counter()
            # ranges on this thread: a profiler session that records every
            # thread (``torch.profiler._ExperimentalConfig(
            # profile_all_threads=True)``) names the device's idle gaps
            # between samples by them; the requests' spans are added in
            # ``submit``
            with record_function('serve.coalesce_wait'):
                group = self._collect(head)
            batch = self.stats['batches']
            try:
                conds = np.concatenate([r.cond for r in group], axis=0)
                labels = (None if group[0].label is None
                          else np.asarray([r.label for r in group], np.int32))
                start = time.perf_counter()
                with record_function('serve.sample'):
                    outs = self.sample_batch(conds, labels)
                end = time.perf_counter()
                for i, r in enumerate(group):
                    r.result = outs[i]
                    r.batch, r.start_at, r.end_at = batch, start, end
            except Exception as e:
                for r in group:
                    r.error = e
            finally:
                self.stats['batches'] += 1
                self.stats['batched_images'] += len(group)
                for r in group:
                    r.done.set()


# ---------------------------------------------------------------------------
# Server core
# ---------------------------------------------------------------------------

class Server:
    """The resident model and the counters that the front-ends share.

    ``noise_for_seed(seed, device)`` makes each sample's noise source
    (default ``GeneratorNoise``: one generator per sample, never shared);
    ``mesh``: this rank's ``parallel.mesh.Mesh`` under ``--mesh``."""

    mesh = None
    out_of_step = None   # under a mesh: the error that left the ranks out
                         # of step, after which the daemon stops

    def __init__(self, args, noise_for_seed=GeneratorNoise, mesh=None):
        from srgd_tpu_torch.infer import build_sampler
        self.args, self.mesh = args, mesh
        # the daemon has none of the batch CLI's kernel-set, matmul and
        # solver flags: it serves the default net
        sampler_args = argparse.Namespace(
            **vars(args), use_pallas=False, matmul_precision='default',
            use_dpmpp_solver=True)
        self.sampler = build_sampler(sampler_args, noise_for_seed, mesh=mesh)
        self.lock = threading.Lock()       # one sample in flight at a time
        self.stop = threading.Event()
        self.batcher = None
        if args.coalesce_window > 0:
            self.batcher = BatchingQueue(self._sample_batch,
                                         args.coalesce_window,
                                         args.max_batch_images)
        self.stats = {'served': 0, 'errors': 0, 'mpix': 0.0,
                      'sample_seconds': 0.0, 'started': time.time()}
        # counters are touched from the watch, http and batch threads
        self.stats_lock = threading.Lock()
        # wall time the sample in flight started, for stall detection: a
        # wedged device never returns, and the gauge is what alerts see
        self._sample_started = None
        # watch bookkeeping (watch thread only), pruned every pass to the
        # pending set so it stays bounded by the input backlog
        self.failed_inputs = {}   # filename -> consecutive failure count
        self.quarantined = {}     # filename -> poll index when quarantined
        self._poll_index = 0
        # under a mesh, rank 0's heartbeat to the followers
        self._closed = threading.Event()
        self._beat = None
        if mesh is not None and mesh.is_writer and \
                mesh.shape[0] * mesh.shape[1] > 1:
            self._beat = threading.Thread(target=self._heartbeat,
                                          daemon=True)
            self._beat.start()
        self.model_info = {
            'model': self.sampler.opts['model'],
            'num_sample_steps': args.num_sample_steps,
            'precision': args.precision, 'tile_size': args.tile_size,
            'lr_bucket': args.lr_bucket, 'device': str(self.sampler.device),
            'mesh': None if mesh is None else list(mesh.shape),
        }

    def bump_error(self):
        with self.stats_lock:
            self.stats['errors'] += 1

    def sample_inflight_seconds(self):
        with self.stats_lock:
            started = self._sample_started
        return (time.time() - started) if started else 0.0

    def stats_snapshot(self):
        """Counters for /stats (JSON) and /metrics (Prometheus text)."""
        with self.stats_lock:
            s = dict(self.stats)
        s['sample_inflight_seconds'] = round(self.sample_inflight_seconds(), 3)
        s['uptime_seconds'] = time.time() - s.pop('started')
        s['quarantined'] = len(self.quarantined)
        s['mesh'] = self.model_info['mesh']
        if self.batcher is not None:
            s.update(self.batcher.stats)
        for stage in STAGES:
            s[f'serve_{stage}_seconds'] = SPANS.totals.get(f'serve.{stage}',
                                                           0.0)
            s[f'serve_{stage}_count'] = SPANS.counts.get(f'serve.{stage}', 0)
        return s

    # -- one request -------------------------------------------------------
    def _timed_sample(self, conds, labels, seed, guidance=None):
        """Every sample goes through here, under the model lock, with the
        in-flight clock that /healthz and /metrics read."""
        with self.lock:
            if self.out_of_step is not None:
                raise RuntimeError('the mesh is out of step; the daemon is '
                                   'stopping') from self.out_of_step
            with self.stats_lock:
                self._sample_started = time.time()
            sent = self.mesh is None
            try:
                if not sent:
                    self._send(('sample', conds, labels, seed, guidance))
                    sent = True
                return self.sampler.sample(conds, labels, seed,
                                           guidance=guidance)
            except Exception as e:
                if self.mesh is not None and not (sent and self._in_step(e)):
                    logger.error('mesh out of step after %r; stopping', e)
                    self.out_of_step = e
                    self.stop.set()
                raise
            finally:
                with self.stats_lock:
                    self._sample_started = None

    # -- the mesh's other ranks -----------------------------------------
    def _send(self, msg):
        from srgd_tpu_torch.parallel.mesh import broadcast_object
        return broadcast_object(msg, self.mesh)

    def _in_step(self, error) -> bool:
        """Whether the ranks' collectives are still in step after a sample
        raised ``error``: it was raised by every data rank at one agreed
        point, or the sample ran no collective (data axis 1)."""
        from srgd_tpu_torch.parallel.mesh import MeshSampleError
        return isinstance(error, MeshSampleError) or \
            self.mesh.data_size == 1

    def _heartbeat(self):
        """Rank 0: a ping every quarter of the process group's timeout, so
        a follower's wait for the next message never reaches it."""
        while not self._closed.wait(self.mesh.timeout_s / 4):
            with self.lock:
                if not self._closed.is_set() and self.out_of_step is None:
                    self._send(('ping',))

    def follow(self):
        """A rank other than 0: run every sample rank 0 announces, until
        its stop message. A sample that fails in step with the other ranks
        is logged; any other failure ends the rank (and the command)."""
        while True:
            msg = self._send(None)
            if msg[0] == 'stop':
                return
            if msg[0] == 'ping':
                continue
            _, conds, labels, seed, guidance = msg
            try:
                self.sampler.sample(conds, labels, seed, guidance=guidance)
            except Exception as e:
                if not self._in_step(e):
                    raise
                logger.warning('sample failed on every rank: %r', e)

    def close(self):
        """Rank 0, once its front-ends have drained: the stop message, or,
        when a failure left the ranks out of step, an error that ends the
        command (the launcher then ends the other ranks)."""
        if self.mesh is None or not self.mesh.is_writer:
            return
        self._closed.set()
        with self.lock:
            if self.out_of_step is None:
                self._send(('stop',))
        if self._beat is not None:
            self._beat.join()
        if self.out_of_step is not None:
            raise RuntimeError('the mesh fell out of step') \
                from self.out_of_step

    def _sample_batch(self, conds, labels):
        """(B, H, W, C) in [0, 1] -> (B, 4H, 4W, C): the coalesced and watch
        batches, on one noise stream from the server seed."""
        return self._timed_sample(conds, labels, self.args.seed)

    def super_resolve(self, image, seed=None, test_label=None,
                      cond_scale=None, class_cond_scale=None, trace=None):
        """PIL image in -> 4x PIL image out, through the bucketed geometry.

        A request without a seed may be coalesced with concurrent ones; a
        seeded request runs alone and re-seeds, so its output depends only
        on its inputs. ``cond_scale`` / ``class_cond_scale`` override the
        daemon's guidance for this request, which then runs alone too.
        Guidance on both axes raises ValueError before any device work.

        The request's stages go into ``trace`` (``utils.profiling.Trace``),
        which the caller ends; without one, into a trace of its own in
        ``SPANS``, ended when the request succeeds."""
        from srgd_tpu_torch.infer import upscale_bicubic
        own = trace is None
        if own:
            trace = SPANS.trace(next(_request_ids))
        label = self.args.test_label if test_label is None else test_label
        guidance = {}
        if cond_scale is not None:
            guidance['cond_scale'] = float(cond_scale)
        if class_cond_scale is not None:
            guidance['class_cond_scale'] = float(class_cond_scale)
        eff_cond = guidance.get('cond_scale', self.args.cond_scale)
        eff_class = guidance.get('class_cond_scale',
                                 self.args.class_cond_scale)
        if eff_cond != 1.0 and eff_class != 1.0:
            raise ValueError('guidance on both axes is unsupported: pick '
                             'cond_scale or class_cond_scale, not both')
        with trace('serve.prepare'):
            padded, orig = bucket_pad(image, self.args.lr_bucket)
            upscaled = upscale_bicubic(padded, 4, self.args.interpolation)
            cond = np.asarray(upscaled, dtype=np.float32)[None] / 255.0

        t0 = time.time()
        if self.batcher is not None and seed is None and not guidance:
            out = self.batcher.submit(cond, label, trace)
        else:
            with trace('serve.sample'):
                out = self._timed_sample(
                    cond, label, self.args.seed if seed is None else seed,
                    guidance=guidance or None)[0]
        dt = time.time() - t0

        with trace('serve.encode'):
            sr = bucket_crop(_to_image(out), orig)
        if sr.size != (orig[0] * 4, orig[1] * 4):
            raise RuntimeError(f'output {sr.size} is not 4x {orig}')
        with self.stats_lock:
            self.stats['served'] += 1
            self.stats['mpix'] += sr.size[0] * sr.size[1] / 1e6
            self.stats['sample_seconds'] += dt
        if own:
            trace.end()
        return sr

    def warmup(self):
        """Run each --warmup_sizes geometry once; not counted as traffic."""
        from PIL import Image
        sizes = [int(s) for s in self.args.warmup_sizes.split(',') if s]
        with self.stats_lock:
            before = dict(self.stats)
        for s in sizes:
            logger.info('warmup: %dpx geometry', s)
            # a trace never ended: the warm-up writes no request spans
            self.super_resolve(Image.fromarray(np.zeros((s, s, 3), np.uint8)),
                               seed=0, trace=SPANS.trace())
        with self.stats_lock:
            self.stats.update(before)

    # -- watch front-end ---------------------------------------------------
    def _record_failure(self, filename):
        n = self.failed_inputs.get(filename, 0) + 1
        self.failed_inputs[filename] = n
        if n >= max(self.args.max_failures, 1):
            self.quarantined[filename] = self._poll_index
            logger.warning('%s failed %d consecutive times; quarantined, '
                           'retry in %d polls', filename, n,
                           self.args.retry_after_polls)

    def process_dir_once(self):
        """One pass over input_dir; returns the number of images written.

        Every pending file of the pass is grouped by bucketed geometry
        (sorted order within a group) and each group samples as batched
        canvases of up to --max_batch_images. A failure, an unreadable file
        among them, counts against each file of its batch; a file is
        quarantined after --max_failures in a row, retried after
        --retry_after_polls polls, and both maps are pruned to the pending
        set."""
        from srgd_tpu_torch.infer import pending_outputs, try_open_image
        a = self.args
        os.makedirs(a.output_dir, exist_ok=True)
        self._poll_index += 1
        done = 0

        pending = list(pending_outputs(a.input_dir, a.output_dir))
        live = {fn for fn, _ in pending}
        self.failed_inputs = {f: c for f, c in self.failed_inputs.items()
                              if f in live}
        self.quarantined = {f: p for f, p in self.quarantined.items()
                            if f in live}

        groups = {}     # bucketed geometry -> [(filename, save_path, image)]
        for filename, save_path in pending:
            if self.stop.is_set():
                break
            if filename in self.quarantined:
                if (self._poll_index - self.quarantined[filename]
                        < max(a.retry_after_polls, 1)):
                    continue
                del self.quarantined[filename]   # retry window reached
            image = try_open_image(filename)
            if image is None:
                logger.warning('unreadable input skipped: %s', filename)
                self._record_failure(filename)
                continue
            key = bucket_pad(image, a.lr_bucket)[0].size
            groups.setdefault(key, []).append((filename, save_path, image))

        cap = max(a.max_batch_images, 1)
        for items in groups.values():
            for i in range(0, len(items), cap):
                if self.stop.is_set():
                    break
                batch = items[i:i + cap]
                t0 = time.time()
                try:
                    srs = self._batched_super_resolve([b[2] for b in batch])
                except Exception:
                    self.bump_error()
                    for fn, _sp, _img in batch:
                        self._record_failure(fn)
                    logger.exception('failed batch of %d: %s',
                                     len(batch), [b[0] for b in batch])
                    continue
                dt = time.time() - t0
                with self.stats_lock:
                    self.stats['watch_batches'] = \
                        self.stats.get('watch_batches', 0) + 1
                for (fn, sp, _img), sr in zip(batch, srs):
                    sr.save(sp)
                    self.failed_inputs.pop(fn, None)
                    done += 1
                    logger.info('%s -> %s (batch of %d, %.2fs)', fn, sp,
                                len(batch), dt)
        return done

    def _batched_super_resolve(self, images):
        """PIL images of one bucketed geometry -> their 4x PIL images, by one
        batched tiled sample."""
        from srgd_tpu_torch.infer import upscale_bicubic
        traces = [SPANS.trace(next(_request_ids)) for _ in images]
        origs, conds = [], []
        for im, trace in zip(images, traces):
            with trace('serve.prepare'):
                padded, orig = bucket_pad(im, self.args.lr_bucket)
                origs.append(orig)
                conds.append(np.asarray(
                    upscale_bicubic(padded, 4, self.args.interpolation),
                    np.float32) / 255.0)
        conds = np.stack(conds)
        label = self.args.test_label
        labels = None if label is None else np.full(
            (len(images),), label, np.int32)
        t0 = time.time()
        with record_function('serve.sample'):
            outs = self._sample_batch(conds, labels)
        dt = time.time() - t0
        srs = []
        for out, orig, trace in zip(outs, origs, traces):
            with trace('serve.encode'):
                srs.append(bucket_crop(_to_image(out), orig))
            trace.add('serve.sample', dt)
            trace.end()
        with self.stats_lock:
            self.stats['served'] += len(images)
            self.stats['mpix'] += sum(s.size[0] * s.size[1]
                                      for s in srs) / 1e6
            self.stats['sample_seconds'] += dt
        return srs

    def watch_loop(self):
        logger.info('watching %s -> %s every %.1fs', self.args.input_dir,
                    self.args.output_dir, self.args.poll_interval)
        while not self.stop.is_set():
            try:
                self.process_dir_once()
            except Exception:
                self.bump_error()
                logger.exception('watch pass failed')
            self.stop.wait(self.args.poll_interval)

    # -- http front-end ----------------------------------------------------
    def metrics_text(self) -> str:
        """The stats snapshot in the Prometheus text format."""
        lines = []
        for k, v in sorted(self.stats_snapshot().items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            kind = ('gauge' if k in ('uptime_seconds', 'quarantined',
                                     'sample_inflight_seconds')
                    else 'counter')
            lines.append(f'# TYPE srgd_{k} {kind}')
            lines.append(f'srgd_{k} {float(v):g}')
        lines.append('# TYPE srgd_busy gauge')
        lines.append(f'srgd_busy {int(self.lock.locked())}')
        return '\n'.join(lines) + '\n'

    def make_http_server(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):
                logger.debug('http: ' + fmt, *a)

            def _send(self, code, content_type, body):
                self.send_response(code)
                self.send_header('Content-Type', content_type)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code, obj):
                self._send(code, 'application/json', json.dumps(obj).encode())

            def do_GET(self):
                path = urlparse(self.path).path
                if path == '/healthz':
                    inflight = server.sample_inflight_seconds()
                    stall = server.args.stall_timeout_seconds
                    if stall and inflight > stall:
                        # a wedged device: fail liveness so an orchestrator
                        # restarts the daemon
                        self._json(503, {
                            'status': 'stalled',
                            'sample_inflight_seconds': round(inflight, 3),
                            **server.model_info})
                    else:
                        self._json(200, {'status': 'ok',
                                         'busy': server.lock.locked(),
                                         **server.model_info})
                elif path == '/stats':
                    self._json(200, server.stats_snapshot())
                elif path == '/metrics':
                    self._send(200, 'text/plain; version=0.0.4',
                               server.metrics_text().encode())
                else:
                    self._json(404, {'error': 'not found'})

            def do_POST(self):
                # a request's stages, written once its response is out;
                # a request that fails writes none
                trace = SPANS.trace(next(_request_ids))
                with trace('serve.total'):
                    ok = self._sr(trace)
                if ok:
                    trace.end()

            def _sr(self, trace) -> bool:
                path = urlparse(self.path)
                if path.path != '/v1/sr':
                    self._json(404, {'error': 'not found'})
                    return False
                q = parse_qs(path.query)
                try:
                    from PIL import Image
                    n = int(self.headers.get('Content-Length', 0))
                    body = self.rfile.read(n)
                    with trace('serve.decode'):
                        img = Image.open(io.BytesIO(body))
                        img = img.convert('RGB')
                except Exception as e:
                    server.bump_error()
                    self._json(400, {'error': f'bad image: {e}'})
                    return False
                try:
                    seed = int(q['seed'][0]) if 'seed' in q else None
                    label = int(q['label'][0]) if 'label' in q else None
                    cs = (float(q['cond_scale'][0])
                          if 'cond_scale' in q else None)
                    ccs = (float(q['class_cond_scale'][0])
                           if 'class_cond_scale' in q else None)
                except ValueError as e:
                    server.bump_error()
                    self._json(400, {'error': f'bad query param: {e}'})
                    return False
                try:
                    sr = server.super_resolve(img, seed=seed, test_label=label,
                                              cond_scale=cs,
                                              class_cond_scale=ccs,
                                              trace=trace)
                except ValueError as e:
                    # the request broke the contract (guidance on both
                    # axes): not a server fault
                    server.bump_error()
                    self._json(400, {'error': str(e)})
                    return False
                except Exception as e:
                    server.bump_error()
                    logger.exception('sr request failed')
                    self._json(500, {'error': str(e)})
                    return False
                with trace('serve.encode'):
                    buf = io.BytesIO()
                    sr.save(buf, format='PNG')
                    png = buf.getvalue()
                self._send(200, 'image/png', png)
                return True

        return ThreadingHTTPServer((self.args.host, self.args.port), Handler)


def main(argv=None):
    log_config()
    args = parse_args(argv)
    if args.mode in ('watch', 'both') and not (args.input_dir and args.output_dir):
        raise SystemExit('--mode watch requires --input_dir and --output_dir')
    if args.mesh:
        from srgd_tpu_torch.infer import resolve_device
        from srgd_tpu_torch.parallel.mesh import launch, parse_shape
        launch(_mesh_rank, parse_shape(args.mesh),
               resolve_device(args.device).type, (args,))
        return
    serve(Server(args))


def _mesh_rank(mesh, args):
    """One rank of ``--mesh``: rank 0 serves, the others follow."""
    log_config()
    server = Server(args, mesh=mesh)
    if not mesh.is_writer:
        # rank 0 drains on a signal and then stops the followers
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, signal.SIG_IGN)
        server.follow()
        return
    try:
        serve(server)
    finally:
        server.close()


def serve(server: Server) -> None:
    """Run the front-ends ``--mode`` names until SIGTERM/SIGINT, then
    drain."""
    args = server.args
    if args.warmup_sizes:
        server.warmup()

    def handle_term(signum, frame):
        logger.info('signal %d: shutting down', signum)
        server.stop.set()

    signal.signal(signal.SIGTERM, handle_term)
    signal.signal(signal.SIGINT, handle_term)

    httpd = None
    if args.mode in ('http', 'both'):
        httpd = server.make_http_server()
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        logger.info('http serving on %s:%d', *httpd.server_address[:2])

    if args.mode in ('watch', 'both'):
        server.watch_loop()
    else:
        server.stop.wait()

    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
    if server.batcher is not None:
        server.batcher.shutdown()
    logger.info('served %d images, %d errors', server.stats['served'],
                server.stats['errors'])


if __name__ == '__main__':
    main()
