"""The serving daemon under open-loop HTTP load: ``srgd_tpu_torch.serve``'s
``Server`` and its HTTP front end in this process, the load generator
(``perfbench/loadgen.py``) in another.

Set-up: a YAML of the configuration written to ``TMPDIR``, the daemon's
``Server`` built from its own flag parser (``serve.parse_args``) with the
traffic's flags, the benchmark's weights made on the device from the seed
and loaded into its model, one warm sample per canvas batch size the
coalescer can form (the tile batches the traffic uses), one request
through HTTP, and the load generator's images. Window: the generator's
schedule; every request due in it is timed from when it was due to the
last byte of its PNG, a failed one counting as infinitely late. The
generator waits up to ``grace_s`` past the window for late answers.

A traced run keeps the window as it is and adds the program's spans of
its requests (``serve.queue_wait``, ``serve.coalesce_wait``) to the
record; every run puts the window's p90 there too. Once every answer is in, a segment of the same traffic follows,
``profile_after_s`` + ``profile_s`` long, with the profiler open over its
``profile_s``: closing the session and reducing its events stall the
daemon for tens of seconds, and that stall now falls on the segment's
requests, which are not timed.

Check: the coalesced samples are recorded as they happen (each batch's
noise seed, labels and rows, by a fingerprint of each row's condition); the
batches holding the requests drawn from the seed are sampled again by the
reference from the request images it makes itself (bucket pad, bicubic),
with the W8A8 quantization worked out again from the float weights, and
every PNG of those batches is compared with the reference's.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from perfbench import harness, program, tracing
from perfbench.reference import inputs as ref_inputs
from perfbench.reference.unet import Precision, RefUNet
from perfbench.reference.weights import make_weights


class BatchNoise:
    """The daemon's ``noise_for_seed``: each sample gets a generator of its
    own, seeded from the run's seed and the sample's count (the daemon
    would seed every coalesced sample alike); ``last`` is the seed handed
    out last."""

    def __init__(self, run_seed: int):
        self.run_seed, self.n, self.last = run_seed, 0, None

    def __call__(self, seed, device):
        self.last = harness.seed_of(self.run_seed, 'batch', self.n)
        self.n += 1
        return harness.SeededNoise(self.last, device)


def fingerprint(cond_row: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(cond_row, np.float32)
                        .tobytes()).hexdigest()


def server_args(tr: dict, yaml_path: str, device: str):
    from srgd_tpu_torch.serve import parse_args
    return parse_args([
        '-c', yaml_path, '-m', '', '--mode', 'http', '--port', '0',
        '--precision', tr['precision'], '--continuous_sampler',
        tr['sampler'], '--ddim_eta', str(tr['ddim_eta']),
        '--num_sample_steps', str(tr['num_sample_steps']),
        '--coalesce_window', str(tr['coalesce_window']),
        '--max_batch_images', str(tr['max_batch_images']),
        '--lr_bucket', str(tr['lr_bucket']), '--tile_size', str(tr['tile']),
        '--quantize_min_channels', str(tr['quantize_min_channels']),
        '--device', device])


def write_yaml(cfg: dict) -> str:
    """The configuration's YAML keys, in TMPDIR, for the daemon's -c."""
    fd, path = tempfile.mkstemp(suffix='.yaml', prefix='perfbench_')
    with os.fdopen(fd, 'w') as f:
        for k, v in cfg['yaml'].items():
            f.write(f'{k}: {json.dumps(v)}\n')
    return path


def setup(cell: dict, opts: dict):
    """(server, httpd, batches, capture, cfg): ``batches`` lists every
    coalesced sample (its noise seed, its rows' fingerprints); the sample
    numbered ``capture['batch']`` has each step's input and output tiles
    copied on the device into ``capture['steps']``; once
    ``capture['cpu']`` is set, the thread that samples moves itself onto
    that CPU at its next sample (``pinned_apart``)."""
    import torch
    tr = cell['traffic_data']
    cfg = program.apply_overrides(cell['config_data'], opts.get('overrides'))
    from srgd_tpu_torch.serve import Server
    harness.note(opts, 'program imported')
    yaml_path = write_yaml(cfg)
    try:
        noise = BatchNoise(opts['seed'])
        server = Server(server_args(tr, yaml_path, opts['device']),
                        noise_for_seed=noise)
    finally:
        os.unlink(yaml_path)
    sd = make_weights(cfg['reference'], harness.seed_of(opts['seed'], 'w'),
                      torch.device(opts['device']))
    harness.note(opts, 'daemon built')
    server.sampler.wrapper.net.load_state_dict(sd)
    del sd
    harness.note(opts, 'weights made and loaded')
    if opts.get('fault'):
        from perfbench.tests import faults
        faults.apply(opts['fault'], server.sampler)
    batches = []
    capture = {'batch': None, 'on': False, 'steps': [], 'cpu': None}
    plain = server.batcher.sample_batch

    def recorded(conds, labels):
        if capture['cpu'] is not None and \
                os.sched_getaffinity(0) != {capture['cpu']}:
            os.sched_setaffinity(0, {capture['cpu']})
        capture['on'] = len(batches) == capture['batch']
        try:
            out = plain(conds, labels)
        finally:
            capture['on'] = False
        batches.append({'noise_seed': noise.last,
                        'rows': [fingerprint(c) for c in conds]})
        return out
    server.batcher.sample_batch = recorded
    wrapper = server.sampler.wrapper
    plain_step = wrapper.p_sample_tiles

    def recorded_step(*a, **k):
        out = plain_step(*a, **k)
        if capture['on']:
            # (the step's input tiles, its output, log-SNR now and next,
            # as given: read by the check, after the window)
            capture['steps'].append((a[0].detach().clone(),
                                     out[0].detach().clone(), a[4], a[5]))
        return out
    wrapper.p_sample_tiles = recorded_step
    warm(server, tr, lambda w: harness.note(opts, w))
    harness.note(opts, 'warm')
    batches.clear()
    httpd = server.make_http_server()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return server, httpd, batches, capture, cfg


def warm(server, tr: dict, note=None) -> None:
    """Every tile batch the coalescer can form (1 to max_batch_images
    canvases of the bucket's size), by two steps of the daemon's sampler,
    then one whole request through its request path."""
    import torch
    from PIL import Image
    s = tr['lr_bucket'] * 4
    last2 = {'generation_start_steps': tr['num_sample_steps'] - 2}
    for b in range(1, tr['max_batch_images'] + 1):
        conds = np.zeros((b, s, s, 3), np.float32)
        server.sampler.sample(conds, np.zeros(b, np.int64), 0, last2)
        if note:
            note(f'warm batch {b}')
    server.super_resolve(Image.fromarray(
        np.zeros((tr['lr_bucket'],) * 2 + (3,), np.uint8)), seed=0)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def load_params(tr: dict, seed: int, rate: float, seconds: float) -> dict:
    """The load generator's parameters (``loadgen.py``) for the traffic."""
    return {'seed': seed, 'rate': rate, 'seconds': seconds,
            'arrival_seed': tr['arrival_seed'], 'sizes': tr['sizes'],
            'labels': tr['labels'], 'grace_s': tr['grace_s']}


def start_load(tr: dict, seed: int, rate: float, seconds: float):
    """The load generator's process, making its images; ``go(proc, port)``
    starts its schedule."""
    p = load_params(tr, seed, rate, seconds)
    return subprocess.Popen(
        [sys.executable, str(harness.ROOT / 'loadgen.py'), json.dumps(p)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def go(proc, port: int) -> None:
    line = proc.stdout.readline().strip()
    if line != 'ready':
        proc.kill()
        proc.wait()
        raise RuntimeError(f'load generator failed to start: {line!r}')
    proc.stdin.write(f'http://127.0.0.1:{port}/v1/sr\n')
    proc.stdin.flush()


def finish_load(proc, timeout: float) -> dict:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f'load generator exited {proc.returncode}')
    return json.loads(out.strip().splitlines()[-1])


def move_threads(pids, cpus: set) -> None:
    """Every thread of the processes ``pids`` onto ``cpus``."""
    for pid in pids:
        try:
            tids = os.listdir(f'/proc/{pid}/task')
        except OSError:                         # a process that has ended
            continue
        for tid in tids:
            try:
                os.sched_setaffinity(int(tid), cpus)
            except OSError:                     # a thread that has ended
                pass


@contextlib.contextmanager
def pinned_apart(capture: dict, proc):
    """The daemon's sampling thread on a CPU of its own, every other
    thread of this process and of the load generator (``proc``) on the
    rest (a thread started later takes its starter's CPUs); all back on
    every CPU at the end. The 25-step sample is bound by the host's
    launches, and the HTTP handlers' PNG work, the load generator's
    threads or a migration would otherwise share its core. Left as it is
    with fewer than 3 CPUs."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 3:
        yield
        return
    move_threads((os.getpid(), proc.pid), set(cpus[:-1]))
    capture['cpu'] = cpus[-1]
    try:
        yield
    finally:
        capture['cpu'] = None
        move_threads((os.getpid(),), set(cpus))


def kill(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


WAITS = ('serve.queue_wait', 'serve.coalesce_wait')


def span_ids() -> set:
    from srgd_tpu_torch.utils.profiling import SPANS
    return {e.id for e in SPANS.ring(WAITS[0])}


def record_waits(record, before: set, answered: int,
                 timeout: float = 10.0) -> None:
    """Each wait span (``WAITS``) of the requests answered since ``before``
    (the ids the rings held then) into ``record``, in ms. A request's spans
    are written just after its answer, so this waits, up to ``timeout``,
    until ``answered`` requests have them."""
    from srgd_tpu_torch.utils.profiling import SPANS
    end = time.perf_counter() + timeout
    while len(span_ids() - before) < answered and \
            time.perf_counter() < end:
        time.sleep(0.05)
    new = span_ids() - before
    for name in WAITS:
        for e in SPANS.ring(name):
            if e.id in new:
                record.span(name, e.seconds * 1e3)


def profile_segment(server, httpd, tr: dict, seed: int, rate: float,
                    record) -> None:
    """The traced part, after the window: the same traffic for
    ``profile_after_s`` + ``profile_s``, the profiler open over its last
    ``profile_s``, each forward marked on the device's timeline. Its
    requests are served and not timed."""
    import torch
    wrapper = server.sampler.wrapper
    wrapper.net_apply = tracing.ForwardMarks(
        torch, server.sampler.device).wrap(wrapper.net_apply)
    seconds = tr['profile_after_s'] + tr['profile_s']
    proc = start_load(tr, seed, rate, seconds)

    def work():
        opened = dict(server.batcher.stats)
        time.sleep(tr['profile_s'])
        for prefix, a, b in (('lead_', lead, opened),
                             ('traced_', opened, server.batcher.stats)):
            record.counters.update({prefix + k: v for k, v in
                                    batch_stats(a, b).items()})
    try:
        go(proc, httpd.server_address[1])
        lead = dict(server.batcher.stats)
        time.sleep(tr['profile_after_s'])
        tracing.profiled(torch, work, record)
        finish_load(proc, seconds + tr['grace_s'] + 60)
    finally:
        kill(proc)


def batch_stats(a: dict, b: dict) -> dict:
    """The batcher's counts from its stats ``a`` to ``b``: samples, the
    canvases they held, and how many closed full or on the coalescing
    deadline."""
    return {k: b[k] - a[k] for k in (
        'batches', 'batched_images', 'batches_closed_full',
        'batches_closed_deadline')}


def fill(c: dict, prefix: str = '') -> str:
    n = c[prefix + 'batches']
    return (f'{c[prefix + "batched_images"] / max(n, 1):.2f} canvases a '
            f'sample, {c[prefix + "batches_closed_full"]} of {n} closed '
            f'full, {c[prefix + "batches_closed_deadline"]} on the deadline')


def stop(server, httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    server.batcher.shutdown()


def release(server) -> None:
    import torch
    server.sampler.wrapper.net = server.sampler.wrapper.net_apply = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def cond_of(seed: int, i: int, size, tr: dict) -> np.ndarray:
    """The reference's condition of request i (the load generator's image,
    made again): bucket pad, x4 bicubic."""
    w, h = size
    lr = harness.photo(harness.seed_of(seed, 'request', i), h, w)
    return ref_inputs.upscale(ref_inputs.bucket_pad(lr, tr['lr_bucket']))


def served_pixels(body_b64: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(body_b64)))
                      .convert('RGB'))


INF = float('inf')


def check(cfg, tr, seed, batches, capture, results, device,
          control: bool = False) -> tuple:
    """(numbers, the control's numbers or None) of the captured sample.

    The reference follows the program step by step from the program's own
    state: at each step it takes the tiles the program denoised, makes its
    own condition (bucket pad, bicubic) and labels of the requests, runs its
    own U-Net (W8A8 worked out from the float weights, float32 otherwise)
    and its own DDIM update with the step's noise, and compares its next
    state with the program's. ``step_gap``: the worst step's RMS gap over
    the RMS of the reference's own step. The start and the end are checked
    exactly: ``start_gap``, the first step's input against the noise's init
    draw; ``png_gap``, the served PNGs against the program's last state,
    cropped and rounded by the reference (pixel levels). The control, the
    reference a precision down (int4 codes on the quantized convolutions,
    fp8 operands elsewhere), takes the program's place in the same
    steps."""
    import torch
    from perfbench.loadgen import schedule
    from perfbench.reference.sampler import log_snr_table, step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ('step_gap', 'start_gap', 'png_gap')
    bad = ({k: INF for k in names}, {'step_gap': INF} if control else None)
    sched = schedule(load_params(tr, seed, tr['rate'], tr['window_s']))
    requests = {fingerprint(cond_of(seed, i, size, tr)): i
                for i, (_, size, _) in enumerate(sched)}
    j = capture['batch']
    n = tr['num_sample_steps']
    if j is None or j >= len(batches) or len(capture['steps']) != n:
        return bad
    batch = batches[j]
    if not all(fp in requests for fp in batch['rows']):
        return bad
    idx = [requests[fp] for fp in batch['rows']]
    cond = torch.from_numpy(np.stack([cond_of(seed, i, sched[i][1], tr)
                                      for i in idx])).to(device) * 2 - 1
    cond = cond.permute(0, 3, 1, 2).contiguous()
    labels = torch.tensor([sched[i][2] for i in idx], device=device)
    sd = make_weights(cfg['reference'], harness.seed_of(seed, 'w'), device)
    nets = [RefUNet(cfg['reference'], sd)]
    if control:
        nets.append(RefUNet(cfg['reference'], sd, Precision('fp8', 7)))
    table = log_snr_table(n)
    noise = harness.SeededNoise(batch['noise_seed'], device)
    canvas = tuple(capture['steps'][0][0].shape)
    out = {'step_gap': 0.0,
           'start_gap': float(torch.max(torch.abs(
               capture['steps'][0][0] - noise.init(canvas))))}
    low_gap = 0.0
    for i, (x, nxt, ls, lsn) in enumerate(capture['steps']):
        ls, lsn = float(ls), float(lsn)
        if (x.shape[0] != len(idx) or ls != float(table[i])
                or lsn != float(table[i + 1])):
            return bad
        z = noise.step(i, canvas) if i < n - 1 else None
        t = torch.full((x.shape[0],), ls, device=device)
        xs = []
        with torch.no_grad():
            for net in nets:
                eps = net(x.permute(0, 3, 1, 2).contiguous(), t, cond,
                          labels).permute(0, 2, 3, 1)
                xs.append(step(x, eps, ls, lsn, z, tr['sampler'],
                               tr['ddim_eta']))

        def rel(a):
            return float(torch.sqrt(torch.mean((a - xs[0]) ** 2))
                         / torch.sqrt(torch.mean((xs[0] - x) ** 2)))
        out['step_gap'] = max(out['step_gap'], rel(nxt))
        if control:
            low_gap = max(low_gap, rel(xs[1]))
    final = ((torch.clamp(capture['steps'][-1][1], -1.0, 1.0) + 1.0) * 0.5
             ).cpu().numpy()
    served = {r['i']: r for r in results}
    png = 0
    for k, i in enumerate(idx):
        w, h = sched[i][1]
        ref = ref_inputs.to_uint8(final[k])[:h * 4, :w * 4]
        r = served.get(i)
        if r is None or r['status'] != 200:
            return bad
        got = served_pixels(r['body'])
        if got.shape != ref.shape:
            return bad
        png = max(png, int(np.abs(got.astype(np.int32)
                                  - ref.astype(np.int32)).max()))
    out['png_gap'] = float(png)
    return out, ({'step_gap': low_gap} if control else None)


def run(cell: dict, opts: dict) -> dict:
    import torch
    tr = cell['traffic_data']
    seed, trace = opts['seed'], opts['trace']
    rate = opts.get('rate', tr['rate'])
    seconds = opts['seconds']
    proc = start_load(tr, seed, rate, seconds)
    try:
        server, httpd, batches, capture, cfg = setup(cell, opts)
    except BaseException:
        kill(proc)
        raise
    capture['batch'] = 1 + harness.seed_of(seed, 'check') % 4
    cuda = torch.cuda.is_available() and opts['device'] != 'cpu'
    record = harness.Record()
    window = {'open': True}
    if trace:
        sample = server.sampler.sample

        def timed_sample(conds, *a, **k):
            t0 = time.perf_counter()
            out = sample(conds, *a, **k)
            if window['open']:
                record.span('sample', (time.perf_counter() - t0) * 1e3,
                            conds.shape[0])
            return out
        server.sampler.sample = timed_sample
    stats0 = dict(server.batcher.stats)
    before = span_ids()
    try:
        with pinned_apart(capture, proc):
            try:
                go(proc, httpd.server_address[1])
                harness.note(opts, 'load generator ready')
                setup_s = time.perf_counter() - opts['t_start']
                load = finish_load(proc, seconds + tr['grace_s'] + 60)
            finally:
                kill(proc)
            window['open'] = False
            window_stats = batch_stats(stats0, server.batcher.stats)
            record_waits(record, before,
                         sum(r['status'] == 200 for r in load['results']))
            if trace:
                profile_segment(server, httpd, tr, seed, rate, record)
    finally:
        stop(server, httpd)
    device = harness.device_info(torch, 1) if cuda else None
    release(server)

    results = load['results']
    lat = [r['latency_ms'] for r in results]
    failed = sum(r['status'] != 200 for r in results)
    record.counters.update(
        window_stats, chips=cell['chips'],
        steps_per_sample=tr['num_sample_steps'],
        late_ms_max=max((r['late_ms'] for r in results), default=0.0),
        request_p90_ms=harness.percentile(lat, 90))
    print(f'load generator: {len(results)} requests, {failed} failed, '
          f'latest send {record.counters["late_ms_max"]:.1f} ms after due; '
          f'window p50 {harness.percentile(lat, 50):.2f} ms, '
          f'p90 {harness.percentile(lat, 90):.2f} ms', file=sys.stderr)
    print(f'window: {fill(record.counters)}', file=sys.stderr)
    if 'traced_batches' in record.counters:
        print(f'segment before the profiler: '
              f'{fill(record.counters, "lead_")}; profiled part: '
              f'{fill(record.counters, "traced_")}', file=sys.stderr)
    tr_check = dict(tr, rate=rate, window_s=seconds)
    checks, control = check(cfg, tr_check, seed, batches, capture, results,
                            opts['device'], opts.get('control', False))
    return {'attempted': len(results), 'failed': failed, 'setup_s': setup_s,
            'e2e': {'request_p50_ms': harness.percentile(lat, 50)},
            'checks': checks, 'control': control, 'record': record,
            'device': device, 'served_batches': len(batches)}


def readings(cell: dict, opts: dict, control: bool) -> dict:
    """The numbers compared, for setting limits: a short window at the
    cell's load on a fresh set-up, the served PNGs against the reference,
    and with ``control`` the control's against the same reference."""
    tr = cell['traffic_data']
    o = dict(opts, trace=False, control=control, t_start=time.perf_counter(),
             seconds=opts.get('seconds') or tr['calibration_window_s'])
    res = run(cell, o)
    out = {'program': res['checks'], 'failed': res['failed'],
           'attempted': res['attempted']}
    if control:
        out['control'] = res['control']
    return out


def sweep(cell: dict, opts: dict, rates: list, seconds: float) -> list:
    """The load at each rate, on one set-up: completed requests a second,
    p50 and p90, and how the latency grew from the first third of the
    requests to the last (a growing backlog)."""
    tr = cell['traffic_data']
    server, httpd, _, capture, _ = setup(cell, opts)
    out = []
    try:
        for k, rate in enumerate(rates):
            proc = start_load(tr, harness.seed_of(opts['seed'], 'sweep', k),
                              rate, seconds)
            with pinned_apart(capture, proc):
                go(proc, httpd.server_address[1])
                res = finish_load(proc, seconds + tr['grace_s'] + 60)[
                    'results']
            lat = [r['latency_ms'] for r in res]
            third = max(len(lat) // 3, 1)
            done = [r for r in res if r['status'] == 200]
            span = max(r['due_s'] * 1e3 + r['latency_ms'] for r in done) / 1e3
            out.append({
                'rate': rate, 'requests': len(res), 'failed':
                len(res) - len(done), 'completed_per_s': len(done) / span,
                'p50_ms': harness.percentile(lat, 50),
                'p90_ms': harness.percentile(lat, 90),
                'first_third_mean_ms': float(np.mean(lat[:third])),
                'last_third_mean_ms': float(np.mean(lat[-third:]))})
            print(json.dumps(out[-1]), flush=True)
    finally:
        stop(server, httpd)
    return out
