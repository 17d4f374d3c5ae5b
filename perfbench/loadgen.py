"""Open-loop HTTP load for an image endpoint, in a process of its own.

    python3 perfbench/loadgen.py '<json parameters>'

Parameters: ``seed``, ``rate`` (requests a
second), ``seconds`` (the window), ``arrival_seed``, ``sizes`` (LR sizes
[w, h] to draw from), ``labels`` (class labels to draw from), ``grace_s``
(how long past the window to wait for answers).

Every seed gets the same arrivals: n = rate x seconds requests whose gaps
are the n quantiles of an exponential of mean 1 / rate (a Poisson
process's gaps, without its count's noise) in one order fixed by
``arrival_seed``, the traffic's; the sizes and labels, in equal shares,
are shuffled by the run's seed. Request i's image is
``harness.photo(seed_of(seed, 'request', i), h, w)``, made and encoded as
PNG before the schedule starts, so the reference can make it again.

Each request is sent when due, on a thread of its own, whatever is still
outstanding, and timed from when it was due to the last byte of its
answer. Prints 'ready' once the images are made, starts the schedule when
a line with the endpoint's URL comes on standard input, and, at the end,
prints one
JSON line: per request its due time, latency, lateness, status and the
answer's bytes (base64).
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import math
import sys
import threading
import time
from pathlib import Path
from urllib.parse import urlparse

sys.path[:] = [p for p in sys.path
               if Path(p or '.').resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def schedule(p: dict) -> list:
    """[(due_s, (w, h), label)] of the window, in due order."""
    import numpy as np
    from perfbench.harness import seed_of
    n = max(int(round(p['rate'] * p['seconds'])), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / p['rate']
    gaps = np.random.default_rng(p['arrival_seed']).permutation(gaps)
    rng = np.random.default_rng(seed_of(p['seed'], 'schedule'))
    sizes = [p['sizes'][i % len(p['sizes'])] for i in range(n)]
    labels = [p['labels'][i % len(p['labels'])] for i in range(n)]
    sizes = [sizes[i] for i in rng.permutation(n)]
    labels = [labels[i] for i in rng.permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    return [(float(due[i]), tuple(sizes[i]), int(labels[i]))
            for i in range(n)]


def request_image(seed: int, i: int, size) -> bytes:
    from PIL import Image
    from perfbench.harness import photo, seed_of
    w, h = size
    buf = io.BytesIO()
    Image.fromarray(photo(seed_of(seed, 'request', i), h, w)).save(
        buf, format='PNG')
    return buf.getvalue()


def main() -> None:
    p = json.loads(sys.argv[1])
    sched = schedule(p)
    bodies = [request_image(p['seed'], i, s) for i, (_, s, _) in
              enumerate(sched)]
    results = [None] * len(sched)

    def send(i, t0):
        due, _, label = sched[i]
        sent = time.perf_counter()
        status, body = 0, b''
        try:
            conn = http.client.HTTPConnection(url.hostname, url.port,
                                              timeout=p['seconds']
                                              + p['grace_s'])
            conn.request('POST', f'{url.path}?label={label}', bodies[i],
                         {'Content-Type': 'image/png'})
            resp = conn.getresponse()
            body = resp.read()
            status = resp.status
            conn.close()
        except Exception as e:                          # noqa: BLE001
            print(f'request {i}: {e!r}', file=sys.stderr)
        done = time.perf_counter()
        r = {'i': i, 'due_s': due, 'status': status,
             'late_ms': (sent - t0 - due) * 1e3,
             'latency_ms': (done - t0 - due) * 1e3 if status == 200
             else math.inf}
        if status == 200:
            r['body'] = base64.b64encode(body).decode()
        results[i] = r

    print('ready', flush=True)
    url = urlparse(sys.stdin.readline().strip())
    t0 = time.perf_counter()
    threads = []
    for i, (due, _, _) in enumerate(sched):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=send, args=(i, t0), daemon=True)
        th.start()
        threads.append(th)
    deadline = t0 + p['seconds'] + p['grace_s']
    for th in threads:
        th.join(max(deadline - time.perf_counter(), 0.0))
    for i, r in enumerate(results):
        if r is None:                 # never answered within the grace
            results[i] = {'i': i, 'due_s': sched[i][0], 'status': 0,
                          'late_ms': 0.0, 'latency_ms': math.inf}
    print(json.dumps({'window_s': sched[-1][0], 'results': results}),
          flush=True)


if __name__ == '__main__':
    main()
