"""The one traffic generator: arrival schedules and the loops that drive
the service, read from a workload file's parameters.

Open loop (``"loop": "open"``): requests are due on a Poisson schedule
at ``rate_qps``, whatever the service does.  Every seed gets
the same multiset of gaps (drawn from the file's ``arrival_seed``) in
its own order, so seeds differ in order and not in load.  Closed loop
(``"loop": "closed"``): ``clients`` requests are in flight at once and
each completion sends that client's next.  Each request is one query
row drawn with replacement from the served slice of the query log.

The loops keep no future: a completion callback stamps the request's
slot in preallocated arrays, and keeps the result only of the requests
chosen for the check, so that the harness adds no live objects for the
interpreter's collector to walk while the window runs.
"""

from __future__ import annotations

import functools
import queue
import time

import numpy as np

CHUNK = 1 << 16
_FIELDS = (("row", np.int64, 0), ("due", np.float64, 0.0),
           ("sent", np.float64, 0.0), ("done", np.float64, np.nan),
           ("batch", np.int64, -1), ("cls", np.int64, -1),
           ("failed", bool, False), ("keep", bool, False))


def open_schedule(traffic: dict, seconds: float, rng) -> np.ndarray:
    """Due offsets (s) in [0, seconds) of an open loop's requests."""
    rate = float(traffic["rate_qps"])
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(traffic.get("arrival_seed", 0)).exponential(
        1.0 / rate, n)
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class Requests:
    """Per request (by send order): query row, due and send times,
    completion stamp, failure, batch and class from its result, and
    whether its result is kept for the check.  Only the sending thread
    adds requests; a completion writes its own slots."""

    def __init__(self, keep_chunk):
        self.n = 0
        self.keep_chunk = keep_chunk     # chunk index -> (CHUNK,) bool
        self.cols = {name: [] for name, _, _ in _FIELDS}
        self.kept: dict = {}

    def _grow(self) -> None:
        c = len(self.cols["row"])
        for name, dtype, fill in _FIELDS:
            self.cols[name].append(np.full(CHUNK, fill, dtype))
        self.cols["keep"][c][:] = self.keep_chunk(c)

    def submit(self, service, payloads, row: int, due: float, deadline_ms,
               done_q=None) -> None:
        i = self.n
        c, j = i // CHUNK, i % CHUNK
        if c == len(self.cols["row"]):
            self._grow()
        self.cols["row"][c][j] = row
        self.cols["due"][c][j] = due
        self.n = i + 1
        self.cols["sent"][c][j] = time.perf_counter()
        fut = service.submit(payloads[row], deadline_ms)
        fut.add_done_callback(functools.partial(self._done, i, done_q))

    def _done(self, i, done_q, fut) -> None:
        c, j = i // CHUNK, i % CHUNK
        self.cols["done"][c][j] = time.perf_counter()
        if fut.cancelled() or fut.exception() is not None:
            self.cols["failed"][c][j] = True
        else:
            res = fut.result()
            self.cols["batch"][c][j] = res["batch"]
            self.cols["cls"][c][j] = res["class"]
            if self.cols["keep"][c][j]:
                self.kept[i] = res
        if done_q is not None:
            done_q.put(i)

    def column(self, name: str) -> np.ndarray:
        return np.concatenate(self.cols[name])[:self.n]

    def arrays(self) -> dict:
        """Every column over the requests sent, as one array each."""
        return {name: np.concatenate(chunks)[:self.n] if chunks
                else np.zeros(0, dtype)
                for (name, dtype, _), chunks in zip(
                    _FIELDS, self.cols.values())}


def drive_open(service, payloads, traffic, t_start, warm_s, seconds, rng,
               keep=None):
    """Send the warm-up's schedule, then the window's, each request when
    it is due.  ``keep(due offsets, rows)`` -> bool mask of the requests
    whose results to keep.  Returns (requests, window start, end)."""
    due = np.concatenate([open_schedule(traffic, warm_s, rng),
                          warm_s + open_schedule(traffic, seconds, rng)])
    rows = rng.integers(0, len(payloads), due.shape[0])
    mask = (np.zeros(due.shape[0], bool) if keep is None
            else keep(due - warm_s, rows))
    mask = np.concatenate([mask, np.zeros(-len(mask) % CHUNK, bool)])
    reqs = Requests(lambda c: mask[c * CHUNK:(c + 1) * CHUNK])
    deadline = traffic.get("deadline_ms")
    for i in range(due.shape[0]):
        t = t_start + due[i]
        wait = t - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        reqs.submit(service, payloads, int(rows[i]), t, deadline)
    return reqs, t_start + warm_s, t_start + warm_s + seconds


def drive_closed(service, payloads, traffic, t_start, warm_s, seconds, rng,
                 keep=None):
    """``clients`` requests in flight; each completion sends its client's
    next request, until the window ends.  ``keep(chunk index)`` -> bool
    mask of a chunk of requests whose results to keep."""
    clients = int(traffic["clients"])
    done_q: queue.SimpleQueue = queue.SimpleQueue()
    reqs = Requests(keep or (lambda c: np.zeros(CHUNK, bool)))
    deadline = traffic.get("deadline_ms")
    t_end = t_start + warm_s + seconds

    def send():
        reqs.submit(service, payloads, int(rng.integers(0, len(payloads))),
                    time.perf_counter(), deadline, done_q)

    for _ in range(clients):
        send()
    while True:
        left = t_end - time.perf_counter()
        if left <= 0:
            break
        try:
            done_q.get(timeout=min(left, 0.05))
        except queue.Empty:
            continue
        send()
    return reqs, t_start + warm_s, t_end


LOOPS = {"open": drive_open, "closed": drive_closed}
