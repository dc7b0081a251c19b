"""Synthetic LM token pipeline: seeded, shard-aware, prefetching.  A
numpy copy of the JAX package's ``data/lm_pipeline.py``: the same
batches bit for bit.

Real corpora are unavailable offline; the stream is a Zipf-distributed
token source with local n-gram structure (a repeated-phrase process) so
losses actually decrease during the example runs.  Determinism contract:
``batch(step, host_id)`` is a pure function — any host (or a restarted
one) regenerates exactly its shard, which is what makes checkpoint/restart
bit-exact without data-state checkpoints.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

__all__ = ["LMDataConfig", "LMPipeline", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int            # per-host batch
    seq_len: int
    seed: int = 0
    zipf_s: float = 1.1
    phrase_len: int = 8
    n_hosts: int = 1
    host_id: int = 0


class LMPipeline:
    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        probs = np.arange(1, cfg.vocab + 1, dtype=np.float64) ** (-cfg.zipf_s)
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.n_hosts + cfg.host_id)
        n_phrases = cfg.seq_len // cfg.phrase_len + 1
        heads = rng.choice(cfg.vocab, size=(cfg.batch, n_phrases),
                           p=self._probs)
        # phrase structure: token_{i+1} = (head*31 + i*7) % vocab
        off = np.arange(cfg.phrase_len)
        toks = (heads[:, :, None] * 31 + off[None, None, :] * 7) % cfg.vocab
        toks = toks.reshape(cfg.batch, -1)[:, :cfg.seq_len + 1]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((cfg.batch, cfg.seq_len), np.int32),
        }


class Prefetcher:
    """Background-thread prefetch (depth-N) over any step->batch source."""

    def __init__(self, fn, depth: int = 2, start_step: int = 0):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._fn(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self):
        step, b = self._q.get()
        return step, b

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)
