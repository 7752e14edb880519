"""Deterministic sharded data pipeline with GCR-protected prefetch.

The port's own copy of ``repro.data.pipeline``, unchanged in behaviour:
batch ``i`` is the same numpy function of ``(seed, i)`` in both packages,
so both see identical tokens.  The pipeline yields numpy; the launcher
moves each batch to the device.

Production shape: a synthetic (seeded) token source stands in for a real
corpus reader; everything else is the real machinery -

* **determinism / resumability**: batch ``i`` is a pure function of
  (seed, i); the pipeline state is a single integer, checkpointed with the
  model and restored exactly on restart;
* **sharded host feeding**: ``global_batch(i)`` returns the full batch;
  ``host_shard(i, host_id, n_hosts)`` the per-host slice;
* **GCR-protected prefetch**: the prefetch queue is filled by worker
  threads that contend on a shared lock around the queue + RNG state; that
  lock is wrapped with the paper's GCR (``gcr_wrap``), making the data path
  itself a consumer of the paper's mechanism (oversubscribed host
  threadpools are exactly the motivating scenario - DESIGN.md L0).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..config import ModelConfig, ShapeSpec
from ..core import gcr_wrap
from ..core.locks import TTASLock


@dataclass
class PipelineState:
    next_batch: int = 0


class SyntheticTokens:
    """Seeded synthetic LM batches (tokens/targets + frontend stubs)."""

    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 seed: int = 0) -> None:
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def global_batch_at(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        B, S = self.global_batch, self.seq_len
        cfg = self.cfg
        S_text = S - (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
        toks = rng.integers(0, cfg.vocab_size, (B, S_text + 1),
                            dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.frontend == "vision_stub":
            batch["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
        if cfg.frontend == "audio_stub":
            batch["frames"] = rng.standard_normal(
                (B, S // cfg.enc_seq_divisor, cfg.frontend_dim)
            ).astype(np.float32)
        return batch

    def host_shard(self, i: int, host_id: int, n_hosts: int
                   ) -> Dict[str, np.ndarray]:
        g = self.global_batch_at(i)
        per = self.global_batch // n_hosts
        lo, hi = host_id * per, (host_id + 1) * per
        return {k: v[lo:hi] for k, v in g.items()}


class PrefetchPipeline:
    """Multi-worker prefetch over a GCR-wrapped shared lock.

    Workers claim batch indices under the lock (the 'claim ticket' critical
    section), build batches outside it, and push into a bounded queue."""

    def __init__(self, source: SyntheticTokens, depth: int = 4,
                 workers: int = 2, start_at: int = 0,
                 use_gcr: bool = True) -> None:
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        base_lock = TTASLock()
        self.lock = gcr_wrap(base_lock, promote_threshold=256) \
            if use_gcr else base_lock
        self.state = PipelineState(next_batch=start_at)
        self._next_deliver = start_at
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(workers)]
        self._started = False

    def _worker(self) -> None:
        while not self._stop.is_set():
            self.lock.acquire()
            try:
                i = self.state.next_batch
                self.state.next_batch = i + 1
            finally:
                self.lock.release()
            batch = self.source.global_batch_at(i)
            while not self._stop.is_set():
                try:
                    self.q.put((i, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self) -> "PrefetchPipeline":
        if not self._started:
            for w in self._workers:
                w.start()
            self._started = True
        return self

    def __iter__(self) -> Iterator:
        self.start()
        # re-order: workers may finish out of order; deliver sequentially
        # from the delivery cursor (start_at, advanced by prior iteration) -
        # the first queue arrival need not be the lowest claimed index
        pending: Dict[int, Dict] = {}
        while True:
            i, batch = self.q.get()
            pending[i] = batch
            while self._next_deliver in pending:
                i = self._next_deliver
                self._next_deliver += 1
                yield i, pending.pop(i)

    def stop(self) -> None:
        self._stop.set()

    # -- checkpointable state ------------------------------------------------
    def snapshot(self) -> int:
        return self.state.next_batch

    @staticmethod
    def restore(source: SyntheticTokens, next_batch: int,
                **kw) -> "PrefetchPipeline":
        return PrefetchPipeline(source, start_at=next_batch, **kw)
