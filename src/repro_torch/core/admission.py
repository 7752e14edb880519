"""GCR admission control for serving (DESIGN.md L1).

The port's own copy of ``repro.core.admission``, kept line for line in
behaviour (tests/test_torch_serving.py holds the two side by side).

The serving analogue of the paper's mechanism, stream-for-thread:

* the **engine batch** is the contended resource ("the lock");
* **active set** = request streams admitted into continuous batching,
  bounded by ``active_limit`` (the ``numActive <= threshold`` fast path) -
  in a real deployment the limit comes from KV-cache HBM and the decode
  latency SLO, exactly as the paper's limit comes from LLC/core capacity;
* **passive queue** = FIFO parking of excess streams (MCS-queue analogue;
  parked streams cost nothing, like parked threads freeing CPUs);
* **work conservation**: a slot freed by a completing stream is filled from
  the queue head immediately (the drained-active-set check);
* **long-term fairness**: every ``promote_every`` completions
  ("acquisitions"), the queue head is promoted even if the active set is
  full, and the oldest active stream is *demoted* (swapped out) to the queue
  tail - the serving form of GCR's periodic active/passive shuffle.
  Demotion = KV-cache swap-out, the continuous-batching preemption
  mechanism.

The class is event-loop friendly (non-blocking calls from the engine
scheduler); no OS threads involved.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass(slots=True)
class StreamState:
    stream_id: int
    pod: int = 0
    admitted_at_step: int = -1
    enqueued_at_step: int = 0
    demotions: int = 0


class GCRAdmission:
    """Generic concurrency restriction over request streams."""

    __slots__ = ("active_limit", "promote_every", "active", "queue",
                 "completions", "step", "last_demoted", "stat_fast",
                 "stat_parked", "stat_promotions", "stat_demotions")

    def __init__(self, active_limit: int, promote_every: int = 64) -> None:
        if active_limit < 1:
            raise ValueError("active_limit must be >= 1")
        self.active_limit = active_limit
        self.promote_every = promote_every
        self.active: Dict[int, StreamState] = {}
        self.queue: Deque[StreamState] = deque()
        self.completions = 0          # numAcqs analogue
        self.step = 0
        # streams demoted by the most recent release() - the engine reads
        # this instead of rescanning its active set per completion
        self.last_demoted: List[int] = []
        # telemetry
        self.stat_fast = 0
        self.stat_parked = 0
        self.stat_promotions = 0
        self.stat_demotions = 0

    # -- engine-facing API -----------------------------------------------------
    def offer(self, stream_id: int, pod: int = 0) -> bool:
        """New stream arrives.  True => admitted now (fast path)."""
        st = StreamState(stream_id, pod, enqueued_at_step=self.step)
        if len(self.active) < self.active_limit:
            st.admitted_at_step = self.step
            self.active[stream_id] = st
            self.stat_fast += 1
            return True
        self.queue.append(st)
        self.stat_parked += 1
        return False

    def release(self, stream_id: int) -> List[int]:
        """Stream completed.  Returns newly-admitted stream ids."""
        self.active.pop(stream_id, None)
        self.completions += 1
        if self.last_demoted:           # reuse the (almost always) empty list
            self.last_demoted = []
        admitted = self._work_conserve()
        if self.promote_every and \
                self.completions % self.promote_every == 0 and self.queue:
            admitted.extend(self.promote())
        return admitted

    def tick(self) -> None:
        self.step += 1

    def cancel(self, stream_id: int) -> None:
        """Remove a parked stream that no longer needs the resource."""
        self.queue = deque(s for s in self.queue
                           if s.stream_id != stream_id)

    def drain(self) -> None:
        """Evacuate all live state (active set + passive queues) - the
        replica behind this admission is being decommissioned.  Counters
        (completions/steps/stats) survive for telemetry."""
        self.active.clear()
        self.queue.clear()

    def _admit_head(self) -> Optional[int]:
        st = self._pop_head()
        if st is None:
            return None
        st.admitted_at_step = self.step
        self.active[st.stream_id] = st
        return st.stream_id

    def _pop_head(self) -> Optional[StreamState]:
        return self.queue.popleft() if self.queue else None

    def _work_conserve(self) -> List[int]:
        # the per-completion fast path: admit queue heads straight into
        # free slots (GCRPod re-generalizes this over its pod queues)
        out = []
        active, queue, limit = self.active, self.queue, self.active_limit
        while queue and len(active) < limit:
            st = queue.popleft()
            st.admitted_at_step = self.step
            active[st.stream_id] = st
            out.append(st.stream_id)
        return out

    def promote(self) -> List[int]:
        """Periodic shuffle: admit the queue head; demote the oldest active
        stream if the set is over the limit (swap-out)."""
        sid = self._admit_head()
        if sid is None:
            return []
        self.stat_promotions += 1
        demoted = self._maybe_demote(exclude=sid)
        return [sid] if demoted is None else [sid]

    def _maybe_demote(self, exclude: int) -> Optional[int]:
        if len(self.active) <= self.active_limit:
            return None
        oldest = min(
            (s for s in self.active.values() if s.stream_id != exclude),
            key=lambda s: s.admitted_at_step, default=None)
        if oldest is None:
            return None
        self.active.pop(oldest.stream_id)
        oldest.demotions += 1
        oldest.enqueued_at_step = self.step
        self.queue.append(oldest)
        self.stat_demotions += 1
        self.last_demoted.append(oldest.stream_id)
        return oldest.stream_id

    # -- introspection -----------------------------------------------------------
    @property
    def num_active(self) -> int:
        return len(self.active)

    @property
    def num_parked(self) -> int:
        return len(self.queue)


class NoAdmission:
    """Baseline: admit everything (the 'no GCR' engine)."""

    __slots__ = ("active", "step")

    last_demoted: tuple = ()          # never demotes; engine skips the scan

    def __init__(self) -> None:
        self.active: Dict[int, StreamState] = {}
        self.step = 0

    def offer(self, stream_id: int, pod: int = 0) -> bool:
        self.active[stream_id] = StreamState(stream_id, pod,
                                             admitted_at_step=self.step)
        return True

    def release(self, stream_id: int) -> List[int]:
        self.active.pop(stream_id, None)
        return []

    def tick(self) -> None:
        self.step += 1

    def drain(self) -> None:
        self.active.clear()

    @property
    def num_active(self) -> int:
        return len(self.active)

    @property
    def num_parked(self) -> int:
        return 0
