"""GCR-POD: pod-aware admission control (the GCR-NUMA analogue, Section 5).

The port's own copy of ``repro.core.pod_aware``, kept line for line in
behaviour.

On a multi-pod serving deployment, admitting streams from many pods into one
engine batch forces cross-pod KV traffic every decode step - the serving
equivalent of the paper's remote-socket cache misses.  GCR-POD applies the
paper's construction verbatim:

* one passive queue **per pod**;
* a **preferred pod**, rotated round-robin every ``pod_rotate_every``
  completions ("solely based on the number of lock acquisitions");
* a parked stream is **eligible** for admission iff it is on the preferred
  pod, or the preferred pod's queue is empty;

so the active set stays composed of same-pod streams, converting any
pod-oblivious engine scheduler into a pod-aware one.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from .admission import GCRAdmission, StreamState


class GCRPod(GCRAdmission):
    __slots__ = ("n_pods", "pod_rotate_every", "preferred", "pod_queues",
                 "pod_active", "stat_rotations")

    def __init__(self, active_limit: int, n_pods: int = 2,
                 promote_every: int = 64,
                 pod_rotate_every: int = 256) -> None:
        super().__init__(active_limit, promote_every)
        self.n_pods = n_pods
        self.pod_rotate_every = pod_rotate_every
        self.preferred = 0
        self.pod_queues: List[Deque[StreamState]] = [
            deque() for _ in range(n_pods)]
        # active streams per pod, maintained at the membership events so
        # active_pod_mix() is O(n_pods), not O(active), per decode step
        self.pod_active: List[int] = [0] * n_pods
        self.stat_rotations = 0

    # -- queue selection -----------------------------------------------------
    def _eligible_queue(self) -> Optional[Deque[StreamState]]:
        q = self.pod_queues[self.preferred]
        if q:
            return q
        for qq in self.pod_queues:
            if qq:
                return qq
        return None

    def _pop_head(self) -> Optional[StreamState]:
        q = self._eligible_queue()
        return q.popleft() if q else None

    def _admit_head(self) -> Optional[int]:
        sid = super()._admit_head()
        if sid is not None:
            self.pod_active[self.active[sid].pod] += 1
        return sid

    def _work_conserve(self) -> List[int]:
        # generic form: admission must go through _admit_head so the
        # preferred-pod queue selection and pod counts stay correct
        out = []
        while len(self.active) < self.active_limit:
            sid = self._admit_head()   # None <=> every pod queue is empty
            if sid is None:
                break
            out.append(sid)
        return out

    # -- overrides --------------------------------------------------------------
    def offer(self, stream_id: int, pod: int = 0) -> bool:
        st = StreamState(stream_id, pod % self.n_pods,
                         enqueued_at_step=self.step)
        eligible = (st.pod == self.preferred
                    or not self.pod_queues[self.preferred])
        if eligible and len(self.active) < self.active_limit:
            st.admitted_at_step = self.step
            self.active[stream_id] = st
            self.pod_active[st.pod] += 1
            self.stat_fast += 1
            return True
        self.pod_queues[st.pod].append(st)
        self.stat_parked += 1
        return False

    def release(self, stream_id: int) -> List[int]:
        st = self.active.pop(stream_id, None)
        if st is not None:
            self.pod_active[st.pod] -= 1
        self.completions += 1
        if self.last_demoted:           # reuse the (almost always) empty list
            self.last_demoted = []
        if self.pod_rotate_every and \
                self.completions % self.pod_rotate_every == 0:
            self.preferred = (self.preferred + 1) % self.n_pods
            self.stat_rotations += 1
        admitted = self._work_conserve()
        if self.promote_every and \
                self.completions % self.promote_every == 0 and \
                self.num_parked:
            admitted.extend(self.promote())
        return admitted

    def _maybe_demote(self, exclude: int):
        if len(self.active) <= self.active_limit:
            return None
        oldest = min(
            (s for s in self.active.values() if s.stream_id != exclude),
            key=lambda s: s.admitted_at_step, default=None)
        if oldest is None:
            return None
        self.active.pop(oldest.stream_id)
        self.pod_active[oldest.pod] -= 1
        oldest.demotions += 1
        oldest.enqueued_at_step = self.step
        self.pod_queues[oldest.pod].append(oldest)
        self.stat_demotions += 1
        self.last_demoted.append(oldest.stream_id)
        return oldest.stream_id

    def cancel(self, stream_id: int) -> None:
        for i, q in enumerate(self.pod_queues):
            self.pod_queues[i] = deque(s for s in q
                                       if s.stream_id != stream_id)

    def drain(self) -> None:
        self.active.clear()
        self.pod_active = [0] * self.n_pods
        for q in self.pod_queues:
            q.clear()

    @property
    def num_parked(self) -> int:
        return sum(len(q) for q in self.pod_queues)

    def active_pod_mix(self) -> float:
        """Fraction of active streams NOT on the majority pod (0 = pure)."""
        if not self.active:
            return 0.0
        return 1.0 - max(self.pod_active) / len(self.active)
