"""GCR-NUMA - NUMA-aware concurrency restriction (paper Section 5).

The port's own copy of ``repro.core.gcr_numa``, unchanged in behaviour:
the port imports nothing of ``repro``.

Differences from plain GCR:

* one passive queue *per socket* - a passive thread joins the queue of the
  socket it runs on;
* a *preferred socket*, rotated round-robin every ``socket_rotate_every``
  lock acquisitions (the paper rotates "solely based on the number of lock
  acquisitions");
* a passive thread is *eligible* (allowed to monitor the active-set size and
  to consume the ``topApproved`` promotion signal) iff it runs on the
  preferred socket, **or** the preferred socket's queue is empty;
* non-eligible queue heads do not touch the hot counters at all - the second
  "desired consequence" in Section 5 (less coherence traffic).

Net effect: the active set stays composed of same-socket threads, converting
any underlying lock into a NUMA-aware one.  Long-term fairness across sockets
comes from the rotation; within a socket, from FIFO + periodic promotion as
in plain GCR.
"""

from __future__ import annotations

import threading
from typing import Optional

from .atomics import AtomicInt, AtomicRef
from .gcr import (ENTER_THRESHOLD, JOIN_THRESHOLD, NEXT_CHECK_ACTIVE_CAP,
                  PROMOTE_THRESHOLD, Node)
from .topology import DEFAULT_TOPOLOGY, Topology
from .waiting import DEFAULT_SPIN_LIMIT, SPIN_THEN_PARK, pause


class _SocketQueue:
    """Per-socket MCS-like passive queue (same protocol as paper Figure 5)."""

    __slots__ = ("top", "tail")

    def __init__(self) -> None:
        self.top = AtomicRef(None)
        self.tail = AtomicRef(None)

    def push_self(self) -> Node:
        n = Node()
        prv: Optional[Node] = self.tail.swap(n)
        if prv is not None:
            n.prev = prv
            prv.next = n
        else:
            self.top.store(n)
            n.event.set()
        return n

    def pop_self(self, n: Node) -> None:
        succ = n.next
        if succ is None:
            if self.tail.cas(n, None):
                self.top.cas(n, None)
                return
            while True:
                succ = n.next
                if succ is not None:
                    break
                pause()
        self.top.store(succ)
        succ.event.set()

    def empty(self) -> bool:
        return self.top.load() is None


class GCRNuma:
    """NUMA-aware GCR wrapper; same lock duck type as ``GCR``."""

    def __init__(
        self,
        lock,
        topology: Topology = DEFAULT_TOPOLOGY,
        enter_threshold: int = ENTER_THRESHOLD,
        join_threshold: int = JOIN_THRESHOLD,
        promote_threshold: int = PROMOTE_THRESHOLD,
        socket_rotate_every: int = 0x1000,
        wait_policy: str = SPIN_THEN_PARK,
        spin_limit: int = DEFAULT_SPIN_LIMIT,
    ) -> None:
        self.lock = lock
        self.name = f"gcr_numa({getattr(lock, 'name', type(lock).__name__)})"
        self.topology = topology
        self.enter_threshold = enter_threshold
        self.join_threshold = join_threshold
        self.promote_threshold = promote_threshold
        self.socket_rotate_every = socket_rotate_every
        self.wait_policy = wait_policy
        self.spin_limit = spin_limit

        self.queues = [_SocketQueue() for _ in range(topology.n_sockets)]
        self.preferred = AtomicInt(0)
        self.top_approved = AtomicInt(0)
        self._ingress = AtomicInt(0)
        self._egress = 0
        self._num_acqs = 0
        self._next_check_active = 1

        self.stat_fast_path = 0
        self.stat_slow_path = 0
        self.stat_rotations = 0

    # -- helpers ---------------------------------------------------------------
    def num_active(self) -> int:
        return self._ingress.load() - self._egress

    def _eligible(self, socket: int) -> bool:
        """Paper Section 5: on the preferred socket, or its queue is empty."""
        pref = self.preferred.load()
        return socket == pref or self.queues[pref].empty()

    def queue_empty(self) -> bool:
        return all(q.empty() for q in self.queues)

    # -- lock API ----------------------------------------------------------------
    def acquire(self) -> None:
        socket = self.topology.socket_of_current_thread()

        # Only eligible threads may even *examine* the active-set size; the
        # rest go straight to their socket's passive queue (Section 5).
        if self._eligible(socket) and self.num_active() <= self.enter_threshold:
            self._ingress.faa(1)
            self.stat_fast_path += 1
            self.lock.acquire()
            return

        self.stat_slow_path += 1
        q = self.queues[socket]
        my_node = q.push_self()
        if not my_node.event.flag:
            my_node.event.wait(self.wait_policy, self.spin_limit)

        # Head of the socket queue: wait until eligible, then monitor the
        # active set exactly like plain GCR.
        local = 0
        while True:
            if self._eligible(socket):
                if self.top_approved.load():
                    break
                local += 1
                if local % self._next_check_active == 0:
                    if self.num_active() <= self.join_threshold:
                        self._next_check_active = 1
                        break
                    if self._next_check_active < NEXT_CHECK_ACTIVE_CAP:
                        self._next_check_active *= 2
            else:
                local += 1  # not eligible: poll preferred-socket designation
            pause()

        if self.top_approved.load():
            self.top_approved.store(0)
        self._ingress.faa(1)
        q.pop_self(my_node)
        self.lock.acquire()

    def release(self) -> None:
        self._num_acqs += 1
        # Rotate the preferred socket round-robin by acquisition count.
        if self._num_acqs % self.socket_rotate_every == 0:
            nxt = (self.preferred.load() + 1) % self.topology.n_sockets
            self.preferred.store(nxt)
            self.stat_rotations += 1
        # Promote the (eligible) queue head periodically, as in plain GCR.
        if (self._num_acqs % self.promote_threshold == 0 and
                not self.queue_empty()):
            self.top_approved.store(1)
        self._egress += 1
        self.lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def gcr_numa_wrap(lock, topology: Topology = DEFAULT_TOPOLOGY, **kw) -> GCRNuma:
    return GCRNuma(lock, topology=topology, **kw)
