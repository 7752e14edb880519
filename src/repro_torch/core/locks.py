"""Underlying locks that GCR wraps (the paper's LiTL lock zoo, Section 6).

The port's own copy of ``repro.core.locks``, unchanged in behaviour: the
port imports nothing of ``repro``.

The paper evaluates GCR over 24 lock/waiting-policy combinations from LiTL.
We implement the representative families it discusses by name:

* ``TTASLock``        - Test-Test-Set; global spinning, grossly unfair under
                        contention (Figure 1, Figure 6c).
* ``TASLock``         - plain Test-Set (the degenerate baseline).
* ``BackoffLock``     - TAS with exponential backoff (LiTL ``backoff``).
* ``TicketLock``      - FIFO global-spin ticket lock.
* ``MCSLock``         - queue lock with local spinning [Mellor-Crummey&Scott];
                        ``spin`` and ``spin_then_park`` waiting policies
                        (paper Figure 6a/6b).
* ``CLHLock``         - implicit-predecessor queue lock [Craig].
* ``PthreadMutexLock``- the OS-parking mutex (POSIX pthread_mutex analogue;
                        ``threading.Lock`` is futex-backed on Linux).
* ``MalthusianLock``  - MCS with built-in concurrency restriction [Dice'17],
                        the specialized competitor GCR is compared against
                        (Figure 6a/6b).

Every lock exposes the ``acquire()/release()`` duck type (plus context
manager), so GCR can wrap any of them - the paper's central "lock-agnostic"
requirement.  Conversely they can be used directly, giving the no-GCR
baselines.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .atomics import AtomicInt, AtomicRef
from .waiting import (DEFAULT_SPIN_LIMIT, PARK, SPIN, SPIN_THEN_PARK, Event,
                      pause)


class _LockBase:
    """Common context-manager plumbing + name for reports."""

    name = "lock"

    def acquire(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def release(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    # duck-type threading.Lock for drop-in use by the substrate
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# ---------------------------------------------------------------------------
# Global-spinning locks
# ---------------------------------------------------------------------------


class TASLock(_LockBase):
    name = "tas"

    def __init__(self) -> None:
        self._word = AtomicInt(0)

    def acquire(self) -> None:
        i = 0
        while self._word.swap(1):
            i += 1
            if i % 16 == 0:
                pause()

    def release(self) -> None:
        self._word.store(0)


class TTASLock(_LockBase):
    """Test-Test-Set: read until clear, then try the atomic swap."""

    name = "ttas"

    def __init__(self) -> None:
        self._word = AtomicInt(0)

    def acquire(self) -> None:
        i = 0
        while True:
            while self._word.load():
                i += 1
                if i % 16 == 0:
                    pause()
            if not self._word.swap(1):
                return

    def release(self) -> None:
        self._word.store(0)


class BackoffLock(_LockBase):
    """TAS with capped exponential backoff (LiTL ``backoff``)."""

    name = "backoff"

    def __init__(self, base: float = 1e-6, cap: float = 1e-3) -> None:
        self._word = AtomicInt(0)
        self._base = base
        self._cap = cap

    def acquire(self) -> None:
        delay = self._base
        while True:
            if not self._word.load() and not self._word.swap(1):
                return
            time.sleep(delay)
            delay = min(delay * 2, self._cap)

    def release(self) -> None:
        self._word.store(0)


class TicketLock(_LockBase):
    name = "ticket"

    def __init__(self) -> None:
        self._next = AtomicInt(0)
        self._serving = AtomicInt(0)

    def acquire(self) -> None:
        my = self._next.faa(1)
        i = 0
        while self._serving.load() != my:
            i += 1
            if i % 16 == 0:
                pause()

    def release(self) -> None:
        self._serving.faa(1)


# ---------------------------------------------------------------------------
# Queue locks (local spinning)
# ---------------------------------------------------------------------------


class _MCSNode:
    __slots__ = ("next", "event")

    def __init__(self) -> None:
        self.next: Optional[_MCSNode] = None
        self.event = Event()


class MCSLock(_LockBase):
    """Mellor-Crummey & Scott list-based queue lock.

    ``policy`` selects how waiters behave on their locally-spun flag:
    ``spin`` (LiTL ``mcs_spin``) or ``spin_then_park`` (``mcs_stp``) - the
    two variants contrasted in paper Figure 6(a)/(b).
    """

    def __init__(self, policy: str = SPIN,
                 spin_limit: int = DEFAULT_SPIN_LIMIT) -> None:
        self._tail = AtomicRef(None)
        self._policy = policy
        self._spin_limit = spin_limit
        self._tls = threading.local()
        self.name = f"mcs_{'stp' if policy == SPIN_THEN_PARK else policy}"

    def acquire(self) -> None:
        node = _MCSNode()
        self._tls.node = node
        prev: Optional[_MCSNode] = self._tail.swap(node)
        if prev is not None:
            prev.next = node
            node.event.wait(self._policy, self._spin_limit)

    def release(self) -> None:
        node: _MCSNode = self._tls.node
        succ = node.next
        if succ is None:
            if self._tail.cas(node, None):
                return
            while True:  # successor is mid-arrival (swapped tail, next unset)
                succ = node.next
                if succ is not None:
                    break
                pause()
        succ.event.set()


class _CLHNode:
    __slots__ = ("locked",)

    def __init__(self, locked: bool = False) -> None:
        self.locked = locked


class CLHLock(_LockBase):
    """Craig / Landin-Hagersten implicit queue lock (spin on predecessor)."""

    name = "clh"

    def __init__(self) -> None:
        self._tail = AtomicRef(_CLHNode(False))
        self._tls = threading.local()

    def acquire(self) -> None:
        node = _CLHNode(True)
        prev: _CLHNode = self._tail.swap(node)
        self._tls.node = node
        self._tls.prev = prev
        i = 0
        while prev.locked:
            i += 1
            if i % 16 == 0:
                pause()

    def release(self) -> None:
        node: _CLHNode = self._tls.node
        node.locked = False


class PthreadMutexLock(_LockBase):
    """OS-parking mutex - the POSIX pthread_mutex the paper interposes on."""

    name = "pthread"

    def __init__(self) -> None:
        self._mu = threading.Lock()

    def acquire(self) -> None:
        self._mu.acquire()

    def release(self) -> None:
        self._mu.release()


# ---------------------------------------------------------------------------
# Malthusian lock [Dice'17] - the specialized concurrency-restricting MCS
# variant the paper compares GCR against (Figure 6 a/b, Figure 8).
# ---------------------------------------------------------------------------


class MalthusianLock(_LockBase):
    """MCS with culling of excess waiters into a passive LIFO list.

    On unlock, waiters beyond the immediate successor are moved ("culled")
    to a passive list where they park; periodically one passive waiter is
    reinserted at the tail for long-term fairness.  Queue surgery is guarded
    by a small internal mutex - a simplification over Dice's lock-free
    version that preserves the admission semantics (only the culling path
    takes it, never the arrival fast path).
    """

    def __init__(self, policy: str = SPIN, reinsert_every: int = 64,
                 spin_limit: int = DEFAULT_SPIN_LIMIT) -> None:
        self._tail = AtomicRef(None)
        self._tls = threading.local()
        self._policy = policy
        self._spin_limit = spin_limit
        self._passive: list[_MCSNode] = []
        self._surgery = threading.Lock()
        self._releases = 0
        self._reinsert_every = reinsert_every
        self.name = f"malthusian_{'stp' if policy == SPIN_THEN_PARK else policy}"

    def acquire(self) -> None:
        node = _MCSNode()
        self._tls.node = node
        prev: Optional[_MCSNode] = self._tail.swap(node)
        if prev is not None:
            prev.next = node
            # Passive-listed waiters always park; the culler re-links them.
            node.event.wait(self._policy, self._spin_limit)

    def _cull(self, succ: _MCSNode) -> None:
        """Move everything after ``succ`` to the passive list."""
        with self._surgery:
            chain = succ.next
            if chain is None:
                return
            # Detach: try to swing tail back to succ. If new arrivals race,
            # give up culling this round (they will be culled later).
            cur_tail = self._tail.load()
            # Walk the chain to find its end; if the chain end is the tail we
            # can detach atomically.
            end = chain
            nodes = [chain]
            while end.next is not None:
                end = end.next
                nodes.append(end)
            if end is cur_tail and self._tail.cas(end, succ):
                succ.next = None
                self._passive.extend(nodes)

    def _reinsert_one(self) -> None:
        with self._surgery:
            if not self._passive:
                return
            node = self._passive.pop()  # LIFO, as in Dice'17
        # Re-arrive on behalf of the parked thread: splice its node at tail.
        node.next = None
        prev: Optional[_MCSNode] = self._tail.swap(node)
        if prev is not None:
            prev.next = node
        else:
            node.event.set()  # queue empty: it becomes the next owner

    def release(self) -> None:
        self._releases += 1
        node: _MCSNode = self._tls.node
        succ = node.next
        if succ is None:
            if self._tail.cas(node, None):
                if self._passive and self._releases % 2 == 0:
                    self._reinsert_one()
                return
            while True:
                succ = node.next
                if succ is not None:
                    break
                pause()
        if self._releases % self._reinsert_every == 0:
            self._reinsert_one()
        else:
            self._cull(succ)
        succ.event.set()


# ---------------------------------------------------------------------------
# Registry (mirrors LiTL's lock+policy naming)
# ---------------------------------------------------------------------------

LOCKS = {
    "tas": TASLock,
    "ttas": TTASLock,
    "backoff": BackoffLock,
    "ticket": TicketLock,
    "mcs_spin": lambda: MCSLock(SPIN),
    "mcs_stp": lambda: MCSLock(SPIN_THEN_PARK),
    "clh": CLHLock,
    "pthread": PthreadMutexLock,
    "malthusian_spin": lambda: MalthusianLock(SPIN),
    "malthusian_stp": lambda: MalthusianLock(SPIN_THEN_PARK),
}


def make_lock(name: str) -> _LockBase:
    try:
        return LOCKS[name]()
    except KeyError:
        raise ValueError(f"unknown lock {name!r}; available: {sorted(LOCKS)}")
