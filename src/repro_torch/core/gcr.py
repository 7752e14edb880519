"""GCR - Generic Concurrency Restriction (paper Section 4, Figures 2-5).

The port's own copy of ``repro.core.gcr``, unchanged in behaviour: the
port imports nothing of ``repro``.

GCR wraps *any* lock exposing ``acquire``/``release`` and decides which
threads may proceed to the underlying lock (the *active* set) and which are
diverted into an MCS-like FIFO queue (the *passive* set):

Fast path (Figure 3, lines 2-6):
    if numActive <= enter_threshold:  FAA(numActive, +1); underlying.acquire()

Slow path (Figure 3, lines 8-21):
    push self onto the passive queue (SWAP on tail, Figure 5);
    wait (spin-then-park) until at the queue top;
    spin - with the deterministic back-off of Section 4.4 - monitoring
        topApproved (periodic promotion, long-term fairness) and
        numActive    (work conservation: if the active set drains, admit
                      yourself immediately so the lock never idles);
    FAA(numActive, +1); pop self; underlying.acquire()

Unlock (Figure 4):
    every PROMOTE_THRESHOLD acquisitions set topApproved (promote the head);
    decrement the active count; underlying.release()

Section 4.4 optimizations - all implemented and individually switchable:

* ``enter_threshold``/``join_threshold`` tuning (defaults 4 and 2, the
  paper's "reasonable compromise").
* split ingress/egress counters: ingress bumped with FAA on the way in,
  egress with a plain store on the way out (done while *holding* the lock,
  so a race-free plain increment) - halves atomic traffic per critical
  section.
* queue-head monitor back-off: the head re-reads the active-set size every
  ``nextCheckActive`` iterations, doubling up to 1M while the set stays
  populated, resetting to 1 on handoff - avoids coherence traffic on the
  hot counters.
* adaptive enable/disable ("chicken-and-egg", Section 4.4): a shared scan
  array of per-thread acquisition slots; after releasing, a thread scans it
  with exponentially-increasing periods and enables GCR for a lock observed
  with >= ``adaptive_enable_at`` simultaneous acquirers; GCR disables itself
  when the passive queue is empty and the active set is small.

Starvation-freedom (Theorem 7): preserved - the queue is FIFO (Lemmas 1-4),
the head is eventually promoted (Lemma 5: either topApproved fires after at
most PROMOTE_THRESHOLD acquisitions, or the active set drains), so every
passive thread eventually reaches the underlying lock's acquire.
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

from .atomics import AtomicInt, AtomicRef
from .waiting import DEFAULT_SPIN_LIMIT, SPIN_THEN_PARK, Event, pause

# Paper defaults.
PROMOTE_THRESHOLD = 0x4000      # Figure 4: THRESHOLD
ENTER_THRESHOLD = 4             # Section 4.4: passive-set entry threshold
JOIN_THRESHOLD = ENTER_THRESHOLD // 2   # Section 4.4: active-set join threshold
NEXT_CHECK_ACTIVE_CAP = 1 << 20  # Section 4.4: back-off cap (1M)


class Node:
    """Queue node (paper Figure 2) - one per slow-path acquisition."""

    __slots__ = ("next", "prev", "event")

    def __init__(self) -> None:
        self.next: Optional["Node"] = None
        self.prev: Optional["Node"] = None
        self.event = Event()


class _ScanArray:
    """Shared announcement array for adaptive GCR enablement (Section 4.4).

    Each thread owns a slot; before acquiring it writes the lock's identity,
    after releasing it clears the slot.  ``count(lock)`` is the periodic scan.
    """

    _SLOTS = 1024

    def __init__(self) -> None:
        self._slots: list = [None] * self._SLOTS
        self._ids = itertools.count()
        self._tls = threading.local()

    def _slot(self) -> int:
        s = getattr(self._tls, "slot", None)
        if s is None:
            s = next(self._ids) % self._SLOTS
            self._tls.slot = s
        return s

    def announce(self, lock: object) -> None:
        self._slots[self._slot()] = lock

    def clear(self) -> None:
        self._slots[self._slot()] = None

    def count(self, lock: object) -> int:
        return sum(1 for s in self._slots if s is lock)


_GLOBAL_SCAN = _ScanArray()


class GCR:
    """The GCR wrapper: ``GCR(underlying_lock)`` is itself a lock."""

    def __init__(
        self,
        lock,
        enter_threshold: int = ENTER_THRESHOLD,
        join_threshold: int = JOIN_THRESHOLD,
        promote_threshold: int = PROMOTE_THRESHOLD,
        wait_policy: str = SPIN_THEN_PARK,
        spin_limit: int = DEFAULT_SPIN_LIMIT,
        adaptive: bool = False,
        adaptive_enable_at: int = 4,
        scan_array: Optional[_ScanArray] = None,
    ) -> None:
        self.lock = lock
        self.name = f"gcr({getattr(lock, 'name', type(lock).__name__)})"
        self.enter_threshold = enter_threshold
        self.join_threshold = join_threshold
        self.promote_threshold = promote_threshold
        self.wait_policy = wait_policy
        self.spin_limit = spin_limit

        # Queue of passive threads (Figure 2).
        self.top = AtomicRef(None)
        self.tail = AtomicRef(None)
        self.top_approved = AtomicInt(0)

        # Split active-thread counter (Section 4.4): numActive = in - out.
        self._ingress = AtomicInt(0)
        self._egress = 0  # plain int: only ever bumped while holding the lock

        self._num_acqs = 0  # bumped in release() while holding the lock

        # Head-monitor back-off state (Section 4.4).
        self._next_check_active = 1

        # Adaptive enable/disable (Section 4.4).
        self.adaptive = adaptive
        self.adaptive_enable_at = adaptive_enable_at
        self._scan = scan_array if scan_array is not None else _GLOBAL_SCAN
        self._enabled = not adaptive
        self._tls = threading.local()  # per-thread scan period bookkeeping

        # Telemetry for benchmarks (racy counters; order-of-magnitude only).
        self.stat_fast_path = 0
        self.stat_slow_path = 0
        self.stat_promotions = 0

    # -- counters ------------------------------------------------------------
    def num_active(self) -> int:
        # The paper notes this read pair is not atomic; an estimate suffices.
        return self._ingress.load() - self._egress

    def queue_empty(self) -> bool:
        return self.top.load() is None

    # -- queue management (paper Figure 5) ------------------------------------
    def _push_self_to_queue(self) -> Node:
        n = Node()                                  # line 36-38
        prv: Optional[Node] = self.tail.swap(n)     # line 39 (SWAP)
        if prv is not None:
            n.prev = prv
            prv.next = n                            # line 41
        else:
            self.top.store(n)                       # line 43
            n.event.set()                           # line 44
        return n

    def _pop_self_from_queue(self, n: Node) -> None:
        succ = n.next                               # line 49
        if succ is None:
            # my node looks like the last in the queue
            if self.tail.cas(n, None):              # line 52 (CAS)
                self.top.cas(n, None)               # line 53 (CAS, no retry)
                return
            while True:                             # lines 57-61
                succ = n.next
                if succ is not None:
                    break
                pause()
        self.top.store(succ)                        # line 63
        succ.event.set()                            # line 65 (unpark)

    # -- lock API (paper Figures 3-4) ------------------------------------------
    def acquire(self) -> None:
        if self.adaptive:
            self._scan.announce(self.lock)
            if not self._enabled:
                # GCR disabled: bypass counting entirely (Section 4.4,
                # "reducing overhead on the fast path").
                self.lock.acquire()
                return

        if self.num_active() <= self.enter_threshold:       # line 3
            self._ingress.faa(1)                            # line 5 (FAA)
            self.stat_fast_path += 1
            self.lock.acquire()                             # line 23
            return

        self.stat_slow_path += 1
        my_node = self._push_self_to_queue()                # line 10
        if not my_node.event.flag:                          # line 12
            my_node.event.wait(self.wait_policy, self.spin_limit)

        # Monitor loop (lines 14-18) with the Section 4.4 back-off scheme.
        local = 0
        while not self.top_approved.load():
            local += 1
            if local % self._next_check_active == 0:
                if self.num_active() <= self.join_threshold:  # line 17
                    self._next_check_active = 1
                    break
                if self._next_check_active < NEXT_CHECK_ACTIVE_CAP:
                    self._next_check_active *= 2
            pause()                                          # line 15

        if self.top_approved.load():                        # line 19
            self.top_approved.store(0)
        self._ingress.faa(1)                                # line 20 (FAA)
        self._pop_self_from_queue(my_node)                  # line 21
        self.lock.acquire()                                 # line 23

    def release(self) -> None:
        # Figure 4. numAcqs is bumped while still holding the lock, so a
        # plain increment is race-free (matches the paper's non-atomic ++).
        self._num_acqs += 1
        if (self._num_acqs % self.promote_threshold == 0 and
                self.top.load() is not None):               # line 27
            self.top_approved.store(1)                      # line 29
            self.stat_promotions += 1
        self._egress += 1                                   # line 31 (split ctr)

        if self.adaptive:
            self._maybe_toggle()
            self._scan.clear()
        self.lock.release()                                 # line 33

    # -- adaptive enable/disable (Section 4.4) ---------------------------------
    def _maybe_toggle(self) -> None:
        if self._enabled:
            # Disabling is easy: queue empty and active set small.
            if (self._num_acqs % self.promote_threshold == 0 and
                    self.queue_empty() and self.num_active() <= 2):
                self._enabled = False
            return
        # Enabled=False: scan with exponentially increasing period.
        tls = self._tls
        n = getattr(tls, "acqs", 0) + 1
        tls.acqs = n
        next_scan = getattr(tls, "next_scan", 8)
        if n >= next_scan:
            tls.next_scan = min(next_scan * 2, 1 << 16)
            tls.acqs = 0
            if self._scan.count(self.lock) >= self.adaptive_enable_at:
                self._enabled = True

    # -- context manager -------------------------------------------------------
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def gcr_wrap(lock, **kwargs) -> GCR:
    """Interposition entry point - the LD_PRELOAD analogue.

    Any object with ``acquire``/``release`` (including ``threading.Lock``)
    becomes concurrency-restricted: ``lock = gcr_wrap(threading.Lock())``.
    """
    return GCR(lock, **kwargs)
