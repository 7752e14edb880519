"""Waiting policies (paper Section 3).

The port's own copy of ``repro.core.waiting``, unchanged in behaviour: the
port imports nothing of ``repro``.

Three policies from the paper:

* ``spin``            - unbounded busy-wait (Test-Test-Set style).  Cheap
                        handoff, burns CPU, terrible when oversubscribed.
* ``park``            - immediately block on an OS primitive; frees the CPU
                        but every handoff pays a context-switch round trip.
* ``spin_then_park``  - spin for roughly one context-switch round trip, then
                        park (the paper's default for passive GCR threads,
                        Section 4.1).

The paper parks on futexes (Linux) / condvars (Solaris); we park on
``threading.Event`` which is futex-backed on Linux.  ``Pause()`` in the paper
maps to a bounded busy loop with periodic ``sleep(0)`` yields - under the GIL
a pure spin would starve the very thread we are waiting on, which corresponds
to the paper's observation that spinning contributes to preemption on
oversubscribed systems.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

# Rough analogue of a context-switch round trip, expressed in spin iterations.
# The paper sets the spin phase of spin-then-park to the context-switch cost
# (Section 3, citing [7]).
DEFAULT_SPIN_LIMIT = 512
# Yield to the scheduler every N spin iterations; under the GIL an unyielding
# spin loop would starve the signalling thread.
_YIELD_EVERY = 32

SPIN = "spin"
PARK = "park"
SPIN_THEN_PARK = "spin_then_park"
POLICIES = (SPIN, PARK, SPIN_THEN_PARK)


def pause() -> None:
    """The paper's ``Pause()`` - a polite single spin iteration."""
    # time.sleep(0) releases the GIL, the closest host analogue of the x86
    # PAUSE / SPARC MWAIT polite-spin hints the paper uses.
    time.sleep(0)


@dataclass
class WaitStats:
    """Bookkeeping for benchmarks (spin iterations vs. park events)."""

    spins: int = 0
    parks: int = 0
    unparks: int = 0


class Event:
    """A parkable flag: the ``event`` field of the queue Node (Figure 2).

    ``flag`` is readable without synchronization (paper Figure 3 line 12
    checks ``myNode->event`` with a plain load); ``wait`` implements the
    configured waiting policy; ``set`` publishes the flag and unparks.
    """

    __slots__ = ("flag", "_evt", "stats")

    def __init__(self) -> None:
        self.flag = 0
        self._evt = None  # lazily created; fast path never allocates
        self.stats = WaitStats()

    def set(self) -> None:
        self.flag = 1
        evt = self._evt
        if evt is not None:
            self.stats.unparks += 1
            evt.set()

    def wait(self, policy: str = SPIN_THEN_PARK,
             spin_limit: int = DEFAULT_SPIN_LIMIT) -> None:
        """Block (by the chosen policy) until ``set`` has been called."""
        if self.flag:
            return
        if policy == SPIN:
            i = 0
            while not self.flag:
                self.stats.spins += 1
                i += 1
                if i % _YIELD_EVERY == 0:
                    pause()
            return
        if policy == SPIN_THEN_PARK:
            for i in range(spin_limit):
                if self.flag:
                    return
                self.stats.spins += 1
                if i % _YIELD_EVERY == 0:
                    pause()
        # park phase (also the whole of the PARK policy)
        import threading

        if self._evt is None:
            # Benign race: set() may have fired between the flag check and
            # this allocation - re-check the flag after publishing the event.
            evt = threading.Event()
            self._evt = evt
        if self.flag:
            return
        self.stats.parks += 1
        while not self.flag:
            self._evt.wait(timeout=0.05)  # periodic re-check; defensive
