"""Atomic primitives used by the GCR algorithm (paper Figures 3-5).

The port's own copy of ``repro.core.atomics``, unchanged in behaviour: the
port imports nothing of ``repro``.

The paper's pseudocode relies on three hardware atomics:

* ``FAA``  - fetch-and-add   (Figure 3 line 5/20, Figure 4 line 31)
* ``SWAP`` - atomic exchange (Figure 5 line 39, the MCS-style tail push)
* ``CAS``  - compare-and-swap (Figure 5 lines 52-53, the tail/top pop dance)

CPython does not expose hardware atomics, so each atomic cell carries a tiny
private mutex.  This preserves the *semantics* (linearizable FAA/SWAP/CAS,
starvation-free assuming a fair scheduler - the premise of Theorem 7) at the
cost of some overhead; the discrete-event simulator in ``simulator.py`` is the
vehicle for faithful *performance* claims, while these real-thread primitives
back the framework's actual host-side concurrency.

All cells also expose a relaxed ``load``/``store`` - plain attribute access is
atomic under the GIL, matching the paper's use of plain loads for monitoring
(``numActive`` reads in Figure 3 line 3/17).
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class AtomicInt:
    """Linearizable integer cell with FAA / CAS / SWAP."""

    __slots__ = ("_value", "_mu")

    def __init__(self, value: int = 0) -> None:
        self._value = value
        self._mu = threading.Lock()

    # -- relaxed ops (plain, GIL-atomic) ------------------------------------
    def load(self) -> int:
        return self._value

    def store(self, value: int) -> None:
        # A racy store is acceptable wherever the paper uses a plain store
        # (e.g. resetting topApproved, Figure 3 line 19).
        with self._mu:
            self._value = value

    # -- atomic read-modify-write ops ---------------------------------------
    def faa(self, delta: int) -> int:
        """Fetch-and-add; returns the *previous* value (x86 XADD semantics)."""
        with self._mu:
            prev = self._value
            self._value = prev + delta
            return prev

    def cas(self, expected: int, new: int) -> bool:
        with self._mu:
            if self._value == expected:
                self._value = new
                return True
            return False

    def swap(self, new: int) -> int:
        with self._mu:
            prev = self._value
            self._value = new
            return prev

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"AtomicInt({self._value})"


class AtomicRef:
    """Linearizable reference cell (used for the queue ``top``/``tail``)."""

    __slots__ = ("_value", "_mu")

    def __init__(self, value: Optional[Any] = None) -> None:
        self._value = value
        self._mu = threading.Lock()

    def load(self) -> Optional[Any]:
        return self._value

    def store(self, value: Optional[Any]) -> None:
        with self._mu:
            self._value = value

    def cas(self, expected: Optional[Any], new: Optional[Any]) -> bool:
        """Identity-compare-and-swap (pointer equality, like the hardware op)."""
        with self._mu:
            if self._value is expected:
                self._value = new
                return True
            return False

    def swap(self, new: Optional[Any]) -> Optional[Any]:
        with self._mu:
            prev = self._value
            self._value = new
            return prev

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"AtomicRef({self._value!r})"
