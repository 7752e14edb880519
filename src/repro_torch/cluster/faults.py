"""Fault injection and health response for the fleet loop (DESIGN.md 11).

The port's own copy of ``repro.cluster.faults``, unchanged in behaviour:
the port imports nothing of ``repro``.

Production fleets are mostly *partially* sick: the dangerous replica is
not the one that is gone but the one that is slow while its monitoring
still looks healthy (the "limplock").  GCR (arXiv 1905.10818) restricts
concurrency into a resource's *actual* capacity, and Malthusian Locks
(arXiv 1511.06035) shows that culling excess participants is what
prevents collapse; the fleet-level analogue modeled here is a router
that ejects limping replicas whose stale published gauges still look
rosy.

Three declarative fault kinds, scheduled in virtual time:

* ``Limplock``  - a replica's step cost silently inflates by ``factor``
  over ``[start_ms, end_ms)``.  Only the *latency* terms of its
  ``StepCostModel`` scale; KV geometry (``kv_bytes_per_tok``,
  ``hbm_budget``) is untouched, so every published gauge keeps its
  healthy meaning - the sickness is invisible except through time.
* ``Crash``     - the replica drops at ``at_ms``: in-flight streams are
  re-queued through the migration path or lost per ``policy``, its
  prefix cache dies, and (if ``restart_ms`` is set) it rejoins later
  with a cold cache.
* ``Blackout``  - the replica's publishes stop over ``[start_ms,
  end_ms)``; routers reading the bus see a frozen report whose
  ``age_ms`` only grows.  Paired with a limplock this is the classic
  blackhole: the frozen pre-fault report stays rosy while the replica
  crawls, and any router that trusts it routes traffic into a pit.

The response side is ``HealthPolicy``/``HealthEstimator``: a
publish-time EWMA of each replica's published completion *rate*
compared against the pool median, plus a staleness discount on
``ReplicaView.age_ms`` (a report nobody refreshes is not evidence of
health).  The estimator is deterministic - no RNG, evaluated only at
publish events, ties broken by replica index - and the fleet filters
its routable view list by the ejected set, so all six router policies
opt in through one seam.  ``HedgePolicy`` adds duplicate-issue
hedging: a request still unfinished ``delay_ms`` after its first route
is cloned onto a different replica, first completion wins, and the
loser is cancelled (``invariants.conserved_count`` extends request
conservation to the copy space).

**Zero-perturbation contract** (pinned by ``tests/test_faults.py``):
an empty ``FaultSchedule`` and ``health=None``/``hedge=None`` push no
events, consume no tie-break sequence numbers, and leave every seeded
trace bit-identical to a run without the feature - the same opt-in
rule as ``obs=``.  Everything here is a frozen dataclass of plain
data, so schedules pickle cleanly into ``benchmarks`` grid points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Limplock", "Crash", "Blackout", "FaultSchedule",
           "HedgePolicy", "HealthPolicy", "HealthEstimator"]


# ---------------------------------------------------------------------------
# declarative fault kinds
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Limplock:
    """Silent slowdown: step latency terms x ``factor`` over a window."""

    replica: int
    start_ms: float
    end_ms: float
    factor: float = 8.0

    def __post_init__(self) -> None:
        if self.replica < 0:
            raise ValueError("Limplock.replica must be >= 0")
        if not 0.0 <= self.start_ms < self.end_ms:
            raise ValueError("Limplock window needs 0 <= start_ms < end_ms")
        if self.factor <= 1.0:
            raise ValueError("Limplock.factor must be > 1 (it inflates)")


@dataclass(frozen=True)
class Crash:
    """Replica death at ``at_ms``; optional rejoin at ``restart_ms``.

    ``policy`` decides the fate of unfinished streams: ``"requeue"``
    sends them back through the router via the migration path (cold -
    a crash checkpoints nothing, so requeued streams restart decode
    from token zero), ``"lose"`` drops them (counted in
    ``stats["lost"]``; conservation still balances).
    """

    replica: int
    at_ms: float
    restart_ms: Optional[float] = None
    policy: str = "requeue"

    def __post_init__(self) -> None:
        if self.replica < 0:
            raise ValueError("Crash.replica must be >= 0")
        if self.at_ms < 0.0:
            raise ValueError("Crash.at_ms must be >= 0")
        if self.restart_ms is not None and self.restart_ms <= self.at_ms:
            raise ValueError("Crash.restart_ms must be > at_ms")
        if self.policy not in ("requeue", "lose"):
            raise ValueError(f"Crash.policy {self.policy!r} not in "
                             "('requeue', 'lose')")


@dataclass(frozen=True)
class Blackout:
    """Publish silence over ``[start_ms, end_ms)``: the bus keeps the
    last report and routers watch its ``age_ms`` grow."""

    replica: int
    start_ms: float
    end_ms: float

    def __post_init__(self) -> None:
        if self.replica < 0:
            raise ValueError("Blackout.replica must be >= 0")
        if not 0.0 <= self.start_ms < self.end_ms:
            raise ValueError("Blackout window needs 0 <= start_ms < end_ms")


# fixed op order at equal virtual time: off-edges release before
# on-edges grab, restarts land before a same-instant crash
_OP_ORDER = {"limp_off": 0, "black_off": 1, "restart": 2,
             "crash": 3, "limp_on": 4, "black_on": 5}


@dataclass(frozen=True)
class FaultSchedule:
    """The declarative fault plan one fleet run executes.

    Empty (the default) is the zero-perturbation case: ``events()``
    yields nothing and the run is bit-identical to ``faults=None``.
    """

    limplocks: Tuple[Limplock, ...] = ()
    crashes: Tuple[Crash, ...] = ()
    blackouts: Tuple[Blackout, ...] = ()

    def __post_init__(self) -> None:
        # tolerate lists in hand-written schedules; store plain tuples
        object.__setattr__(self, "limplocks", tuple(self.limplocks))
        object.__setattr__(self, "crashes", tuple(self.crashes))
        object.__setattr__(self, "blackouts", tuple(self.blackouts))

    def __bool__(self) -> bool:
        return bool(self.limplocks or self.crashes or self.blackouts)

    def events(self) -> List[Tuple[float, str, object]]:
        """Time-ordered ``(t_ms, op, fault)`` edges for the event heap.

        Blackout edges are included for the flight recorder's benefit
        only - the publish branch consults ``blackout_windows()``
        directly, so a blackout needs no state transition to act."""
        evs: List[Tuple[float, str, object]] = []
        for lp in self.limplocks:
            evs.append((lp.start_ms, "limp_on", lp))
            evs.append((lp.end_ms, "limp_off", lp))
        for cr in self.crashes:
            evs.append((cr.at_ms, "crash", cr))
            if cr.restart_ms is not None:
                evs.append((cr.restart_ms, "restart", cr))
        for bo in self.blackouts:
            evs.append((bo.start_ms, "black_on", bo))
            evs.append((bo.end_ms, "black_off", bo))
        evs.sort(key=lambda e: (e[0], _OP_ORDER[e[1]], e[2].replica))
        return evs

    def blackout_windows(self) -> Dict[int, Tuple[Tuple[float, float], ...]]:
        """Per-replica ``((start_ms, end_ms), ...)`` silence windows."""
        by_rep: Dict[int, List[Tuple[float, float]]] = {}
        for bo in self.blackouts:
            by_rep.setdefault(bo.replica, []).append(
                (bo.start_ms, bo.end_ms))
        return {i: tuple(sorted(w)) for i, w in by_rep.items()}


# ---------------------------------------------------------------------------
# response policies
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HedgePolicy:
    """Duplicate-issue hedging: a request unfinished ``delay_ms`` after
    its first route is cloned onto a different replica; the first copy
    to complete wins and the other is cancelled.  ``max_hedges`` bounds
    clones per request (one is the classic tail-tolerance setting)."""

    delay_ms: float = 400.0
    max_hedges: int = 1

    def __post_init__(self) -> None:
        if self.delay_ms <= 0.0:
            raise ValueError("HedgePolicy.delay_ms must be > 0")
        if self.max_hedges < 1:
            raise ValueError("HedgePolicy.max_hedges must be >= 1")


@dataclass(frozen=True)
class HealthPolicy:
    """Outlier-ejection thresholds for ``HealthEstimator``.

    A replica is ejected from the routable set when its EWMA published
    completion rate falls below ``rate_frac`` of the pool median (after
    ``min_reports`` rate samples), or when its report is older than
    ``stale_ms`` (0 disables the staleness check).  ``max_eject_frac``
    caps the ejected share of the live pool - the estimator never
    ejects everyone, mirroring GCR's rule that someone must hold the
    lock."""

    ewma_alpha: float = 0.3
    rate_frac: float = 0.5
    min_reports: int = 3
    stale_ms: float = 0.0
    max_eject_frac: float = 0.5

    def __post_init__(self) -> None:
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("HealthPolicy.ewma_alpha must be in (0, 1]")
        if not 0.0 < self.rate_frac < 1.0:
            raise ValueError("HealthPolicy.rate_frac must be in (0, 1)")
        if self.min_reports < 1:
            raise ValueError("HealthPolicy.min_reports must be >= 1")
        if self.stale_ms < 0.0:
            raise ValueError("HealthPolicy.stale_ms must be >= 0")
        if not 0.0 < self.max_eject_frac < 1.0:
            raise ValueError("HealthPolicy.max_eject_frac must be in (0, 1)")


class HealthEstimator:
    """Deterministic publish-time outlier detector over bus reports.

    State updates happen only at publish events (``observe``), and the
    ejected set is recomputed from scratch at each evaluation
    (``evaluate``) - a replica that starts publishing healthy numbers
    again is restored automatically.  No RNG anywhere; every ranking
    ties off by replica index, so a fixed seed gives a fixed ejection
    trace.  Requires a periodic bus (``staleness_ms > 0``): the live
    bus has no publish events to hang observations on.

    History lives in struct-of-arrays form (one float64/int64 slot per
    replica index, nan = no sample yet) so ``evaluate`` is a handful of
    vector ops instead of an O(N) Python scan per publish tick.  All
    arithmetic stays IEEE double either way, so every rate, EWMA and
    median is bit-identical to the former per-replica dict-of-floats
    representation.
    """

    __slots__ = ("policy", "ejected", "_t", "_done", "_ewma", "_n")

    def __init__(self, policy: HealthPolicy) -> None:
        self.policy = policy
        self.ejected: frozenset = frozenset()
        self._t = np.zeros(0)          # last publish time (nan = none)
        self._done = np.zeros(0, dtype=np.int64)   # completed at last pub
        self._ewma = np.zeros(0)       # EWMA completion rate (nan = none)
        self._n = np.zeros(0, dtype=np.int64)      # rate samples seen

    def _ensure(self, n: int) -> None:
        cur = len(self._n)
        if n <= cur:
            return
        pad = max(n - cur, cur, 8)
        self._t = np.concatenate([self._t, np.full(pad, np.nan)])
        self._done = np.concatenate(
            [self._done, np.zeros(pad, dtype=np.int64)])
        self._ewma = np.concatenate([self._ewma, np.full(pad, np.nan)])
        self._n = np.concatenate([self._n, np.zeros(pad, dtype=np.int64)])

    def rate_samples(self, idx: int) -> int:
        """Rate samples folded for ``idx`` (0 if never seen / forgotten)."""
        return int(self._n[idx]) if idx < len(self._n) else 0

    def has_history(self, idx: int) -> bool:
        """True when ``idx`` has any publish history on file."""
        if idx >= len(self._n):
            return False
        # nan-sentinel check: x == x is False only for nan
        return bool(self._t[idx] == self._t[idx]
                    or self._ewma[idx] == self._ewma[idx])

    def observe(self, idx: int, report, t_ms: float) -> None:
        """Fold replica ``idx``'s fresh publish into its EWMA rate."""
        self._ensure(idx + 1)
        prev_t = self._t[idx]
        prev_done = self._done[idx]
        self._t[idx] = t_ms
        self._done[idx] = report.completed
        if prev_t != prev_t:            # nan: first publish seen
            return
        dt = t_ms - prev_t
        if dt <= 0.0:
            return
        rate = (report.completed - prev_done) / dt * 1e3   # completions/s
        a = self.policy.ewma_alpha
        old = self._ewma[idx]
        self._ewma[idx] = (rate if old != old
                           else a * rate + (1 - a) * old)
        self._n[idx] += 1

    def forget(self, idx: int) -> None:
        """Drop replica ``idx``'s rate history (crash/restart boundary):
        the first post-restart sample would otherwise span the downtime
        gap and eject the cold rejoiner on sight."""
        if idx < len(self._n):
            self._t[idx] = np.nan
            self._done[idx] = 0
            self._ewma[idx] = np.nan
            self._n[idx] = 0

    def evaluate(self, t_ms: float, reports: Sequence,
                 live: Sequence[int],
                 report_t=None) -> Tuple[Tuple[int, ...],
                                         Tuple[int, ...]]:
        """Recompute the ejected set; returns ``(ejected, restored)``
        deltas relative to the previous evaluation.

        ``report_t`` may carry ``SignalBus.report_t`` (the numpy mirror
        of ``reports[i].t_ms``) so the staleness mask is one gather;
        omitted, the times are collected from ``reports`` - identical
        values by the bus mirror invariant."""
        p = self.policy
        nlive = len(live)
        live_a = np.asarray(live, dtype=np.intp)
        if nlive:
            self._ensure(int(live_a.max()) + 1)
        if report_t is None:
            rt = np.array([reports[i].t_ms for i in live],
                          dtype=np.float64)
        else:
            rt = np.asarray(report_t, dtype=np.float64)[live_a]
        if p.stale_ms > 0.0 and nlive:
            stale_m = (t_ms - rt) > p.stale_ms
        else:
            stale_m = np.zeros(nlive, dtype=bool)
        judged = live_a[~stale_m & (self._n[live_a] >= p.min_reports)]
        slow = judged[:0]
        if judged.size >= 2:
            r = np.sort(self._ewma[judged])
            mid = r.size // 2
            # exact legacy median spelling (mid element / 0.5*(a+b)), not
            # np.median, whose averaging could round differently
            median = (r[mid] if r.size % 2
                      else 0.5 * (r[mid - 1] + r[mid]))
            if median > 0.0:
                floor = p.rate_frac * median
                slow = judged[self._ewma[judged] < floor]
        # rank the accused: stalest report first, then slowest EWMA,
        # index breaking every tie; cap so someone always serves
        stale_i = live_a[stale_m]
        stale_i = stale_i[np.lexsort((stale_i, rt[stale_m]))]
        slow = slow[np.lexsort((slow, self._ewma[slow]))]
        cap = min(int(p.max_eject_frac * nlive), nlive - 1)
        accused = [int(i) for i in stale_i] + [int(i) for i in slow]
        new = frozenset(accused[:max(cap, 0)])
        old = self.ejected
        self.ejected = new
        return (tuple(sorted(new - old)), tuple(sorted(old - new)))
