"""Replica metrics bus: stale, sampled occupancy signals (DESIGN.md 7).

The port's own copy of ``repro.cluster.signals``, unchanged in
behaviour: the port imports nothing of ``repro``.

The paper's GCR wrapper decides admission from cheap, slightly-stale
observations of the active set rather than a perfectly synchronized view,
and stays robust when those signals lag reality (Malthusian Locks makes
the same point for passivation policies).  A fleet router is in exactly
that position: a real load balancer scrapes per-replica metrics on a
period and routes on the last report it saw, not on the replica's state
this instant.  This module models that signal path:

* ``ReplicaReport``  - one replica's published occupancy/progress counters,
  stamped with the virtual time it was captured;
* ``SignalBus``      - holds the last published report per replica.  With
  ``period_ms > 0`` every consumer (router *and* autoscaler) reads
  replica-side state that is stale by up to one publish period, plus
  optional per-publish sampling jitter (seeded, deterministic); only the
  LB-local arrival counter stays fresh.  ``period_ms == 0`` is the
  omniscient live bus and reproduces the pre-bus routing bit-exactly;
* ``ReplicaView``    - the router-facing occupancy accessor: live-engine
  reads on the live bus, frozen-report reads otherwise.  ``active_limit``
  is configuration, not telemetry, so it is never stale;
* ``PodView``        - one pod's rollup of those same reports (occupancy,
  parked backlog, cumulative completions/SLO-met, cache warmth, arrival
  share), keyed by a shared ``FleetTopology``.  Pod rollups ride the
  **same stale-publish discipline** as every per-replica gauge: they sum
  the last *published* reports, so a pod-scoped controller is exactly as
  stale as a pool-scalar one.  Per-pod arrival counters are the one
  exception, like the fleet arrival counter: the LB counts arrivals
  first-hand.

Publish events are sequenced by the fleet's event heap (``fleet.py``), so
staleness interacts with arrivals/steps deterministically under a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serving.engine import SimServeEngine
from .telemetry import SLO
from .topology import FleetTopology


@dataclass(frozen=True)
class ReplicaReport:
    """One replica's counters as of its last publish (cumulative except
    the occupancy gauges)."""

    t_ms: float                   # virtual time the report was captured
    num_active: int
    num_parked: int
    active_limit: Optional[int]   # None => unlimited (NoAdmission)
    outstanding: int
    tokens_out: int
    completed: int
    slo_met: int                  # completions that met the bus's SLO
    # prefix-cache gauges/counters (0 on replicas without a cache)
    cache_tokens: int = 0         # prefix KV tokens resident right now
    cache_hit_tokens: int = 0     # cumulative prefix tokens served warm
    cache_query_tokens: int = 0   # cumulative prefix tokens looked up
    cache_evicted_tokens: int = 0  # cumulative prefix tokens evicted


@dataclass(frozen=True)
class PodView:
    """One pod's rollup of the last published replica reports.

    Occupancy gauges (``num_active``/``num_parked``/``capacity``/cache
    occupancy) sum over the pod's *live* replicas; cumulative counters
    (``completed``/``slo_met``/cache hit economics) sum over every
    replica ever assigned to the pod, retired included, so windowed
    deltas stay monotone across a pod-scoped scale-in.  ``arrivals`` is
    the LB-side per-pod arrival counter (always fresh, like the fleet
    counter).  ``capacity`` is the summed active-set limit of the pod's
    live replicas (configuration, never stale); ``unlimited`` is True
    when any live member has no limit (capacity is then a floor).
    """

    pod: int
    replicas: Tuple[int, ...]     # live replica idxs serving this pod
    num_active: int
    num_parked: int
    capacity: int
    unlimited: bool
    completed: int                # cumulative, all replicas ever in pod
    slo_met: int                  # cumulative, all replicas ever in pod
    arrivals: int                 # cumulative pod arrivals (LB-side)
    cache_tokens: int             # live replicas' resident prefix KV
    cache_hit_tokens: int
    cache_query_tokens: int

    @property
    def outstanding(self) -> int:
        return self.num_active + self.num_parked

    @property
    def utilization(self) -> float:
        """Active load over live capacity (0.0 for an empty pod)."""
        return self.num_active / self.capacity if self.capacity else 0.0

    @property
    def cache_hit_rate(self) -> float:
        return (self.cache_hit_tokens / self.cache_query_tokens
                if self.cache_query_tokens else 0.0)


class ReplicaView:
    """Occupancy of one replica *as the router is allowed to see it*.

    On the live bus every property reads the engine directly (omniscient,
    the pre-bus behavior); otherwise properties read the last published
    ``ReplicaReport``.  ``idx`` is the replica's index in the fleet's
    replica list - routers return it as their placement decision.
    """

    __slots__ = ("idx", "_bus", "_eng", "active_limit")

    def __init__(self, idx: int, bus: "SignalBus") -> None:
        self.idx = idx
        self._bus = bus
        self._eng = bus.engines[idx]
        # static configuration; reading it live is not cheating (and it
        # never changes, so it is a plain attribute, not a property - the
        # router's placement scan reads it once per candidate per arrival)
        self.active_limit: Optional[int] = getattr(
            self._eng.admission, "active_limit", None)

    @property
    def num_active(self) -> int:
        if self._bus.live:
            return len(self._eng.active)
        return self._bus.reports[self.idx].num_active

    @property
    def num_parked(self) -> int:
        if self._bus.live:
            return self._eng.admission.num_parked
        return self._bus.reports[self.idx].num_parked

    @property
    def outstanding(self) -> int:
        if self._bus.live:
            e = self._eng
            return len(e.active) + e.admission.num_parked
        return self._bus.reports[self.idx].outstanding

    @property
    def headroom(self) -> Optional[int]:
        """Active-set slots left, by the last signal; None if unlimited.
        May be negative under staleness - the replica filled up since."""
        limit = self.active_limit
        if limit is None:
            return None
        return limit - self.num_active

    @property
    def cache_tokens(self) -> int:
        """Prefix-cache occupancy by the last signal (0 = no cache/cold)."""
        if self._bus.live:
            pc = self._eng.prefix_cache
            return pc.tokens if pc else 0
        return self._bus.reports[self.idx].cache_tokens

    def age_ms(self, now_ms: float) -> float:
        """How stale this view's signals are at ``now_ms``: 0.0 on the
        live bus (reads are omniscient), else the age of the last
        published report.  The span tracer stamps every route decision's
        candidates with this - the staleness the router actually saw."""
        if self._bus.live:
            return 0.0
        return now_ms - self._bus.reports[self.idx].t_ms

    @property
    def cache_hit_rate(self) -> float:
        """Lifetime prefix-hit-token rate by the last signal (0.0 when the
        replica has no cache or has never been asked)."""
        if self._bus.live:
            pc = self._eng.prefix_cache
            hits = pc.hit_tokens if pc else 0
            asks = pc.query_tokens if pc else 0
        else:
            rep = self._bus.reports[self.idx]
            hits, asks = rep.cache_hit_tokens, rep.cache_query_tokens
        return hits / asks if asks else 0.0


class _LiveReplicaView(ReplicaView):
    """``ReplicaView`` specialized for the omniscient bus.

    ``SignalBus.live`` is fixed at construction (``period_ms`` never
    changes), so the per-read ``self._bus.live`` branch in every accessor
    is a constant the bus already knows at ``register`` time.  This
    subclass bakes the live side of each branch in; behavior is
    bit-identical, the router's placement scan just stops re-testing a
    constant on every candidate gauge read.
    """

    __slots__ = ()

    @property
    def num_active(self) -> int:
        return len(self._eng.active)

    @property
    def num_parked(self) -> int:
        return self._eng.admission.num_parked

    @property
    def outstanding(self) -> int:
        e = self._eng
        return len(e.active) + e.admission.num_parked

    @property
    def cache_tokens(self) -> int:
        pc = self._eng.prefix_cache
        return pc.tokens if pc else 0

    def age_ms(self, now_ms: float) -> float:
        return 0.0

    @property
    def cache_hit_rate(self) -> float:
        pc = self._eng.prefix_cache
        if pc is None or not pc.query_tokens:
            return 0.0
        return pc.hit_tokens / pc.query_tokens


class SignalBus:
    """Last-published-report store + publish scheduling policy.

    ``period_ms`` is the publish period (the router's worst-case signal
    staleness); ``jitter_ms`` adds a seeded uniform extra delay to every
    publish, modeling unsynchronized metric scrapes.  All randomness flows
    from one seeded generator and publish events are totally ordered by
    the fleet heap, so runs are exactly reproducible.
    """

    def __init__(self, slo: Optional[SLO] = None, period_ms: float = 0.0,
                 jitter_ms: float = 0.0, seed: int = 0) -> None:
        if period_ms < 0.0 or jitter_ms < 0.0:
            raise ValueError("period_ms/jitter_ms must be >= 0")
        self.slo = slo or SLO()
        self.period_ms = period_ms
        self.jitter_ms = jitter_ms
        # True => consumers read engines directly (omniscient bus).  Plain
        # attribute, not a property: the view accessors branch on it for
        # every router read and the period never changes after construction.
        self.live = period_ms <= 0.0
        self._rng = np.random.default_rng(seed)
        self.engines: List[SimServeEngine] = []
        self.reports: List[ReplicaReport] = []
        # numpy mirror of reports[i].t_ms, maintained by register/publish.
        # Invariant: report_t[i] == reports[i].t_ms always (reports are
        # created in exactly those two places), so vectorized consumers
        # (health staleness masks) read it in one gather instead of N
        # attribute lookups per publish tick.
        self.report_t = np.zeros(0, dtype=np.float64)
        self.views: List[ReplicaView] = []
        self._scan_n: List[int] = []      # completions already SLO-scanned
        self._slo_met: List[int] = []
        # cumulative fleet arrivals.  Deliberately NOT stale: the router
        # and controller live in the load balancer, which counts arrivals
        # first-hand - only *replica-side* state has to cross the bus.
        self.arrivals = 0
        # per-pod arrival counters, same LB-side freshness discipline
        # (the fleet loop bumps these as it injects each request)
        self.pod_arrivals: Dict[int, int] = {}

    # -- replica lifecycle ---------------------------------------------------
    def register(self, engine: SimServeEngine, now_ms: float) -> int:
        """Add a replica; captures its initial (cold) report at ``now_ms``."""
        idx = len(self.engines)
        self.engines.append(engine)
        self._scan_n.append(0)
        self._slo_met.append(0)
        cls = _LiveReplicaView if self.live else ReplicaView
        self.views.append(cls(idx, self))
        self.reports.append(self._capture(idx, now_ms))
        self.report_t = np.append(self.report_t, now_ms)
        return idx

    # -- publishing ----------------------------------------------------------
    def _capture(self, idx: int, now_ms: float) -> ReplicaReport:
        eng = self.engines[idx]
        occ = eng.occupancy()
        new = eng.completed[self._scan_n[idx]:]
        if new:
            self._slo_met[idx] += sum(1 for r in new if self.slo.met(r))
            self._scan_n[idx] += len(new)
        return ReplicaReport(
            t_ms=now_ms,
            num_active=occ["num_active"],
            num_parked=occ["num_parked"],
            active_limit=occ["active_limit"],
            outstanding=occ["outstanding"],
            tokens_out=occ["tokens_out"],
            completed=occ["completed"],
            slo_met=self._slo_met[idx],
            cache_tokens=occ["cache_tokens"],
            cache_hit_tokens=occ["cache_hit_tokens"],
            cache_query_tokens=occ["cache_query_tokens"],
            cache_evicted_tokens=occ["cache_evicted_tokens"])

    def publish(self, idx: int, now_ms: float) -> None:
        """Capture replica ``idx``'s state; consumers see it from now on."""
        self.reports[idx] = self._capture(idx, now_ms)
        self.report_t[idx] = now_ms

    def next_publish_ms(self, now_ms: float) -> float:
        """Schedule the publish after one at ``now_ms`` (period + jitter)."""
        dt = self.period_ms
        if self.jitter_ms > 0.0:
            dt += float(self._rng.uniform(0.0, self.jitter_ms))
        return now_ms + dt

    # -- controller-facing reads ---------------------------------------------
    def snapshot(self, now_ms: float, indices: Sequence[int]
                 ) -> List[ReplicaReport]:
        """Reports for ``indices``.  On the live bus this captures fresh
        reports first, so the controller's 'stale' view degrades to
        omniscient exactly when the router's does."""
        if self.live:
            for i in indices:
                self.publish(i, now_ms)
        return [self.reports[i] for i in indices]

    def pod_views(self, topology: FleetTopology, live: Sequence[int],
                  now_ms: float) -> List[PodView]:
        """Roll the last published reports up per pod (one ``PodView``
        per pod of ``topology``, empty pods included).

        Cumulative counters sum over EVERY registered replica in the pod
        (retired replicas keep their history, so a pod's windowed deltas
        never go negative across a scale-in); occupancy/cache gauges sum
        over the pod's ``live`` members only.  On the live bus this
        captures fresh reports first (same degradation contract as
        ``snapshot``); on a periodic bus the rollup is exactly as stale
        as the router's per-replica view.
        """
        reports = self.snapshot(now_ms, range(len(self.engines)))
        live_set = set(live)
        n_pods = topology.n_pods
        members: List[List[int]] = [[] for _ in range(n_pods)]
        active = [0] * n_pods
        parked = [0] * n_pods
        cap = [0] * n_pods
        unlimited = [False] * n_pods
        done = [0] * n_pods
        met = [0] * n_pods
        ctok = [0] * n_pods
        chit = [0] * n_pods
        cask = [0] * n_pods
        for i, rep in enumerate(reports):
            p = topology.pod_of(i)
            done[p] += rep.completed
            met[p] += rep.slo_met
            chit[p] += rep.cache_hit_tokens
            cask[p] += rep.cache_query_tokens
            if i in live_set:
                members[p].append(i)
                active[p] += rep.num_active
                parked[p] += rep.num_parked
                ctok[p] += rep.cache_tokens
                if rep.active_limit is None:
                    unlimited[p] = True
                else:
                    cap[p] += rep.active_limit
        return [PodView(pod=p, replicas=tuple(members[p]),
                        num_active=active[p], num_parked=parked[p],
                        capacity=cap[p], unlimited=unlimited[p],
                        completed=done[p], slo_met=met[p],
                        arrivals=self.pod_arrivals.get(p, 0),
                        cache_tokens=ctok[p], cache_hit_tokens=chit[p],
                        cache_query_tokens=cask[p])
                for p in range(n_pods)]
