"""Shared-clock virtual-time fleet of serving replicas (DESIGN.md 7).

The port's own copy of ``repro.cluster.fleet``, unchanged in behaviour:
the port imports nothing of ``repro``.

One event loop, N ``SimServeEngine`` replicas.  Five event kinds on an
**event calendar**: the arrival track is known up front, so arrivals are
a pre-sorted list consumed by index (no per-arrival heap traffic), while
a small near-future heap keyed by virtual milliseconds sequences the
rest.  The tie-break contract reproduces the legacy single-heap order
exactly - at equal time an arrival precedes every heap event (arrivals
were pushed first), heap ties break by push sequence - so runs are
deterministic under a fixed seed, bit for bit:

* ``arrive``  - the open-loop workload injects a request; the router picks
  a replica *from the signal bus's last published occupancy views*; if
  that replica is idle it starts a decode step;
* ``step``    - a replica's in-flight decode step completes; streams that
  were routed to it mid-step join the next step (continuous batching);
* ``publish`` - a replica pushes its occupancy report to the signal bus
  (only scheduled when the bus has ``period_ms > 0``; the live bus reads
  engines directly and needs no events);
* ``migrate`` - a stream drained off a retired replica re-arrives at the
  router after its KV-transfer delay (the scale-in cost, charged to the
  virtual clock);
* ``scale``   - periodic autoscaler tick: a ``ScaleDecision`` either adds
  a replica to the live pool (routers see it on the next arrival) or
  retires one - the retiree's unfinished streams drain into ``migrate``
  events.

Pending *work* (arrive/step/migrate events) is tracked by an O(1)
outstanding-work counter; bookkeeping events (scale/publish) reschedule
themselves only while that counter is positive, so the loop terminates
without rescanning the heap.

Decode-step effects are applied when the step *starts* (token counts and
completion times are stamped with the step's end time, so all observables
are consistent); the heap only sequences step boundaries.  This is the
same arrivals-join-at-step-boundaries semantics as the single-replica
``SimServeEngine.run`` loop.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
from dataclasses import dataclass
from operator import attrgetter
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from ..serving.engine import (PrefixCache, Request, SimServeEngine,
                              StepCostModel, make_admission)
from .controller import (MigrationCost, QueueDepthAutoscaler, ScaleDecision,
                         SLOAutoscaler, make_autoscaler)
from .faults import FaultSchedule, HealthEstimator, HealthPolicy, HedgePolicy
from .router import Router, make_router
from .signals import ReplicaView, SignalBus
from .telemetry import ClusterResult, ClusterTelemetry, SLO
from .topology import FleetTopology
from .workload import WorkloadSpec

__all__ = ["Fleet", "FleetConfig", "FleetTopology", "QueueDepthAutoscaler",
           "SLOAutoscaler", "ScaleDecision", "MigrationCost", "knee_cost",
           "est_capacity_rps", "run_fleet"]


class _Seq:
    """Event tie-break sequence counter with O(1) bulk advance.

    Drop-in for ``itertools.count()`` in the fast event loop: a leap
    chain consumes the same sequence numbers the per-step loop's k step
    pushes would have (``n += k``), and a truncation refunds the
    rolled-back tail, so admin-vs-step heap tie comparisons see exactly
    the legacy ordering.  The legacy loop keeps ``itertools.count`` (C
    speed; it never bulk-advances)."""

    __slots__ = ("n",)

    def __init__(self, start: int = 0) -> None:
        self.n = start

    def __next__(self) -> int:
        v = self.n
        self.n = v + 1
        return v


class _FleetSoA:
    """Struct-of-arrays mirror of the routable fleet's occupancy gauges
    (DESIGN.md 3).

    Full-size float64 arrays indexed by *replica idx* (never compacted:
    retired entries simply go stale and are excluded from ``live`` /
    ``groups``).  ``glim`` holds NaN for unlimited replicas
    (``NoAdmission``) - vectorized policies test it and fall back to the
    scan the slow path would run.  Rebuilt only on scaling events; the
    fast loop updates ``ga``/``gp`` in place (per mutation on a live
    bus, at publish events on a periodic one), so the arrays always
    carry exactly the values the ``ReplicaView`` properties would
    return."""

    __slots__ = ("ga", "gp", "glim", "live", "alive", "groups",
                 "group_nan", "group_lim", "group_homo", "group_lim0",
                 "live_nan", "n_pods")


def _in_window(wins, t: float) -> bool:
    """True when ``t`` falls inside any ``(start, end)`` half-open window
    of ``wins`` (None = no windows)."""
    if wins:
        for s, e in wins:
            if s <= t < e:
                return True
    return False


def knee_cost(spec: WorkloadSpec, active_limit: int,
              oversub: float = 2.0) -> StepCostModel:
    """Cost model whose HBM knee sits at ``oversub`` x the footprint of a
    full active set under ``spec``'s mean request shape.

    Used by the benches/tests so collapse physics stays reachable at
    scaled-down workload sizes; derives from ``kv_bytes_per_tok`` so the
    knee tracks the cost model instead of a copy-pasted constant."""
    base = StepCostModel()
    return dataclasses.replace(
        base,
        hbm_budget=oversub * active_limit * spec.mean_resident
        * base.kv_bytes_per_tok)


def est_capacity_rps(spec: WorkloadSpec, active_limit: int,
                     n_replicas: int,
                     cost: Optional[StepCostModel] = None) -> float:
    """Analytic saturation point: full active set, no thrash, no pod mix."""
    cost = cost or StepCostModel()
    step_ms = cost.step_ms(active_limit,
                           int(active_limit * spec.mean_resident), 0.0)
    tok_s = active_limit / (step_ms / 1e3)
    return n_replicas * tok_s / spec.mean_gen


@dataclass
class FleetConfig:
    """Replica-pool shape.

    Homogeneous by default; a **heterogeneous pool** (mixed hardware SKUs)
    is expressed with the per-replica override lists - replica ``i`` takes
    ``active_limits[i % len(active_limits)]`` / ``costs[i % ...]``, so a
    short override list tiles across the pool.  Replicas added by an
    autoscaler (``make_engine()`` with no index) use the scalar defaults.
    """

    n_replicas: int = 4
    admission: str = "gcr"           # none | gcr | gcr_pod
    active_limit: int = 128
    n_pods: int = 2
    promote_every: int = 64
    cost: Optional[StepCostModel] = None
    active_limits: Optional[Sequence[int]] = None   # per-replica override
    costs: Optional[Sequence[Optional[StepCostModel]]] = None
    # per-replica prefix-cache budget in tokens; 0 disables the cache
    # (legacy behavior, bit-identical to pre-cache runs)
    prefix_cache_tokens: int = 0
    # steady-state leap stepping on the member engines (DESIGN.md 3);
    # bit-identical either way, False forces per-step iteration
    leap_stepping: bool = True

    def limit_for(self, idx: Optional[int] = None) -> int:
        if self.active_limits and idx is not None:
            return self.active_limits[idx % len(self.active_limits)]
        return self.active_limit

    def cost_for(self, idx: Optional[int] = None) -> Optional[StepCostModel]:
        if self.costs and idx is not None:
            c = self.costs[idx % len(self.costs)]
            if c is not None:
                return c
        return self.cost

    def make_engine(self, idx: Optional[int] = None) -> SimServeEngine:
        adm = make_admission(self.admission, self.limit_for(idx),
                             n_pods=self.n_pods,
                             promote_every=self.promote_every)
        pc = (PrefixCache(self.prefix_cache_tokens)
              if self.prefix_cache_tokens > 0 else None)
        return SimServeEngine(adm, cost=self.cost_for(idx), prefix_cache=pc,
                              leap_stepping=self.leap_stepping)

    def make_engines(self) -> List[SimServeEngine]:
        return [self.make_engine(i) for i in range(self.n_replicas)]


class Fleet:
    """N replicas + router + signal bus + telemetry on one virtual clock."""

    def __init__(self, replicas: List[SimServeEngine], router: Router,
                 telemetry: Optional[ClusterTelemetry] = None,
                 autoscaler: Optional[Callable] = None,
                 autoscale_every_ms: float = 500.0,
                 bus: Optional[SignalBus] = None,
                 migration: Optional[MigrationCost] = None,
                 topology: Optional[FleetTopology] = None,
                 obs=None, faults: Optional[FaultSchedule] = None,
                 health: Optional[HealthPolicy] = None,
                 hedge: Optional[HedgePolicy] = None,
                 soa_fast_path: bool = True,
                 fast_path_coverage: str = "full",
                 leap_fault_cap: int = 0) -> None:
        if not replicas:
            raise ValueError("fleet needs at least one replica")
        # struct-of-arrays fast event loop (DESIGN.md 3): used whenever
        # bit-identity to the legacy single-heap loop is proven - which
        # now includes the fault plane, health ejection, hedging,
        # and windows/flight observability; only span tracing (per-step
        # engine hooks) and non-SimServeEngine replicas force the legacy
        # loop.  False forces it too - same observables either way.
        self.soa_fast_path = soa_fast_path
        # "full" (default) is the widest proven coverage above; "clean"
        # restores the narrower gate (fast only when obs/faults/health/hedge
        # are all off) for A/B bisection of the coverage extension itself
        if fast_path_coverage not in ("full", "clean"):
            raise ValueError("fast_path_coverage must be 'full' or "
                             "'clean'")
        self.fast_path_coverage = fast_path_coverage
        # > 0 caps banked steps per leap on *limping* replicas (their
        # cost model is about to swap back, so unbounded chains just get
        # rolled back at the fault edge); 0 = uncapped.  Any value is
        # bit-identical - banked steps are invisible.
        self.leap_fault_cap = leap_fault_cap
        self.replicas = replicas
        self.router = router
        # one replica<->pod partition for router, controller, telemetry:
        # adopt the router's (pod-affine policies carry one) so placement
        # and scale decisions can never disagree about who serves where
        self.topology = (topology
                         or getattr(router, "topology", None)
                         or FleetTopology(1))
        self.telemetry = telemetry or ClusterTelemetry()
        self.autoscaler = autoscaler
        self.autoscale_every_ms = autoscale_every_ms
        self.bus = bus or SignalBus()
        self.migration = migration or MigrationCost()
        # optional obs.Observability bundle: spans + control-plane flight
        # recorder + windowed metrics.  None (the default) is the
        # zero-overhead path - every hook below guards on it
        self.obs = obs
        # fault plane (DESIGN.md 11): all three knobs share the obs=
        # opt-in contract - None (or an *empty* schedule) pushes no
        # events, consumes no tie-break sequence numbers, and leaves
        # seeded traces bit-identical
        self.faults = faults if faults else None
        self.health = (health if isinstance(health, HealthEstimator)
                       else HealthEstimator(health)
                       if health is not None else None)
        if self.health is not None and (bus is None or bus.live):
            raise ValueError(
                "health ejection needs a periodic SignalBus "
                "(staleness_ms > 0): the estimator observes completion "
                "rates at publish events, and a live bus has none")
        self.hedge = hedge
        self.retired = [False] * len(replicas)
        self._blackouts = (self.faults.blackout_windows()
                          if self.faults is not None else {})
        self._crashed: dict = {}           # idx -> True while down
        self._limp_saved: dict = {}        # idx -> pre-fault StepCostModel
        self._pub_alive: List[bool] = []   # publish chain in the heap?
        # hedge copy registry: rid -> {"copies": [[obj, status], ...],
        # "issued": n}; statuses live/cancel_pending/done/cancelled/lost
        self._hedges: dict = {}
        self._hedges_issued = 0
        self._cancelled_hedges = 0
        # event-loop state (created in run())
        self._heap: list = []
        self._arrivals: List[Request] = []
        self._seq = itertools.count()
        # admin-barrier mirror (fast loop only): a plain min-heap of the
        # pending publish/scale event *times*, maintained by _push, so
        # the leap horizon is one peek.  None disables the mirror.
        self._abar: Optional[list] = None
        self._soa: Optional[_FleetSoA] = None
        self._stepping: List[bool] = []
        self._step_end: List[float] = []
        self._work = 0          # pending arrive/step/migrate events
        self._migrating = 0     # streams in KV transit between replicas
        self._events = 0        # total events processed (perf telemetry)
        self._live_views: List[ReplicaView] = []
        # the list routers actually see: identical OBJECT to _live_views
        # when health is off, a health-filtered copy otherwise
        self._route_views: List[ReplicaView] = self._live_views
        # live_indices() as an intp array, maintained (health runs only)
        # by _rebuild_live_views so the per-publish health evaluation
        # never rescans the pool in Python
        self._live_arr = np.zeros(0, dtype=np.intp)
        self._ran = False

    @property
    def ejected(self) -> frozenset:
        """Replica indices the health estimator currently holds out of
        the routable set (empty without a health policy)."""
        h = self.health
        return h.ejected if h is not None else frozenset()

    # -- introspection -------------------------------------------------------
    def live_indices(self) -> List[int]:
        return [i for i, gone in enumerate(self.retired) if not gone]

    def live_views(self) -> List[ReplicaView]:
        """Views of routable replicas; cached, rebuilt only on scaling
        (the arrival hot path must not rescan the pool per event)."""
        return self._live_views

    def _rebuild_live_views(self) -> None:
        views = self.bus.views
        idxs = self.live_indices()
        self._live_views = [views[i] for i in idxs]
        if self.health is not None:
            self._live_arr = np.array(idxs, dtype=np.intp)
        self._refilter_route_views()

    def _refilter_route_views(self) -> None:
        """Routable = live minus health-ejected; never empty (someone
        must serve, mirroring GCR's someone-holds-the-lock rule).  With
        health off the routable list IS the live list - same object, so
        the health seam costs existing runs nothing."""
        h = self.health
        if h is None or not h.ejected:
            self._route_views = self._live_views
        else:
            ej = h.ejected
            kept = [v for v in self._live_views if v.idx not in ej]
            self._route_views = kept or self._live_views

    # -- event plumbing ------------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        if kind in ("arrive", "step", "migrate"):
            self._work += 1
        elif self._abar is not None and kind in ("publish", "scale"):
            # mirror admin-event times for the fast loop's leap horizon
            heapq.heappush(self._abar, t)  # lint: disable=R203(time-only mirror read via min(); equal entries are interchangeable, nothing to tie-break)
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    # -- scaling -------------------------------------------------------------
    def _scale_out(self, eng: SimServeEngine, t: float,
                   pod: Optional[int] = None) -> None:
        self.replicas.append(eng)
        self._stepping.append(False)
        self._step_end.append(0.0)
        self.retired.append(False)
        idx = self.bus.register(eng, t)
        # pod-targeted spawn: record the assignment on the shared
        # topology BEFORE rebuilding views, so the router's next
        # partition already files the new replica under the right pod
        # (pod=None keeps the static idx % n_pods rule - bit-identical
        # for pool-scalar controllers)
        self.topology.assign(idx, pod)
        self.telemetry.on_spawn(idx, t)
        self.telemetry.on_scale(t)
        if self.obs is not None:
            self.obs.on_spawn(idx, t, eng, pod)
        self._rebuild_live_views()
        self._pub_alive.append(not self.bus.live)
        if not self.bus.live:
            self._push(self.bus.next_publish_ms(t), "publish", idx)

    def _scale_in(self, idx: int, t: float) -> None:
        if not (0 <= idx < len(self.replicas)) or self.retired[idx]:
            return
        if len(self.live_indices()) <= 1:    # never drain the last replica
            return
        self.retired[idx] = True
        self._rebuild_live_views()
        if not self.bus.live:
            # final report at decommission: completions since the last
            # periodic publish must not vanish from controller windows
            self.bus.publish(idx, t)
        # an in-flight step's effects are already banked through its end
        # time, so active streams cannot start migrating (and the replica
        # cannot stop billing) before that boundary - otherwise a stream
        # would decode on two replicas over the same virtual interval
        done_t = self._step_end[idx] if self._stepping[idx] else t
        active_moved, parked_moved = self.replicas[idx].drain()
        kv = self.replicas[idx].cost.kv_bytes_per_tok
        # the retiree's prefix cache dies with it: every warm token is
        # prefill that will be recomputed by whoever serves the follow-up
        # turns, and a not-yet-prefilled migrant's pinned hit evaporates
        # (it re-probes the destination cache at re-submit, which is
        # almost surely cold)
        pc = self.replicas[idx].prefix_cache
        lost = (pc.tokens if pc else 0) \
            + sum(r.prefix_hit_tokens for r in active_moved + parked_moved
                  if r.first_token_ms < 0)
        for r in active_moved:
            dt = self.migration.ms(r.prompt_len + r.generated, kv)
            self._push(done_t + dt, "migrate", r)
        for r in parked_moved:
            # parked streams hold no KV (nothing in flight): handoff only
            self._push(t + self.migration.ms(0, kv), "migrate", r)
        self._migrating += len(active_moved) + len(parked_moved)
        if self.obs is not None:
            self.obs.on_retire(idx, t, done_t, active_moved, parked_moved)
        self.telemetry.on_retire(
            idx, done_t, migrated=len(active_moved) + len(parked_moved),
            prefix_tokens_lost=lost)

    # -- fault plane (DESIGN.md 11) ------------------------------------------
    def _kick(self, idx: int, t: float) -> None:
        """Start a decode step on an idle replica (hedge/cancel paths
        mutate engine occupancy outside the arrive branch, which owns
        the inline kick on the hot path)."""
        eng = self.replicas[idx]
        if self._stepping[idx] or self.retired[idx] or not eng.active:
            return
        dt, done = eng.step(t)
        if dt > 0.0:
            end_t = t + dt
            self._stepping[idx] = True
            self._step_end[idx] = end_t
            self._push(end_t, "step", idx)
        if done:
            if self.obs is not None:
                self.obs.on_completions(done, idx)
            self._resolve_hedges(done, t)

    def _apply_fault(self, op: str, f, t: float) -> None:
        idx = f.replica
        if idx >= len(self.replicas):
            return          # schedule names a replica this run never built
        if op == "limp_on":
            # swap in a cost model with every *latency* term inflated;
            # KV geometry is untouched, so occupancy gauges keep their
            # healthy meaning - the sickness is visible only as time.
            # Steps already in flight keep their banked end (effects
            # bank at step start); the next step pays the factor.
            if idx not in self._limp_saved:
                eng = self.replicas[idx]
                c = eng.cost
                self._limp_saved[idx] = c
                k = f.factor
                eng.cost = dataclasses.replace(
                    c, t_fixed_ms=c.t_fixed_ms * k, t_tok_ms=c.t_tok_ms * k,
                    thrash_coef=c.thrash_coef * k,
                    t_xpod_ms=c.t_xpod_ms * k,
                    t_prefill_ms_per_tok=c.t_prefill_ms_per_tok * k)
        elif op == "limp_off":
            saved = self._limp_saved.pop(idx, None)
            if saved is not None:
                self.replicas[idx].cost = saved
        elif op == "crash":
            self._crash(idx, t, f)
            return          # _crash logs its own richer fault record
        elif op == "restart":
            self._restart(idx, t)
        # black_on / black_off mutate nothing: the publish branch reads
        # the windows directly; the edges exist so the flight recorder
        # can show when the silence started and ended
        self.telemetry.on_fault(op, idx, t)
        if self.obs is not None:
            self.obs.on_fault(idx, t, op)

    def _crash(self, idx: int, t: float, f) -> None:
        if self.retired[idx] or len(self.live_indices()) <= 1:
            return          # already gone, or someone must keep serving
        self.retired[idx] = True
        self._crashed[idx] = True
        self._rebuild_live_views()
        # no farewell publish: a crash is silent - the bus keeps the
        # stale pre-crash report and routers watch its age grow
        done_t = self._step_end[idx] if self._stepping[idx] else t
        eng = self.replicas[idx]
        active_moved, parked_moved = eng.drain()
        kv = eng.cost.kv_bytes_per_tok
        pc = eng.prefix_cache
        lost_prefix = (pc.tokens if pc else 0) + sum(
            r.prefix_hit_tokens for r in active_moved + parked_moved
            if r.first_token_ms < 0)
        if pc is not None:
            pc.clear()      # the warm KV dies with the process
        moved = active_moved + parked_moved
        requeued = lost = 0
        if f.policy == "requeue":
            # a crash checkpoints nothing: every survivor restarts
            # decode from token zero elsewhere, paying only the
            # control-plane handoff (there is no KV left to transfer).
            # Banked step effects stand, so active streams re-enter at
            # the in-flight step's end, never before it.
            handoff = self.migration.ms(0, kv)
            for r in active_moved:
                self._push(done_t + handoff, "migrate",
                           self._requeue_copy(r))
            for r in parked_moved:
                self._push(t + handoff, "migrate", self._requeue_copy(r))
            self._migrating += len(moved)
            requeued = len(moved)
        else:
            lost = len(moved)
            for r in moved:
                reg = self._hedges.get(r.rid)
                if reg is not None:
                    for rec in reg["copies"]:
                        if rec[0] is r:
                            rec[1] = "lost"
        self.telemetry.on_crash(idx, done_t, requeued=requeued, lost=lost,
                                prefix_tokens_lost=lost_prefix)
        if self.obs is not None:
            self.obs.on_fault(idx, t, "crash", requeued=requeued, lost=lost,
                              moved=[(r, done_t) for r in active_moved]
                              + [(r, t) for r in parked_moved]
                              if f.policy == "requeue" else ())

    def _requeue_copy(self, r: Request) -> Request:
        """Cold copy of a crashed-away stream (same identity, progress
        discarded - the KV died).  A hedge registry tracking the old
        object follows the swap."""
        c = r.fresh()
        reg = self._hedges.get(r.rid)
        if reg is not None:
            for rec in reg["copies"]:
                if rec[0] is r:
                    rec[0] = c
        elif self.hedge is not None:
            # not hedged yet, but the pending hedge event still holds
            # the drained original: register the clone now so the twin
            # excludes *its* replica (two copies sharing a rid on one
            # engine would clobber each other in the rid-keyed tables)
            self._hedges[r.rid] = {"copies": [[c, "live"]], "issued": 0}
        return c

    def _restart(self, idx: int, t: float) -> None:
        if not self._crashed.pop(idx, False):
            return          # the crash was refused or never happened
        self.retired[idx] = False
        self._rebuild_live_views()
        self.telemetry.on_restart(idx, t)
        h = self.health
        if h is not None:
            # forget the pre-crash rate history: judging the cold
            # rejoiner against a stale baseline would eject it on sight
            h.forget(idx)
        bus = self.bus
        if not bus.live:
            if not _in_window(self._blackouts.get(idx), t):
                bus.publish(idx, t)         # honest cold hello
                if self.obs is not None:
                    self.obs.on_publish(idx, t, bus.reports[idx])
            if not self._pub_alive[idx]:
                self._push(bus.next_publish_ms(t), "publish", idx)
                self._pub_alive[idx] = True

    def _health_tick(self, idx: int, t: float) -> bool:
        """Observe replica ``idx``'s fresh publish and re-evaluate the
        ejected set; True when the routable pool changed (the fast loop
        must rebuild its gauge mirror, like a scale event)."""
        h = self.health
        bus = self.bus
        h.observe(idx, bus.reports[idx], t)
        ejected, restored = h.evaluate(t, bus.reports, self._live_arr,
                                       report_t=bus.report_t)
        if ejected or restored:
            self._refilter_route_views()
            self.telemetry.on_eject(len(ejected), len(restored), t)
            if self.obs is not None:
                for j in ejected:
                    self.obs.on_fault(j, t, "eject")
                for j in restored:
                    self.obs.on_fault(j, t, "restore")
            return True
        return False

    def _fire_hedge(self, r: Request, t: float) -> None:
        """Issue a duplicate copy of a still-unfinished request onto a
        replica not already holding one; first completion wins."""
        hedge = self.hedge
        reg = self._hedges.get(r.rid)
        issued = reg["issued"] if reg is not None else 0
        if issued >= hedge.max_hedges:
            return
        exclude = set()
        if reg is not None:
            for obj, status in reg["copies"]:
                if status == "live":
                    exclude.add(obj.replica)
        else:
            exclude.add(r.replica)
        views = [v for v in self._route_views if v.idx not in exclude]
        if not views:
            return          # nowhere distinct to hedge to
        twin = r.fresh()
        if reg is None:
            reg = {"copies": [[r, "live"]], "issued": 0}
            self._hedges[r.rid] = reg
        reg["copies"].append([twin, "live"])
        reg["issued"] = issued + 1
        self._hedges_issued += 1
        obs = self.obs
        if obs is not None:
            obs.on_hedge(twin, t)
        i = self.router.route(twin, views)
        twin.replica = i
        admitted = self.replicas[i].submit(twin)
        if obs is not None:
            obs.on_routed(twin, i, admitted, t)
        self._kick(i, t)
        if reg["issued"] < hedge.max_hedges:
            self._push(t + hedge.delay_ms, "hedge", r)

    def _resolve_hedges(self, done: List[Request], t: float) -> None:
        """First completion wins: cancel every other live copy.  A copy
        whose completion is already banked stays completed (both twins
        may finish - the conservation law counts copies, not rids); a
        copy in KV transit is marked and dropped at its re-arrival."""
        hedges = self._hedges
        if not hedges:
            return
        obs = self.obs
        for r in done:
            reg = hedges.get(r.rid)
            if reg is None:
                continue
            for rec in reg["copies"]:
                obj, status = rec
                if obj is r:
                    rec[1] = "done"
                elif status == "live":
                    if obj.done_ms >= 0:
                        rec[1] = "done"     # banked: both copies count
                        continue
                    j = obj.replica
                    eng = (self.replicas[j]
                           if 0 <= j < len(self.replicas) else None)
                    if eng is not None \
                            and eng.requests.get(obj.rid) is obj:
                        eng.cancel(obj.rid, t)
                        rec[1] = "cancelled"
                        self._cancelled_hedges += 1
                        if obs is not None:
                            obs.on_cancel(obj, j, t)
                        self._kick(j, t)
                    else:                   # in KV transit somewhere
                        rec[1] = "cancel_pending"

    # -- event loop ----------------------------------------------------------
    def run(self, requests: List[Request], max_ms: float = 120_000.0
            ) -> ClusterResult:
        if self._ran:
            # bus registrations, telemetry, and retirement state are all
            # one-shot; a silent second run would double-count every signal
            raise RuntimeError("Fleet.run() is single-use; build a fresh "
                              "Fleet (or use run_fleet) per run")
        self._ran = True
        # routers carry LB-side state (rotation counters, p2c RNG, sticky
        # session maps); re-arm it so routing depends only on seeds.  The
        # topology likewise drops explicit spawn assignments: they belong
        # to one run's scale history.
        self.router.reset()
        self.topology.begin_run()
        # fast-loop eligibility (DESIGN.md 3 coverage matrix): the only
        # feature whose hooks read genuinely per-step state is span
        # tracing (_EngineObs observes every decode step), so it - and
        # engine subclasses the leap proofs don't cover - force the
        # legacy loop.  Faults truncate chains at their edges, health
        # and publishes sit behind the admin barrier, hedge twins ride
        # the completion step, and windows close on event-time rolls;
        # all proven bit-identical.  coverage="clean" restores the old
        # everything-quiet gate for bisection.
        if self.fast_path_coverage == "full":
            fast = (self.soa_fast_path
                    and (self.obs is None or self.obs.tracer is None)
                    and all(isinstance(e, SimServeEngine)
                            for e in self.replicas))
        else:
            fast = (self.soa_fast_path and self.obs is None
                    and self.faults is None and self.health is None
                    and self.hedge is None
                    and all(isinstance(e, SimServeEngine)
                            for e in self.replicas))
        self._heap = []
        self._abar = [] if fast else None
        self._seq = _Seq() if fast else itertools.count()
        self._stepping = [False] * len(self.replicas)
        self._step_end = [0.0] * len(self.replicas)
        self._migrating = 0
        self._events = 0

        # Event calendar: the arrival track is known up front, so arrivals
        # are a pre-sorted list consumed by index - O(1) per arrival, no
        # heap traffic - while the (small) near-future heap sequences only
        # step/migrate/publish/scale events.  Tie-break contract: at equal
        # virtual time an arrival precedes every heap event, which is
        # exactly the legacy single-heap order (arrivals were pushed first
        # and ties broke by insertion sequence).
        # Clone on entry: engines mutate Request state in place, and one
        # workload list is typically swept across many policy runs.
        self._arrivals = [r.fresh() for r in
                          sorted(requests,
                                 key=attrgetter("arrive_ms", "rid"))]
        self._work = len(self._arrivals)
        obs = self.obs
        if obs is not None:
            obs.begin(self)
        if self.autoscaler is not None:
            self._push(self.autoscale_every_ms, "scale", None)
        for i, eng in enumerate(self.replicas):
            self.bus.register(eng, 0.0)
            self.telemetry.on_spawn(i, 0.0)
        self._rebuild_live_views()
        self._pub_alive = [False] * len(self.replicas)
        if not self.bus.live:
            for i in range(len(self.replicas)):
                self._push(self.bus.next_publish_ms(0.0), "publish", i)
                self._pub_alive[i] = True
        if self.faults is not None:
            for t_f, op, f in self.faults.events():
                self._push(t_f, "fault", (op, f))
        if fast:
            return self._run_fast(max_ms)

        now = 0.0
        injected = 0
        events = 0
        # the event loop is the measured substrate's innermost loop: bind
        # the per-event state to locals and inline place/step dispatch
        # (these lists are mutated in place by scaling, never rebound, so
        # local bindings stay correct).  The work/migrating counters live
        # in locals too and sync back to the instance only around the
        # bookkeeping branches that call out (scaling mutates them via
        # _push); the local copy is authoritative everywhere else.
        heap = self._heap
        arrivals = self._arrivals
        replicas = self.replicas
        stepping = self._stepping
        step_end = self._step_end
        retired = self.retired
        route = self.router.route
        bus = self.bus
        pod_arrivals = bus.pod_arrivals
        topo_pods = self.topology.n_pods
        # seed every pod key up front: the hot loop then pays one dict
        # store per arrival instead of a get+store pair (consumers read
        # via .get(p, 0), so a zero-valued key is indistinguishable from
        # an absent one)
        for p in range(topo_pods):
            pod_arrivals.setdefault(p, 0)
        heappush, heappop = heapq.heappush, heapq.heappop
        seq = self._seq
        work = self._work
        migrating = self._migrating
        # fault-plane locals: all None/False on a clean run, so the hot
        # branches cost one comparison and the trace stays bit-identical
        hedge_on = self.hedge is not None
        hedge_delay = self.hedge.delay_ms if hedge_on else 0.0
        hedges = self._hedges
        blackouts = self._blackouts or None
        health = self.health
        pub_alive = self._pub_alive
        # obs roll boundary as a plain local float: inf when untraced, so
        # the per-event check is one comparison, not an attribute read
        next_roll = obs.next_roll if obs is not None else float("inf")
        ai, n_arr = 0, len(arrivals)
        while True:
            if ai < n_arr:
                ta = arrivals[ai].arrive_ms
                if heap and heap[0][0] < ta:
                    t, _, kind, payload = heappop(heap)
                else:               # arrivals win ties (legacy seq order)
                    t, kind, payload = ta, "arrive", arrivals[ai]
                    ai += 1
            elif heap:
                t, _, kind, payload = heappop(heap)
            else:
                break
            if t > max_ms:
                break
            events += 1
            if t >= next_roll:
                obs.roll(t)
                next_roll = obs.next_roll
            # work events advance the measured clock; bookkeeping ticks
            # (publish/scale) must not extend the measured duration
            if kind == "step":
                work -= 1
                now = t
                i = payload
                stepping[i] = False
                eng = replicas[i]
                if eng.active and not retired[i]:
                    dt, done = eng.step(t)
                    if dt > 0.0:
                        end_t = t + dt
                        stepping[i] = True
                        step_end[i] = end_t
                        work += 1
                        heappush(heap, (end_t, next(seq), "step", i))
                    if done:
                        if obs is not None:
                            obs.on_completions(done, i)
                        if hedge_on:
                            self._work = work
                            self._migrating = migrating
                            self._resolve_hedges(done, t)
                            work = self._work
                            migrating = self._migrating
            elif kind == "arrive" or kind == "migrate":
                work -= 1
                now = t
                if kind == "arrive":
                    injected += 1
                    bus.arrivals += 1
                    # per-pod arrival share, same LB-side freshness as
                    # the fleet counter (migrants were already counted).
                    # Bucket by the pod the router will actually serve
                    # (it reduces modulo the partition), so out-of-range
                    # request pods never vanish from the rollups
                    p = payload.pod % topo_pods
                    pod_arrivals[p] += 1
                    if hedge_on:
                        heappush(heap, (t + hedge_delay, next(seq),
                                        "hedge", payload))
                    views = self._route_views
                else:
                    p = payload.pod % topo_pods
                    migrating -= 1
                    views = self._route_views
                    if hedge_on:
                        reg = hedges.get(payload.rid)
                        rec = (next((c for c in reg["copies"]
                                     if c[0] is payload), None)
                               if reg is not None else None)
                        if rec is not None:
                            # a copy cancelled while its KV was in
                            # transit is dropped here, at the re-arrival
                            # it was racing toward
                            if rec[1] == "cancel_pending":
                                rec[1] = "cancelled"
                                self._cancelled_hedges += 1
                                if obs is not None:
                                    obs.on_cancel(payload, -1, t)
                                continue
                            # engines key streams by rid, so two copies
                            # sharing a rid must never co-reside: steer
                            # this one away from its resident twin, or
                            # fold it into the twin when there is
                            # nowhere collision-free to land
                            occupied = set()
                            for c in reg["copies"]:
                                o = c[0]
                                if o is payload or c[1] != "live":
                                    continue
                                j = o.replica
                                if 0 <= j < len(replicas) and \
                                        replicas[j].requests.get(
                                            payload.rid) is o:
                                    occupied.add(j)
                            if occupied:
                                kept = [v for v in views
                                        if v.idx not in occupied]
                                if kept:
                                    views = kept
                                else:
                                    rec[1] = "cancelled"
                                    self._cancelled_hedges += 1
                                    if obs is not None:
                                        obs.on_cancel(payload, -1, t)
                                    continue
                if obs is not None:
                    obs.on_inject(payload, kind, t, p)
                i = route(payload, views)
                payload.replica = i
                eng = replicas[i]
                admitted = eng.submit(payload)
                if obs is not None:
                    obs.on_routed(payload, i, admitted, t)
                if not stepping[i] and eng.active:
                    dt, done = eng.step(t)
                    if dt > 0.0:
                        end_t = t + dt
                        stepping[i] = True
                        step_end[i] = end_t
                        work += 1
                        heappush(heap, (end_t, next(seq), "step", i))
                    if done:
                        if obs is not None:
                            obs.on_completions(done, i)
                        if hedge_on:
                            self._work = work
                            self._migrating = migrating
                            self._resolve_hedges(done, t)
                            work = self._work
                            migrating = self._migrating
            elif kind == "publish":
                i = payload
                if not retired[i]:
                    # a blacked-out replica keeps serving and keeps its
                    # publish chain alive, but the bus never hears from
                    # it: routers see the pre-blackout report aging
                    if blackouts is None \
                            or not _in_window(blackouts.get(i), t):
                        bus.publish(i, t)
                        if obs is not None:
                            obs.on_publish(i, t, bus.reports[i])
                        if health is not None:
                            self._health_tick(i, t)
                    if work > 0:
                        heappush(heap, (bus.next_publish_ms(t), next(seq),
                                        "publish", i))
                    else:
                        pub_alive[i] = False
                else:
                    pub_alive[i] = False
            elif kind == "fault":
                op, f = payload
                self._work = work
                self._migrating = migrating
                self._apply_fault(op, f, t)
                work = self._work
                migrating = self._migrating
            elif kind == "hedge":
                r = payload
                if r.done_ms < 0:
                    self._work = work
                    self._migrating = migrating
                    self._fire_hedge(r, t)
                    work = self._work
                    migrating = self._migrating
            elif kind == "scale":
                # sync the local counters out: the autoscaler and the
                # scale paths read/mutate the instance state (_scale_in
                # pushes migrate events)
                self._work = work
                self._migrating = migrating
                decision = (self.autoscaler(self, t)
                            if self.autoscaler else None)
                if isinstance(decision, SimServeEngine):
                    # legacy hook protocol: a bare engine means scale out
                    decision = ScaleDecision(add=decision)
                if obs is not None:
                    # record BEFORE applying: the snapshot must be the
                    # pre-action state the controller actually read
                    obs.on_scale(t, decision)
                if decision is not None:
                    if decision.add is not None:
                        self._scale_out(decision.add, t, decision.pod)
                    elif decision.remove is not None:
                        self._scale_in(decision.remove, t)
                work = self._work
                migrating = self._migrating
                # keep ticking while any work remains on the heap
                if work > 0:
                    heappush(heap, (t + self.autoscale_every_ms, next(seq),
                                    "scale", None))
        self._work = work
        self._migrating = migrating
        return self._finalize(now, injected, events)

    def _finalize(self, now: float, injected: int,
                  events: int) -> ClusterResult:
        # offered = requests that actually arrived before the max_ms cutoff,
        # so completed + live + migrating == offered for any (workload,
        # max_ms).  Step effects are banked at step start, so a truncated
        # run must extend the measured end over in-flight steps - their
        # tokens and completion stamps are already counted (the
        # single-engine loop has the same now += dt overshoot past max_ms).
        end = max([now] + [e for i, e in enumerate(self._step_end)
                           if self._stepping[i]])
        self._events = events
        windows = None
        obs = self.obs
        if obs is not None:
            obs.finish(end)
            windows = obs.windows
        return self.telemetry.finalize(end, self.replicas, injected,
                                       migrating=self._migrating,
                                       events=events,
                                       topology=self.topology,
                                       pod_arrivals=dict(
                                           self.bus.pod_arrivals),
                                       windows=windows,
                                       hedges_issued=self._hedges_issued,
                                       cancelled_hedges=(
                                           self._cancelled_hedges))

    # -- struct-of-arrays fast loop (DESIGN.md 3) ----------------------------
    def _soa_rebuild(self) -> _FleetSoA:
        """(Re)build the gauge arrays and pod partition from the current
        pool.  Called on entry and after every scaling event - never on
        the per-event hot path.  Initial values come through the
        ``ReplicaView`` properties, so live and periodic buses both seed
        exactly what the slow path would read."""
        soa = _FleetSoA()
        n = len(self.replicas)
        views_all = self.bus.views
        ga = np.empty(n)
        gp = np.empty(n)
        glim = np.empty(n)
        for i in range(n):
            v = views_all[i]
            ga[i] = v.num_active
            gp[i] = v.num_parked
            lim = v.active_limit
            glim[i] = np.nan if lim is None else lim
        # the ROUTABLE set, not live_indices(): with health ejection on,
        # route_soa must scan exactly the views the slow path's
        # route(payload, _route_views) sees (same object when health is
        # off or quiet, so clean runs are untouched)
        live = np.array([v.idx for v in self._route_views],
                        dtype=np.intp)
        alive = np.zeros(n, dtype=bool)
        alive[live] = True
        # partition with the router's topology when it carries one (the
        # slow path's group scan uses exactly that map)
        rtopo = getattr(self.router, "topology", None) or self.topology
        pod_of = rtopo.pod_of
        groups = {}
        group_nan = {}
        group_lim = {}
        group_homo = {}
        group_lim0 = {}
        for pod in range(rtopo.n_pods):
            g = [int(i) for i in live if pod_of(int(i)) == pod]
            garr = np.array(g, dtype=np.intp) if g else live
            groups[pod] = garr
            lims = glim[garr]
            group_nan[pod] = bool(np.isnan(lims).any())
            group_lim[pod] = lims
            # the overwhelmingly common pool is one shared limit; route
            # scans then drop their normalizing division (same argmin,
            # proven order-preserving) - precompute the flag here, off
            # the per-arrival path
            homo = (not group_nan[pod] and lims.size > 0
                    and bool((lims == lims[0]).all()))
            group_homo[pod] = homo
            group_lim0[pod] = float(lims[0]) if homo else 0.0
        soa.ga, soa.gp, soa.glim = ga, gp, glim
        soa.live, soa.alive = live, alive
        soa.groups, soa.group_nan = groups, group_nan
        soa.group_lim, soa.group_homo = group_lim, group_homo
        soa.group_lim0 = group_lim0
        soa.live_nan = bool(np.isnan(glim[live]).any())
        soa.n_pods = rtopo.n_pods
        self._soa = soa
        return soa

    def _run_fast(self, max_ms: float) -> ClusterResult:
        """Struct-of-arrays steady-state event loop.

        Precondition (gated in ``run()``): no span tracing.  Per-replica
        next step boundaries live in one float64 array (``nb``; inf =
        idle) scanned with a cached vectorized argmin, so the heap
        sequences only publish/scale/migrate/fault/hedge events; each
        boundary asks its engine to leap a whole steady-state chain
        (``step_leap``), bounded by the admin-barrier mirror ``_abar``
        so no control-plane read can observe mid-chain state.  An
        arrival or migrant landing on a mid-chain replica rolls the
        unobserved tail back (``leap_truncate``) - integer-exact, so
        the trace stays bit-identical to the per-step loop.

        Fault/hedge events are NOT abar barriers: chains bank straight
        past them and the event performs a *targeted* truncation of its
        victim's chain instead (steps starting at or after the edge see
        post-edge cost/membership, exactly matching the per-step order
        where the fault's setup-time sequence pops before any same-time
        step event).  Limplock therefore bounds the leap horizon the
        same way the HBM knee does - by ending chains early - and
        ``leap_fault_cap`` optionally shortens limping chains up front.
        Health runs at publish ticks (already admin-barriered) and
        rebuilds the SoA mirror when the routable pool changes; windowed
        metrics close on the same event-time rolls the slow loop uses
        (window counters bucket by event time and gauges are
        chain-invariant, so batched closes emit identical rows).

        Tie contract vs the legacy single-heap loop: arrivals win every
        time tie (legacy pops heap events only when strictly earlier);
        boundary-vs-heap ties compare the same push sequence numbers the
        legacy heap would have compared (chains bulk-consume their
        boundaries' numbers, truncation refunds the rolled-back tail);
        equal-time boundaries of distinct replicas process in index
        order, observably commutative while the control plane is quiet
        (engines never read each other, and every cross-replica reader -
        router gauges, publishes, scale ticks, hedge resolution - sits
        at an arrival or admin event, never between same-time steps)."""
        inf = float("inf")
        heap = self._heap
        abar = self._abar
        arrivals = self._arrivals
        replicas = self.replicas
        retired = self.retired
        router = self.router
        route = router.route
        rsoa = getattr(router, "route_soa", None)
        bus = self.bus
        bus_live = bus.live
        reports = bus.reports
        pod_arrivals = bus.pod_arrivals
        topo_pods = self.topology.n_pods
        for p in range(topo_pods):
            pod_arrivals.setdefault(p, 0)
        heappop = heapq.heappop
        seqc = self._seq
        work = self._work
        migrating = self._migrating
        pub_alive = self._pub_alive
        # fault/health/hedge/obs locals: all None/False on a clean run,
        # so the hot branches cost one comparison each and the clean
        # trace stays bit-identical to the clean-run loop
        obs = self.obs
        next_roll = obs.next_roll if obs is not None else inf
        hedge = self.hedge
        hedge_on = hedge is not None
        hedge_delay = hedge.delay_ms if hedge_on else 0.0
        hedges = self._hedges
        blackouts = self._blackouts or None
        health = self.health
        fault_cap = self.leap_fault_cap
        limp_saved = self._limp_saved

        n = len(replicas)
        nb = np.full(n, inf)     # next step boundary per replica
        sseq = [0] * n           # that boundary's legacy push sequence
        soa = self._soa_rebuild()
        ga, gp = soa.ga, soa.gp
        views = self._route_views

        now = 0.0
        injected = 0
        events = 0
        imin = 0
        tn = inf                 # cached min(nb) and its argmin
        dirty = False
        ai, n_arr = 0, len(arrivals)
        # heap-top / next-arrival caches: the heap mutates only inside
        # the heap-event branch and arrivals only advance on consumption,
        # so both are loop-invariant everywhere else
        th = heap[0][0] if heap else inf
        ta = arrivals[0].arrive_ms if n_arr else inf

        def resolve(done_list, t):
            # fast-loop mirror of _resolve_hedges: first completion
            # wins.  Cancelling a copy resident on a mid-chain replica
            # truncates that chain first (the banked tail assumed the
            # cancelled stream's membership; strict-< keeps the steps a
            # per-step loop had already run), then cancels and kicks
            # with the same leap machinery the arrival path uses.
            nonlocal events, work, tn, imin, dirty
            if not hedges:
                return
            for r in done_list:
                reg = hedges.get(r.rid)
                if reg is None:
                    continue
                for rec in reg["copies"]:
                    obj, status = rec
                    if obj is r:
                        rec[1] = "done"
                    elif status == "live":
                        if obj.done_ms >= 0:
                            rec[1] = "done"     # banked: both count
                            continue
                        j = obj.replica
                        eng_j = (replicas[j]
                                 if 0 <= j < len(replicas) else None)
                        if eng_j is not None \
                                and eng_j.requests.get(obj.rid) is obj:
                            if nb[j] < inf and eng_j._leap is not None:
                                e2, u2 = eng_j.leap_truncate(t)
                                if u2:
                                    events -= u2
                                    sseq[j] -= u2
                                    nb[j] = e2
                                    if e2 < tn:
                                        imin, tn = j, e2
                                    elif j == imin:
                                        dirty = True
                            eng_j.cancel(obj.rid, t)
                            rec[1] = "cancelled"
                            self._cancelled_hedges += 1
                            if obs is not None:
                                obs.on_cancel(obj, j, t)
                            if nb[j] == inf and not retired[j] \
                                    and eng_j.active:
                                end2, done2, k2 = eng_j.step_leap(
                                    t, bank_le=max_ms,
                                    end_le=abar[0] if abar else inf,
                                    max_bank=(fault_cap if fault_cap
                                              and j in limp_saved
                                              else 0))
                                seqc.n += k2
                                sseq[j] = seqc.n - 1
                                events += k2 - 1
                                if end2 > t:
                                    nb[j] = end2
                                    work += 1
                                    if end2 < tn:
                                        imin, tn = j, end2
                                    elif j == imin:
                                        dirty = True
                                if done2:
                                    if obs is not None:
                                        obs.on_completions(done2, j)
                                    resolve(done2, t)
                            if bus_live:
                                ga[j] = len(eng_j.active)
                                gp[j] = eng_j.admission.num_parked
                        else:               # in KV transit somewhere
                            rec[1] = "cancel_pending"

        while True:
            if dirty:
                imin = int(nb.argmin())
                # plain float: tn feeds `now`, engine clocks, and
                # telemetry - np.float64 must never leak into the trace
                tn = float(nb[imin])
                dirty = False
            if ta <= th and ta <= tn:
                if ta == inf:
                    break
                t, kind = ta, 0                     # arrival
            elif th < tn:
                t, kind = th, 1                     # heap event
            elif tn < th:
                t, kind = tn, 2                     # step boundary
            elif tn == inf:
                break
            else:
                # exact boundary/heap time tie: the smaller push sequence
                # pops first, exactly as the legacy heap ordered it
                hseq = heap[0][1]
                bi, bseq = -1, None
                for j in np.nonzero(nb == tn)[0]:
                    if bseq is None or sseq[j] < bseq:
                        bi, bseq = int(j), sseq[j]
                if hseq < bseq:
                    t, kind = th, 1
                else:
                    t, kind = tn, 2
                    imin = bi
            if t > max_ms:
                break
            events += 1
            if t >= next_roll:
                # windowed-metrics roll: counters bucket by event time
                # and the gauge sample only reads chain-invariant state,
                # so closing here - the first processed event at or past
                # the boundary, same as the slow loop - emits identical
                # rows even when a leap chain banked across the boundary
                obs.roll(t)
                next_roll = obs.next_roll

            if kind == 2:                           # step boundary
                i = imin
                work -= 1
                now = t
                dirty = True
                eng = replicas[i]
                if eng.active and not retired[i]:
                    end, done, k = eng.step_leap(
                        t, bank_le=max_ms,
                        end_le=abar[0] if abar else inf,
                        max_bank=(fault_cap if fault_cap
                                  and i in limp_saved else 0))
                    seqc.n += k
                    sseq[i] = seqc.n - 1
                    events += k - 1
                    if end > t:
                        nb[i] = end
                        work += 1
                    else:
                        nb[i] = inf
                    if done:
                        if obs is not None:
                            obs.on_completions(done, i)
                        if hedge_on:
                            resolve(done, t)
                        if bus_live:
                            # gauges move only on a completion step
                            # (release, work-conserve, periodic promote);
                            # a completion-free step leaves both exactly
                            # as the slow path would have left them
                            ga[i] = len(eng.active)
                            gp[i] = eng.admission.num_parked
                else:
                    nb[i] = inf
                continue

            if kind == 0:                           # arrival
                payload = arrivals[ai]
                ai += 1
                ta = arrivals[ai].arrive_ms if ai < n_arr else inf
                work -= 1
                now = t
                injected += 1
                bus.arrivals += 1
                p = payload.pod % topo_pods
                pod_arrivals[p] += 1
                if hedge_on:
                    # same push order as the slow loop: the hedge event
                    # takes its sequence number before the submit path
                    # bulk-consumes the chain's
                    self._push(t + hedge_delay, "hedge", payload)
                    th = heap[0][0]
                if obs is not None:
                    obs.on_inject(payload, "arrive", t, p)
                vlist = views
            else:                                   # heap event
                t, hseq, hkind, payload = heappop(heap)
                if hkind == "publish":
                    heappop(abar)
                    i = payload
                    if not retired[i]:
                        # a blacked-out replica keeps serving and keeps
                        # its publish chain alive, but the bus never
                        # hears from it: routers (and the SoA gauge
                        # mirror) see the pre-blackout report aging
                        if blackouts is None \
                                or not _in_window(blackouts.get(i), t):
                            bus.publish(i, t)
                            rep = reports[i]
                            ga[i] = rep.num_active
                            gp[i] = rep.num_parked
                            if obs is not None:
                                obs.on_publish(i, t, rep)
                            if health is not None \
                                    and self._health_tick(i, t):
                                # routable pool changed: rebuild the SoA
                                # mirror like a scale event
                                soa = self._soa_rebuild()
                                ga, gp = soa.ga, soa.gp
                                views = self._route_views
                        if work > 0:
                            self._work = work
                            self._push(bus.next_publish_ms(t),
                                       "publish", i)
                            work = self._work
                        else:
                            pub_alive[i] = False
                    else:
                        pub_alive[i] = False
                    th = heap[0][0] if heap else inf
                    continue
                if hkind == "scale":
                    heappop(abar)
                    self._work = work
                    self._migrating = migrating
                    # the scale paths and controllers read the legacy
                    # per-replica stepping mirrors: sync them from nb
                    stepping = self._stepping
                    step_end = self._step_end
                    for j in range(n):
                        b = nb[j]
                        if b < inf:
                            stepping[j] = True
                            step_end[j] = float(b)
                        else:
                            stepping[j] = False
                    decision = (self.autoscaler(self, t)
                                if self.autoscaler else None)
                    if isinstance(decision, SimServeEngine):
                        decision = ScaleDecision(add=decision)
                    if obs is not None:
                        # record BEFORE applying: the snapshot must be
                        # the pre-action state the controller read
                        obs.on_scale(t, decision)
                    if decision is not None:
                        if decision.add is not None:
                            self._scale_out(decision.add, t, decision.pod)
                        elif decision.remove is not None:
                            self._scale_in(decision.remove, t)
                    work = self._work
                    migrating = self._migrating
                    if work > 0:
                        self._work = work
                        self._push(t + self.autoscale_every_ms,
                                   "scale", None)
                        work = self._work
                    if decision is not None:
                        if len(replicas) != n:
                            grow = len(replicas) - n
                            nb = np.concatenate([nb, np.full(grow, inf)])
                            sseq.extend([0] * grow)
                            n = len(replicas)
                        soa = self._soa_rebuild()
                        ga, gp = soa.ga, soa.gp
                        views = self._route_views
                        dirty = True
                    th = heap[0][0] if heap else inf
                    continue
                if hkind == "fault":
                    op, f = payload
                    idx_f = f.replica
                    if idx_f < n and op in ("limp_on", "limp_off",
                                            "crash"):
                        eng_f = replicas[idx_f]
                        if nb[idx_f] < inf and eng_f._leap is not None:
                            # fault edges are not abar barriers: the
                            # victim's chain banked straight past the
                            # edge, so roll back the not-yet-run tail -
                            # steps starting at or after the edge must
                            # see post-edge cost/membership, exactly as
                            # in the per-step world where the fault's
                            # setup-time sequence pops first
                            e, u = eng_f.leap_truncate(t)
                            if u:
                                events -= u
                                sseq[idx_f] -= u
                                nb[idx_f] = e
                                if e < tn:
                                    imin, tn = idx_f, e
                                elif idx_f == imin:
                                    dirty = True
                    self._work = work
                    self._migrating = migrating
                    # the crash path reads the legacy stepping mirrors
                    # (done_t of the in-flight step): sync them from nb
                    stepping = self._stepping
                    step_end = self._step_end
                    for j in range(n):
                        b = nb[j]
                        if b < inf:
                            stepping[j] = True
                            step_end[j] = float(b)
                        else:
                            stepping[j] = False
                    self._apply_fault(op, f, t)
                    work = self._work
                    migrating = self._migrating
                    if op in ("crash", "restart"):
                        # pool membership (or a publish chain) changed:
                        # rebuild the gauge mirror like a scale event
                        soa = self._soa_rebuild()
                        ga, gp = soa.ga, soa.gp
                        views = self._route_views
                    th = heap[0][0] if heap else inf
                    continue
                if hkind == "hedge":
                    r = payload
                    if r.done_ms < 0:
                        # inline _fire_hedge on the fast machinery: same
                        # registry bookkeeping, same plain route() call
                        # on the same filtered views (route_soa cannot
                        # apply - the candidate set excludes live-copy
                        # hosts), leap-aware submit and kick
                        reg = hedges.get(r.rid)
                        issued = reg["issued"] if reg is not None else 0
                        if issued < hedge.max_hedges:
                            exclude = set()
                            if reg is not None:
                                for obj, status in reg["copies"]:
                                    if status == "live":
                                        exclude.add(obj.replica)
                            else:
                                exclude.add(r.replica)
                            hviews = [v for v in views
                                      if v.idx not in exclude]
                            if hviews:
                                twin = r.fresh()
                                if reg is None:
                                    reg = {"copies": [[r, "live"]],
                                           "issued": 0}
                                    hedges[r.rid] = reg
                                reg["copies"].append([twin, "live"])
                                reg["issued"] = issued + 1
                                self._hedges_issued += 1
                                if obs is not None:
                                    obs.on_hedge(twin, t)
                                j = route(twin, hviews)
                                twin.replica = j
                                eng_j = replicas[j]
                                if nb[j] < inf \
                                        and eng_j._leap is not None:
                                    e, u, admitted = eng_j.leap_submit(
                                        twin, t)
                                    if u:
                                        events -= u
                                        sseq[j] -= u
                                        nb[j] = e
                                        if e < tn:
                                            imin, tn = j, e
                                        elif j == imin:
                                            dirty = True
                                else:
                                    admitted = eng_j.submit(twin)
                                if obs is not None:
                                    obs.on_routed(twin, j, admitted, t)
                                if nb[j] == inf and not retired[j] \
                                        and eng_j.active:
                                    end, done, k = eng_j.step_leap(
                                        t, bank_le=max_ms,
                                        end_le=abar[0] if abar else inf,
                                        max_bank=(fault_cap if fault_cap
                                                  and j in limp_saved
                                                  else 0))
                                    seqc.n += k
                                    sseq[j] = seqc.n - 1
                                    events += k - 1
                                    if end > t:
                                        nb[j] = end
                                        work += 1
                                        if end < tn:
                                            imin, tn = j, end
                                        elif j == imin:
                                            dirty = True
                                    if done:
                                        if obs is not None:
                                            obs.on_completions(done, j)
                                        resolve(done, t)
                                if bus_live:
                                    ga[j] = len(eng_j.active)
                                    gp[j] = eng_j.admission.num_parked
                                if reg["issued"] < hedge.max_hedges:
                                    self._push(t + hedge_delay,
                                               "hedge", r)
                    th = heap[0][0] if heap else inf
                    continue
                # migrate: a drained stream re-arrives at the router
                th = heap[0][0] if heap else inf
                work -= 1
                now = t
                migrating -= 1
                vlist = views
                if hedge_on:
                    reg = hedges.get(payload.rid)
                    rec = (next((c for c in reg["copies"]
                                 if c[0] is payload), None)
                           if reg is not None else None)
                    if rec is not None:
                        # a copy cancelled while its KV was in transit
                        # is dropped here, at the re-arrival it was
                        # racing toward
                        if rec[1] == "cancel_pending":
                            rec[1] = "cancelled"
                            self._cancelled_hedges += 1
                            if obs is not None:
                                obs.on_cancel(payload, -1, t)
                            continue
                        # steer away from a resident twin (engines key
                        # streams by rid), or fold into it when nowhere
                        # collision-free remains
                        occupied = set()
                        for c in reg["copies"]:
                            o = c[0]
                            if o is payload or c[1] != "live":
                                continue
                            j = o.replica
                            if 0 <= j < len(replicas) and \
                                    replicas[j].requests.get(
                                        payload.rid) is o:
                                occupied.add(j)
                        if occupied:
                            kept = [v for v in vlist
                                    if v.idx not in occupied]
                            if kept:
                                vlist = kept
                            else:
                                rec[1] = "cancelled"
                                self._cancelled_hedges += 1
                                if obs is not None:
                                    obs.on_cancel(payload, -1, t)
                                continue
                if obs is not None:
                    obs.on_inject(payload, "migrate", t,
                                  payload.pod % topo_pods)

            # shared submit path (arrive + migrate).  route_soa only
            # applies to the unfiltered routable list (vlist is views);
            # a hedge-steered migrant takes the same plain route() the
            # slow loop would
            i = (rsoa(payload, soa, vlist)
                 if rsoa is not None and vlist is views
                 else route(payload, vlist))
            payload.replica = i
            eng = replicas[i]
            if nb[i] < inf and eng._leap is not None:
                # mid-chain landing: the engine rewinds the not-yet-due
                # banked tail for the submit and keeps the chain when the
                # request merely parks; a rollback > 0 (activation) owes
                # the same event-count and push-sequence refunds a
                # per-step loop would never have spent
                e, u, admitted = eng.leap_submit(payload, t)
                if u:
                    events -= u
                    sseq[i] -= u
                    nb[i] = e
                    if e < tn:          # boundary moved earlier; the
                        imin, tn = i, e  # cached min can only improve
            else:
                admitted = eng.submit(payload)
            if obs is not None:
                obs.on_routed(payload, i, admitted, t)
            if nb[i] == inf and eng.active:
                end, done, k = eng.step_leap(
                    t, bank_le=max_ms, end_le=abar[0] if abar else inf,
                    max_bank=(fault_cap if fault_cap
                              and i in limp_saved else 0))
                seqc.n += k
                sseq[i] = seqc.n - 1
                events += k - 1
                if end > t:
                    nb[i] = end
                    work += 1
                    if end < tn:
                        imin, tn = i, end
                    elif i == imin:
                        dirty = True
                if done:
                    if obs is not None:
                        obs.on_completions(done, i)
                    if hedge_on:
                        resolve(done, t)
            if bus_live:
                ga[i] = len(eng.active)
                gp[i] = eng.admission.num_parked

        self._work = work
        self._migrating = migrating
        stepping = self._stepping
        step_end = self._step_end
        for j in range(len(replicas)):
            b = nb[j]
            if b < inf:
                stepping[j] = True
                step_end[j] = float(b)
            else:
                stepping[j] = False
        return self._finalize(now, injected, events)


def run_fleet(requests: List[Request], router: Union[Router, str],
              cfg: Optional[FleetConfig] = None,
              slo: Optional[SLO] = None,
              autoscale=False,
              max_ms: float = 120_000.0,
              staleness_ms: float = 0.0,
              jitter_ms: float = 0.0,
              signal_seed: int = 0,
              max_replicas: int = 8,
              rps_per_replica: Optional[float] = None,
              router_seed: Optional[int] = None,
              victim: str = "least_outstanding",
              pod_scoped: bool = False,
              season_period_ms: Optional[float] = None,
              obs=None,
              faults: Optional[FaultSchedule] = None,
              health: Optional[HealthPolicy] = None,
              hedge: Optional[HedgePolicy] = None,
              soa_fast_path: bool = True,
              fast_path_coverage: str = "full",
              leap_fault_cap: int = 0) -> ClusterResult:
    """One-call convenience wrapper used by benches, tests, and the CLI.

    ``router`` is a built ``Router`` or a policy name; a name is resolved
    through ``make_router`` seeded with ``router_seed`` (default: the
    fleet's ``signal_seed``), so a by-name run is a pure function of its
    seed arguments - there is no unseeded RNG path left for ``p2c``.
    ``autoscale``: False/None (fixed pool), True/'queue' (queue-depth
    scale-out hook), 'slo' (SLO-driven controller with scale-in),
    'predictive' (SLO controller + arrival-trend scaling; wants
    ``rps_per_replica``), or any ``(fleet, now_ms) -> ScaleDecision``
    callable.  ``staleness_ms`` > 0 makes every routing/scaling signal
    come from the bus's last published report (plus uniform
    ``jitter_ms`` per publish, seeded by ``signal_seed``).
    ``victim``/``pod_scoped``/``season_period_ms`` shape the SLO
    controller kinds (see ``SLOAutoscaler``); defaults are the legacy
    pool-scalar policy.  One ``FleetTopology`` built from ``cfg.n_pods``
    is shared by the router (by-name construction), the fleet, and the
    controller, so pod-scoped decisions and pod-affine routing read the
    same replica<->pod partition.  ``obs`` threads an
    ``obs.Observability`` bundle through the run (None = untraced,
    zero-overhead).  ``faults``/``health``/``hedge`` arm the fault
    plane (see ``cluster.faults``): all three default off and, like
    ``obs``, leaving them off is bit-identical to a build without them.
    ``health`` requires ``staleness_ms`` > 0 - ejection judges the
    published gauges, so it needs a periodic bus to read.
    ``soa_fast_path`` forces the struct-of-arrays event loop off when
    False (A/B digest checks; the loops are bit-identical by contract).
    ``fast_path_coverage`` ("full"/"clean") and ``leap_fault_cap``
    thread through to ``Fleet`` - "clean" restores the narrower gate (the
    fast loop only on obs/fault/health/hedge-free runs), the cap bounds
    banked steps on limping replicas; both are bit-identical knobs.
    """
    cfg = cfg or FleetConfig()
    env_fp = os.environ.get("REPRO_FAST_PATH", "").lower()
    if env_fp in ("off", "0"):
        # global A/B kill switch (cluster_bench --fast-path off, CI digest
        # checks): every run through this chokepoint - including pooled
        # bench workers, which inherit the env - takes the per-step
        # event-calendar path the fast paths are contractually
        # bit-identical to
        soa_fast_path = False
        if cfg.leap_stepping:
            cfg = dataclasses.replace(cfg, leap_stepping=False)
    elif env_fp == "clean":
        # A/B the coverage extension in isolation: fast loop on
        # clean runs only, legacy calendar under obs/faults/health/hedge
        fast_path_coverage = "clean"
    slo = slo or SLO()
    if health is not None and staleness_ms <= 0.0:
        raise ValueError("health ejection reads the periodic published "
                         "gauges; pass staleness_ms > 0")
    if isinstance(router, str):
        topo = FleetTopology(cfg.n_pods)
        router = make_router(
            router, seed=(signal_seed if router_seed is None
                          else router_seed), n_pods=cfg.n_pods,
            topology=topo)
    else:
        topo = getattr(router, "topology", None) or FleetTopology(cfg.n_pods)
    telem = ClusterTelemetry(slo)
    bus = SignalBus(slo=slo, period_ms=staleness_ms, jitter_ms=jitter_ms,
                    seed=signal_seed)
    scaler = make_autoscaler(autoscale, cfg, rps_per_replica=rps_per_replica,
                             max_replicas=max_replicas, victim=victim,
                             pod_scoped=pod_scoped,
                             season_period_ms=season_period_ms)
    fleet = Fleet(cfg.make_engines(), router, telem, autoscaler=scaler,
                  bus=bus, topology=topo, obs=obs, faults=faults,
                  health=health, hedge=hedge, soa_fast_path=soa_fast_path,
                  fast_path_coverage=fast_path_coverage,
                  leap_fault_cap=leap_fault_cap)
    return fleet.run(requests, max_ms=max_ms)
