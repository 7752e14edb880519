"""Pluggable fleet routing policies (DESIGN.md 7).

The port's own copy of ``repro.cluster.router``, unchanged in behaviour:
the port imports nothing of ``repro``.

The router is the cluster's analogue of the paper's lock-acquisition path:
every arriving stream must be placed on *some* replica, and a policy that
ignores per-replica active-set occupancy recreates lock-style collapse one
level up - it keeps feeding replicas whose batch is already past the HBM
knee, exactly like threads piling onto a saturated lock.

Routers never touch engines: they read ``signals.ReplicaView`` accessors,
i.e. each replica's *last published* occupancy report (live and exact only
when the signal bus is omniscient).  The fleet passes views for live
(non-retired) replicas only; policies return ``view.idx``.

* ``round_robin``       - occupancy-blind; the collapse baseline;
* ``least_outstanding`` - classic least-loaded by outstanding streams;
  deliberately **capacity-blind**: on heterogeneous pools it equalizes
  queue lengths across unequal replicas and drowns the small ones;
* ``p2c``               - power-of-two-choices (seeded sampling);
* ``gcr_aware``         - reads each replica's GCR admission signals
  (``num_active`` / ``active_limit`` / ``num_parked``) and applies pod
  affinity: the GCR-NUMA/GCR-POD preferred-socket construction lifted to
  replica placement.  Replicas are statically partitioned among pods
  (replica ``i`` serves pod ``i % n_pods``), so each replica's active set
  stays pod-pure and never pays the cross-pod mixing penalty; within the
  partition the router is **capacity-aware** - it fills the active set
  with the most *normalized* headroom (headroom / active_limit) first and
  only then parks on the shortest limit-normalized passive queue, so a
  mixed pool (heterogeneous active limits) loads replicas in proportion
  to what they can actually absorb.  On homogeneous pools normalization
  divides by a common constant and the placement order is unchanged;
* ``affinity``          - sticky-with-spillover session affinity: follow
  the session's warm replica (its prefix KV lives there) unless that
  replica is out of headroom *and* materially more backed up than the
  best alternative, then fall back to ``gcr_aware`` and re-home the
  session.  GCR-NUMA's warm-socket preference, one layer up;
* ``prefix_aware``      - scores candidates by estimated warm prefix
  tokens x normalized headroom from LB-side placement history - the
  generalization of ``affinity`` to prefix groups shared by many
  sessions; falls back to ``gcr_aware`` when nothing scores.

The sticky/prefix maps live in the router, i.e. the load balancer: the LB
remembers where it sent a session first-hand (always fresh, like the
arrival counter), while per-replica cache *occupancy* crosses the stale
signal bus like every other replica-side gauge.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .signals import ReplicaView
from .topology import FleetTopology

ROUTERS = ("round_robin", "least_outstanding", "p2c", "gcr_aware",
           "affinity", "prefix_aware")


class Router:
    """Route every arriving request to a replica index.

    ``views`` covers the fleet's *live* replicas; the list may grow or
    shrink between calls (autoscaler), so policies must index it afresh
    each time and return ``view.idx`` (the fleet-wide replica index),
    never a position in ``views``.

    Pod-aware policies carry a ``topology`` (the shared
    ``FleetTopology``); the fleet adopts it so router partition, spawn
    placement, and controller rollups all read one replica<->pod map.
    """

    name = "base"
    topology: Optional[FleetTopology] = None
    # span tracer hook (obs.SpanTracer), installed per run by an
    # Observability bundle; None is the zero-overhead default.  Scoring
    # policies deposit their per-candidate keys on it (``note_scores``)
    # so the recorded route decision carries the scores the placement
    # scan actually computed
    tracer = None

    # vectorized twin of ``route`` for the fleet's SoA fast loop: reads
    # the fleet-maintained gauge arrays (``fleet._FleetSoA``) instead of
    # per-view property chains, bit-identical placement by construction
    # (small integer gauges are exact in float64, divisions see the same
    # operands, and np.argmin's first-occurrence rule is the strict-<
    # lowest-index tie-break every scan below uses).  None = no
    # vectorized form; the fast loop falls back to ``route`` with the
    # same live views the slow loop passes.
    route_soa = None

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        """Drop per-run state (rotation counters, RNG position, sticky
        maps).  ``Fleet.run`` calls this on entry, so one router instance
        drives any number of runs bit-identically - routing randomness is
        pinned by the construction seed, never by how often the instance
        was used before."""


class RoundRobinRouter(Router):
    """Occupancy-blind rotation - the collapse baseline."""

    name = "round_robin"

    def __init__(self) -> None:
        self._i = 0

    def reset(self) -> None:
        self._i = 0

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        v = views[self._i % len(views)]
        self._i += 1
        return v.idx


class LeastOutstandingRouter(Router):
    """Fewest unfinished streams (active + parked); ties to lowest index."""

    name = "least_outstanding"

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        # manual scan in ascending idx order; strict < keeps the lowest
        # index on ties, identical to min(key=(outstanding, idx))
        best = views[0]
        best_out = best.outstanding
        for v in views[1:]:
            out = v.outstanding
            if out < best_out:
                best, best_out = v, out
        return best.idx

    def route_soa(self, req, soa, views: Sequence[ReplicaView]) -> int:
        live = soa.live
        # outstanding = active + parked; argmin keeps the first (lowest
        # idx - live is ascending) on ties, matching the scan above
        return int(live[int(np.argmin(soa.ga[live] + soa.gp[live]))])


class PowerOfTwoRouter(Router):
    """Sample two replicas, keep the less loaded one (seeded, deterministic)."""

    name = "p2c"

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        n = len(views)
        if n == 1:
            return views[0].idx
        i, j = (int(x) for x in self._rng.choice(n, size=2, replace=False))
        a, b = views[i], views[j]
        if (b.outstanding, b.idx) < (a.outstanding, a.idx):
            return b.idx
        return a.idx


class GCRAwareRouter(Router):
    """Occupancy- and capacity-aware, pod-affine placement (GCR-POD at the
    fleet layer).

    Falls back gracefully on replicas without admission limits
    (``NoAdmission``): there is no headroom signal, so within the pod
    partition it degrades to least-outstanding.

    The pod partition and the idx->view map depend only on the *identity*
    of the live-view list - the fleet rebuilds that list exclusively on
    scaling events - so both are cached per list and the per-arrival cost
    is one occupancy scan over the pod's candidates, not an O(n_replicas)
    list rebuild (the cache holds a reference to the keyed list, so a
    recycled ``id()`` can never alias a stale entry).
    """

    name = "gcr_aware"

    def __init__(self, n_pods: int = 2,
                 topology: Optional[FleetTopology] = None) -> None:
        # the partition is owned by the shared FleetTopology (built here
        # when the caller passes only a pod count); replica i serves pod
        # topology.pod_of(i) - the static i % n_pods rule unless a
        # pod-targeted spawn recorded an explicit assignment
        self.topology = topology or FleetTopology(n_pods)
        self.n_pods = self.topology.n_pods
        self._cached_views: Optional[Sequence[ReplicaView]] = None
        self._groups: Dict[int, List[ReplicaView]] = {}
        self._by_idx: Dict[int, ReplicaView] = {}

    def reset(self) -> None:
        self._cached_views = None
        self._groups = {}
        self._by_idx = {}

    def _sync_cache(self, views: Sequence[ReplicaView]) -> None:
        if views is not self._cached_views:
            self._cached_views = views
            self._groups = {}
            self._by_idx = {v.idx: v for v in views}

    def _view_by_idx(self, views: Sequence[ReplicaView],
                     idx: int) -> Optional[ReplicaView]:
        self._sync_cache(views)
        return self._by_idx.get(idx)

    def _partition(self, pod: int,
                   views: Sequence[ReplicaView]) -> List[ReplicaView]:
        self._sync_cache(views)
        pod %= self.n_pods
        group = self._groups.get(pod)
        if group is None:
            pod_of = self.topology.pod_of
            group = [v for v in views if pod_of(v.idx) == pod]
            if not group:
                group = list(views)
            self._groups[pod] = group
        return group

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        # _partition's cache-hit path, inlined: the view list's identity
        # only changes on scaling events, so per arrival this is one
        # identity test and one dict probe
        if views is not self._cached_views:
            self._cached_views = views
            self._groups = {}
            self._by_idx = {v.idx: v for v in views}
        pod = req.pod % self.n_pods
        group = self._groups.get(pod)
        if group is None:
            pod_of = self.topology.pod_of
            group = [v for v in views if pod_of(v.idx) == pod]
            if not group:
                group = list(views)
            self._groups[pod] = group
        tracer = self.tracer
        scores = [] if tracer is not None else None
        # single pass in ascending idx order; strict < keeps the first
        # (lowest-idx) candidate on ties, matching the (key, idx) min()
        free_idx = -1
        free_key = 0.0
        park_idx = -1
        park_key = 0.0
        for v in group:
            limit = v.active_limit
            if limit is None:
                # unlimited replicas in the pool: least-outstanding in-pod
                return min(group, key=lambda v: (v.outstanding, v.idx)).idx
            head = limit - v.num_active
            if head > 0:
                # fill the (proportionally) emptiest active set first
                key = -head / limit
                if free_idx < 0 or key < free_key:
                    free_idx, free_key = v.idx, key
                if scores is not None:
                    scores.append({"idx": v.idx, "rank": "free",
                                   "key": key})
            elif free_idx < 0:
                # all at their limit so far: track the shortest normalized
                # passive queue (used only if no free slot turns up)
                key = v.num_parked / limit
                if park_idx < 0 or key < park_key:
                    park_idx, park_key = v.idx, key
                if scores is not None:
                    scores.append({"idx": v.idx, "rank": "park",
                                   "key": key})
        if tracer is not None:
            tracer.note_scores(self.name, scores)
        return free_idx if free_idx >= 0 else park_idx

    def route_soa(self, req, soa, views: Sequence[ReplicaView]) -> int:
        if self.tracer is not None:
            # scoring trace wants the per-candidate keys of the scalar
            # scan; tracing runs never take the fast loop anyway
            return self.route(req, views)
        pod = req.pod % self.n_pods
        g = soa.groups[pod]
        if soa.group_homo[pod]:
            # shared limit: -head/limit is order- and tie-preserving in
            # -head, and headroom argmax is actives argmin (x -> lim - x
            # is strictly decreasing, equal actives give equal headroom),
            # so the free winner is the first-occurrence least-active
            # replica and the park winner plain argmin of the queue
            gag = soa.ga[g]
            j = int(gag.argmin())
            if gag[j] < soa.group_lim0[pod]:
                return int(g[j])
            return int(g[int(soa.gp[g].argmin())])
        if soa.group_nan[pod]:
            # unlimited replica in the pod: least-outstanding in-pod
            return int(g[int((soa.ga[g] + soa.gp[g]).argmin())])
        lim = soa.group_lim[pod]
        head = lim - soa.ga[g]
        free = head > 0.0
        if free.any():
            return int(g[int(np.where(free, -head / lim,
                                      np.inf).argmin())])
        return int(g[int((soa.gp[g] / lim).argmin())])


def _worth_following(home: ReplicaView, views: Sequence[ReplicaView],
                     min_headroom_frac: float, spill_slack: float) -> bool:
    """Shared spillover test: keep routing to a warm replica unless it is
    out of headroom AND its normalized passive queue exceeds the pool's
    best by more than ``spill_slack`` - at saturation every queue grows,
    and trading warm state for an equally long cold queue is pure loss."""
    h = home.headroom
    if h is None:
        return True          # unlimited replica: no congestion signal
    if h > min_headroom_frac * home.active_limit:
        return True          # room at home
    best = None
    for v in views:
        limit = v.active_limit
        if limit:
            norm = v.num_parked / limit
            if best is None or norm < best:
                best = norm
    if best is None:
        best = 0.0
    return (home.num_parked / home.active_limit) - best <= spill_slack


class AffinityRouter(GCRAwareRouter):
    """Sticky session routing with headroom-gated spillover.

    A session's follow-up turn goes back to the replica that served it
    last (its prefix KV is warm there), UNLESS the home's normalized
    headroom is below ``min_headroom_frac`` *and* its normalized passive
    queue exceeds the pool's best by more than ``spill_slack`` - at
    saturation every queue grows, and abandoning warm state to stand in
    an equally long cold queue is pure waste, so mere fullness is not a
    reason to spill.  On spillover (or for session-free requests) this is
    exactly ``gcr_aware``, and the session is re-homed to wherever the
    fallback placed it (its state will be warm *there* next turn).
    Replicas the autoscaler retired leave the view list, so a stale home
    entry falls through to the fallback instead of routing to a corpse.

    **Cache-occupancy-aware spillover** (opt-in): with ``cache_slack > 0``
    the spill decision consults the home replica's *published* prefix-
    cache gauges (``cache_tokens`` / ``cache_hit_rate`` - replica-side
    state, stale under a periodic bus like every other gauge): a home
    whose cache is actually warm earns up to ``cache_slack`` extra
    normalized-queue slack before the session abandons it, while a home
    whose cache went cold (evicted out, or never hitting) spills at the
    base threshold.  At ``cache_slack == 0.0`` (default) the gauges are
    never read and routing is bit-identical to the queue-only rule.
    """

    name = "affinity"

    def __init__(self, n_pods: int = 2, min_headroom_frac: float = 0.0,
                 spill_slack: float = 0.25,
                 cache_slack: float = 0.0,
                 topology: Optional[FleetTopology] = None) -> None:
        super().__init__(n_pods, topology)
        self.min_headroom_frac = min_headroom_frac
        self.spill_slack = spill_slack
        self.cache_slack = cache_slack
        self._home: Dict[int, int] = {}     # session_id -> replica idx

    def reset(self) -> None:
        super().reset()
        self._home.clear()

    def _follow(self, home: ReplicaView,
                views: Sequence[ReplicaView]) -> bool:
        slack = self.spill_slack
        if self.cache_slack and home.cache_tokens > 0:
            slack += self.cache_slack * home.cache_hit_rate
        return _worth_following(home, views, self.min_headroom_frac, slack)

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        sid = req.session_id
        if sid < 0:
            return super().route(req, views)
        home_idx = self._home.get(sid)
        if home_idx is not None:
            home = self._view_by_idx(views, home_idx)
            if home is not None and self._follow(home, views):
                return home_idx
        i = super().route(req, views)
        self._home[sid] = i
        return i

    def _follow_soa(self, home_idx: int, soa,
                    views: Sequence[ReplicaView]) -> bool:
        if self.cache_slack:
            # cache-aware slack reads the published prefix gauges; keep
            # the scalar path (one view, not a scan - nothing to gain)
            home = self._view_by_idx(views, home_idx)
            return home is not None and self._follow(home, views)
        lim_h = soa.glim[home_idx]
        if np.isnan(lim_h):
            return True          # unlimited replica: no congestion signal
        if lim_h - soa.ga[home_idx] > self.min_headroom_frac * lim_h:
            return True          # room at home
        live = soa.live
        lims = soa.glim[live]
        ok = ~np.isnan(lims) & (lims != 0.0)   # the scalar scan's `if limit:`
        best = float(np.min(soa.gp[live][ok] / lims[ok])) \
            if ok.any() else 0.0
        return (soa.gp[home_idx] / lim_h) - best <= self.spill_slack

    def route_soa(self, req, soa, views: Sequence[ReplicaView]) -> int:
        sid = req.session_id
        if sid < 0:
            return super().route_soa(req, soa, views)
        home_idx = self._home.get(sid)
        if home_idx is not None and soa.alive[home_idx] \
                and self._follow_soa(home_idx, soa, views):
            return home_idx
        i = super().route_soa(req, soa, views)
        self._home[sid] = i
        return i


class PrefixAwareRouter(GCRAwareRouter):
    """Score candidates by estimated warm prefix tokens x headroom.

    The LB keeps per-prefix placement history (prefix_id -> replica ->
    estimated cached tokens, refreshed on every placement); a candidate's
    score is the prefill it would skip, weighted by a soft headroom/queue
    factor - free slots attract, a long passive queue repels, but the
    weight never hits zero just because the pool is saturated (at
    saturation everyone's headroom is 0 and a hard x-headroom score would
    degenerate to the fallback exactly when warm routing pays most).  A
    warm winner still goes through the shared spillover test, so a
    drowned replica's cache cannot keep attracting load.  Zero estimate
    everywhere (first turn, evicted-everywhere prefix, session-free
    request) falls back to ``gcr_aware`` - the no-session overhead is
    exactly nothing.
    """

    name = "prefix_aware"
    # placement-history scoring walks a dict per prefix - no array form;
    # shadow the inherited vectorized route so the fast loop falls back
    # to the scalar scan (still correct: views read the same gauges)
    route_soa = None

    def __init__(self, n_pods: int = 2, min_headroom_frac: float = 0.0,
                 spill_slack: float = 0.25,
                 topology: Optional[FleetTopology] = None) -> None:
        super().__init__(n_pods, topology)
        self.min_headroom_frac = min_headroom_frac
        self.spill_slack = spill_slack
        self._placed: Dict[int, Dict[int, int]] = {}

    def reset(self) -> None:
        super().reset()
        self._placed.clear()

    @staticmethod
    def _weight(v: ReplicaView) -> float:
        if v.active_limit is None:
            return 1.0
        free = (1.0 + max(0, v.headroom)) / (1.0 + v.active_limit)
        backlog = 1.0 + v.num_parked / v.active_limit
        return free / backlog

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        pid = getattr(req, "prefix_id", -1)
        if pid < 0:
            return super().route(req, views)
        plen = getattr(req, "prefix_len", 0)
        est = self._placed.get(pid)
        choice: Optional[int] = None
        if est and plen > 0:
            self._sync_cache(views)
            by_idx = self._by_idx
            best_score = 0.0
            for idx in sorted(est):
                v = by_idx.get(idx)
                if v is None:
                    continue        # that replica has been retired
                score = min(est[idx], plen) * self._weight(v)
                if score > best_score:
                    best_score, choice = score, idx
            if choice is not None and not _worth_following(
                    by_idx[choice], views, self.min_headroom_frac,
                    self.spill_slack):
                choice = None
        if choice is None:
            choice = super().route(req, views)
        # the turn's full history will be cached where it lands
        group = self._placed.setdefault(pid, {})
        group[choice] = max(group.get(choice, 0),
                            req.prompt_len + req.gen_len)
        return choice


def make_router(name: str, seed: int = 0, n_pods: int = 2,
                topology: Optional[FleetTopology] = None) -> Router:
    """Build a routing policy.  ``seed`` pins every stochastic policy
    (today: ``p2c``); call sites must thread their run seed through so a
    fleet run is a pure function of its seeds.  ``topology`` shares one
    replica<->pod partition with the fleet/controller (``run_fleet``
    threads it); omitted, pod-aware policies build their own from
    ``n_pods`` (the static partition, identical for default fleets)."""
    if name == "round_robin":
        return RoundRobinRouter()
    if name == "least_outstanding":
        return LeastOutstandingRouter()
    if name == "p2c":
        return PowerOfTwoRouter(seed)
    if name == "gcr_aware":
        return GCRAwareRouter(n_pods, topology)
    if name == "affinity":
        return AffinityRouter(n_pods, topology=topology)
    if name == "prefix_aware":
        return PrefixAwareRouter(n_pods, topology=topology)
    raise ValueError(f"unknown router {name!r}")
