"""Executable L2 invariants (DESIGN.md 8).

The port's own copy of ``repro.cluster.invariants``, unchanged in
behaviour: the port imports nothing of ``repro``.

The cluster layer's correctness claims are stated once, here, as
checkable predicates, and consumed three ways: the benches assert them on
every measured run, `tests/test_cluster.py` pins them on a deterministic
seed grid, and `tests/test_properties.py` fuzzes them with hypothesis
over random seeds, workloads, router policies, and scale-event schedules.

* **conservation** - ``completed + live + migrating == offered`` at every
  truncation point: the fleet neither loses nor forges requests, no
  matter where the clock is cut;
* **placement liveness** - a router's decision always lands on a replica
  in the live view list; a sticky/affinity policy holding a stale home
  pointer must fall through, never route to a retired replica;
* **percentile monotonicity** - nearest-rank percentiles are monotone in
  q, so every reported p50 <= p95 <= p99.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .router import Router
from .signals import ReplicaView
from .telemetry import ClusterResult

__all__ = ["conserved_count", "assert_conserved", "assert_percentiles",
           "PlacementGuard", "guarded_case"]


def conserved_count(res: ClusterResult) -> int:
    """Copy-space conservation: every *copy* of a stream is accounted.

    ``completed + live + in-migration + lost + cancelled_hedges
    - hedges_issued == offered``.  A crash with ``policy="lose"`` moves
    copies to ``lost``; each hedge mints one extra copy
    (``hedges_issued``) which must end up completed, live, migrating,
    lost, or ``cancelled``.  On a fault-free run every fault-plane term
    is absent from ``stats`` and the law reduces to the legacy
    ``completed + live + migrating == offered``."""
    live = sum(r["active_end"] + r["parked_end"] for r in res.per_replica)
    s = res.stats
    return (res.completed + live + int(s.get("migrating_end", 0))
            + int(s.get("lost", 0)) + int(s.get("cancelled_hedges", 0))
            - int(s.get("hedges_issued", 0)))


def assert_conserved(res: ClusterResult, tag: str = "") -> None:
    got = conserved_count(res)
    assert got == res.offered, \
        f"{tag}: conservation broken: {got} != offered {res.offered}"


def assert_percentiles(res: ClusterResult, tag: str = "") -> None:
    """Reported percentiles are monotone in q (nearest-rank property)."""
    assert res.ttft_p50_ms <= res.ttft_p95_ms <= res.ttft_p99_ms, tag
    assert res.per_token_p50_ms <= res.per_token_p95_ms \
        <= res.per_token_p99_ms, tag
    for lo, hi in (("ttft_warm_p50_ms", "ttft_warm_p99_ms"),
                   ("ttft_cold_p50_ms", "ttft_cold_p99_ms")):
        assert res.stats[lo] <= res.stats[hi], tag


class PlacementGuard(Router):
    """Wrap any router and assert every decision targets a live replica.

    The fleet hands policies views of non-retired replicas only; the
    invariant is that the *returned index* is one of those views - a
    policy with LB-side memory (``affinity``'s home map, ``p2c``'s
    sampling, a stale sticky pointer) must never return a replica that
    has left the routable set.  Placements are recorded as
    ``(rid, replica_idx)`` for post-run inspection.
    """

    def __init__(self, inner: Router) -> None:
        self.inner = inner
        self.name = f"guard({inner.name})"
        # forward the shared partition so the fleet adopts the inner
        # policy's topology through the guard
        self.topology = getattr(inner, "topology", None)
        self.placements: List[Tuple[int, int]] = []

    def reset(self) -> None:
        self.inner.reset()
        self.placements = []

    def route(self, req, views: Sequence[ReplicaView]) -> int:
        idx = self.inner.route(req, views)
        live = {v.idx for v in views}
        assert idx in live, \
            (f"{self.inner.name} placed rid={req.rid} on replica {idx}, "
             f"not in live set {sorted(live)}")
        self.placements.append((req.rid, idx))
        return idx


def guarded_case(seed: int, kind: str, router_name: str,
                 schedule: Sequence[Tuple[str, int]] = (),
                 max_ms: float = 60_000.0, rps_mult: float = 2.0,
                 duration_ms: float = 900.0, staleness_ms: float = 0.0,
                 n_replicas: int = 3,
                 prefix_cache_tokens: int = 50_000,
                 faults=None, health=None, hedge=None) -> ClusterResult:
    """Run one seeded fleet scenario under ``PlacementGuard`` and assert
    every L2 invariant on the result.

    This is the single case driver behind both invariant suites: the
    deterministic grid in ``tests/test_cluster.py`` and the hypothesis
    fuzz in ``tests/test_properties.py`` (random seeds, workload kinds,
    router policies, scale-event schedules, truncation points).

    ``schedule`` scripts the autoscaler: entry ``i`` fires on the i-th
    scale tick - ``("out", _)`` spawns a replica, ``("in", k)`` retires
    the ``k % len(live)``-th live replica (the fleet itself refuses to
    drain the last one), ``("out_pod", p)`` spawns a replica *assigned to
    pod* ``p % n_pods`` (the topology-scoped placement path),
    ``("in_pod", p)`` retires the first live replica the shared topology
    files under pod ``p % n_pods`` (falling back to any live replica if
    the pod is empty), anything else is a no-op tick.

    ``faults``/``health``/``hedge`` thread a ``cluster.faults`` fault
    schedule, ejection policy, and hedging policy through the run, so
    both suites can assert copy-space conservation under limplock,
    crash/restart, blackout, and mid-migration-crash interleavings
    (``health`` needs ``staleness_ms`` > 0).
    """
    # local imports: this module is imported by router/telemetry consumers
    # that must not pay for (or cycle into) the fleet machinery
    from ..serving.engine import StepCostModel
    from .controller import ScaleDecision
    from .fleet import Fleet, FleetConfig, est_capacity_rps, knee_cost
    from .router import make_router
    from .signals import SignalBus
    from .telemetry import SLO, ClusterTelemetry
    from .topology import FleetTopology
    from .workload import WorkloadSpec, make_workload

    spec = WorkloadSpec(prompt_range=(128, 512), gen_range=(32, 128),
                        n_pods=2)
    limit = 32
    cost: StepCostModel = knee_cost(spec, limit, oversub=2.0)
    cap = est_capacity_rps(spec, limit, n_replicas, cost)
    reqs = make_workload(kind, rps_mult * cap, duration_ms, spec, seed)
    cfg = FleetConfig(n_replicas=n_replicas, admission="gcr",
                      active_limit=limit, n_pods=2, cost=cost,
                      prefix_cache_tokens=prefix_cache_tokens)

    steps = list(schedule)

    def scaler(fleet, now_ms):
        tick = scaler.tick
        scaler.tick += 1
        if tick >= len(steps):
            return None
        action, k = steps[tick]
        if action == "out":
            return ScaleDecision(add=cfg.make_engine(), reason="scripted")
        if action == "out_pod":
            return ScaleDecision(add=cfg.make_engine(), pod=k % 2,
                                 reason="scripted pod spawn")
        if action == "in":
            live = fleet.live_indices()
            return ScaleDecision(remove=live[k % len(live)],
                                 reason="scripted")
        if action == "in_pod":
            pod_of = fleet.topology.pod_of
            live = fleet.live_indices()
            in_pod = [i for i in live if pod_of(i) == k % 2] or live
            return ScaleDecision(remove=in_pod[0], pod=k % 2,
                                 victim="scripted",
                                 reason="scripted pod retire")
        return None

    scaler.tick = 0
    topo = FleetTopology(2)
    guard = PlacementGuard(make_router(router_name, seed=seed, n_pods=2,
                                       topology=topo))
    fleet = Fleet(cfg.make_engines(), guard,
                  ClusterTelemetry(SLO()), autoscaler=scaler,
                  autoscale_every_ms=100.0,
                  bus=SignalBus(slo=SLO(), period_ms=staleness_ms,
                                jitter_ms=(10.0 if staleness_ms else 0.0),
                                seed=seed),
                  topology=topo, faults=faults, health=health,
                  hedge=hedge)
    res = fleet.run(reqs, max_ms=max_ms)
    tag = f"{kind}/{router_name}/seed={seed}/sched={steps}/max={max_ms}"
    assert_conserved(res, tag)
    assert_percentiles(res, tag)
    # placements cover injected work only; every placed rid was offered
    offered = {r.rid for r in reqs}
    assert all(rid in offered for rid, _ in guard.placements), tag
    return res
