"""First-class fleet topology: the replica <-> pod partition (DESIGN.md 7).

The port's own copy of ``repro.cluster.topology``, unchanged in
behaviour: the port imports nothing of ``repro``.

GCR-NUMA's core observation is that *which* waiters you admit matters as
much as how many: keep the active set socket-pure so warm state stays
local.  At L2 the socket is a **pod** and the partition of replicas among
pods is control-plane state - yet before this module existed every
consumer recomputed it privately (`router.py` partitioned views by
``idx % n_pods``, `fleet.py` implied it through `FleetConfig`, the
controller ignored it entirely and made pool-scalar decisions).  One
shared ``FleetTopology`` now owns that partition:

* **routers** group live views per pod through ``pod_of``/``partition``
  instead of re-deriving the modulo rule;
* the **fleet** records each spawned replica's pod here, so a
  pod-*targeted* scale-out (``ScaleDecision.pod``) can land a replica in
  the saturated pod rather than wherever index parity happens to point;
* the **controller** rolls the signal bus up into per-pod views
  (``signals.PodView``) keyed by the same partition, so scale decisions
  can be pod-scoped;
* **telemetry** stamps each replica's pod on the per-replica rows and
  aggregates per-pod completions.

The default assignment is the legacy static rule ``idx % n_pods``, so a
fleet that never issues a pod-targeted spawn is bit-identical to the
pre-topology code: explicit assignments exist only where a controller
deliberately placed a replica.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = ["FleetTopology"]


class FleetTopology:
    """Replica <-> pod partition shared by router, fleet, and controller.

    ``pod_of(idx)`` is the single source of truth: the explicitly
    assigned pod if one was recorded, else the static ``idx % n_pods``
    rule every layer used before.  Instances are cheap and mutable; at
    run entry the fleet resets explicit assignments to the
    construction-time ``assignment`` baseline (``begin_run``), so a
    topology shared across sequential runs keeps its user-declared
    partition but cannot leak one run's *spawn* placements into the
    next.
    """

    __slots__ = ("n_pods", "_baseline", "_explicit")

    def __init__(self, n_pods: int = 1,
                 assignment: Optional[Dict[int, int]] = None) -> None:
        self.n_pods = max(1, int(n_pods))
        self._baseline: Dict[int, int] = {
            idx: pod % self.n_pods for idx, pod in (assignment or {}).items()}
        self._explicit: Dict[int, int] = dict(self._baseline)

    def __repr__(self) -> str:
        return (f"FleetTopology(n_pods={self.n_pods}, "
                f"explicit={self._explicit!r})")

    # -- the partition --------------------------------------------------------
    def pod_of(self, idx: int) -> int:
        """The pod replica ``idx`` serves (explicit assignment wins,
        else the legacy static ``idx % n_pods`` rule)."""
        pod = self._explicit.get(idx)
        if pod is not None:
            return pod
        return idx % self.n_pods

    def assign(self, idx: int, pod: Optional[int] = None) -> int:
        """Record replica ``idx``'s pod (fleet spawn path).  ``pod=None``
        keeps the default rule - nothing is recorded, so default-placed
        fleets stay bit-identical to the pre-topology code."""
        if pod is None:
            return self.pod_of(idx)
        pod %= self.n_pods
        self._explicit[idx] = pod
        return pod

    def partition(self, indices: Iterable[int]) -> List[List[int]]:
        """Group replica indices per pod: ``out[p]`` lists the members of
        pod ``p`` in the input order."""
        out: List[List[int]] = [[] for _ in range(self.n_pods)]
        for i in indices:
            out[self.pod_of(i)].append(i)
        return out

    # -- lifecycle ------------------------------------------------------------
    def begin_run(self) -> None:
        """Reset assignments to the construction-time baseline
        (Fleet.run entry): spawn placements belong to one run, so a
        reused topology starts each run exactly as it was declared."""
        self._explicit = dict(self._baseline)
