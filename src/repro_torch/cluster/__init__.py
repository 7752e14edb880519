"""L2: cluster fleet - multi-replica virtual-time serving (DESIGN.md).

The port's own copy of ``repro.cluster``, unchanged in behaviour: the
port imports nothing of ``repro``.

The paper restricts the set of threads circulating through a lock; L1
(``core.admission``) restricts the set of streams circulating through one
engine batch; this package restricts and steers the set of streams
circulating through a *fleet* of replicas: open-loop workloads
(``workload``), a stale/sampled replica metrics bus (``signals``),
pluggable routing with a capacity-aware GCR-occupancy policy
(``router``), SLO-driven autoscaling with KV-migration scale-in
(``controller``), a shared-clock event loop (``fleet``), and SLO
telemetry (``telemetry``), and an opt-in observability layer - request
spans, control-plane flight recorder, windowed time series, collapse
onset detection (``obs``).
"""

from .controller import (VICTIM_POLICIES, MigrationCost,
                         QueueDepthAutoscaler, ScaleDecision, SLOAutoscaler,
                         make_autoscaler, select_victim, victim_scores)
from .faults import (Blackout, Crash, FaultSchedule, HealthEstimator,
                     HealthPolicy, HedgePolicy, Limplock)
from .fleet import (Fleet, FleetConfig, est_capacity_rps, knee_cost,
                    run_fleet)
from .invariants import (PlacementGuard, assert_conserved,
                         assert_percentiles, conserved_count, guarded_case)
from .obs import (FlightRecorder, Observability, SpanTracer,
                  WindowedMetrics, chrome_trace, detect_collapse_onset,
                  span_conservation, validate_flight, validate_spans,
                  validate_windows)
from .router import (ROUTERS, AffinityRouter, GCRAwareRouter,
                     LeastOutstandingRouter, PowerOfTwoRouter,
                     PrefixAwareRouter, RoundRobinRouter, Router,
                     make_router)
from .signals import PodView, ReplicaReport, ReplicaView, SignalBus
from .telemetry import SLO, ClusterResult, ClusterTelemetry, percentile
from .topology import FleetTopology
from .workload import (WORKLOADS, WorkloadSpec, bursty, diurnal,
                       make_workload, pod_skewed_diurnal, poisson, replay,
                       sessions, to_trace, uniform)

__all__ = [
    "Fleet",
    "FleetConfig",
    "FleetTopology",
    "PodView",
    "QueueDepthAutoscaler",
    "SLOAutoscaler",
    "ScaleDecision",
    "MigrationCost",
    "VICTIM_POLICIES",
    "select_victim",
    "victim_scores",
    "make_autoscaler",
    "FaultSchedule",
    "Limplock",
    "Crash",
    "Blackout",
    "HedgePolicy",
    "HealthPolicy",
    "HealthEstimator",
    "Observability",
    "SpanTracer",
    "FlightRecorder",
    "WindowedMetrics",
    "detect_collapse_onset",
    "chrome_trace",
    "span_conservation",
    "validate_spans",
    "validate_flight",
    "validate_windows",
    "run_fleet",
    "knee_cost",
    "est_capacity_rps",
    "ROUTERS",
    "Router",
    "RoundRobinRouter",
    "LeastOutstandingRouter",
    "PowerOfTwoRouter",
    "GCRAwareRouter",
    "AffinityRouter",
    "PrefixAwareRouter",
    "make_router",
    "PlacementGuard",
    "assert_conserved",
    "assert_percentiles",
    "conserved_count",
    "guarded_case",
    "SignalBus",
    "ReplicaReport",
    "ReplicaView",
    "SLO",
    "ClusterResult",
    "ClusterTelemetry",
    "percentile",
    "WORKLOADS",
    "WorkloadSpec",
    "poisson",
    "bursty",
    "diurnal",
    "pod_skewed_diurnal",
    "sessions",
    "replay",
    "to_trace",
    "uniform",
    "make_workload",
]
