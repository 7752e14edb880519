"""Cluster-level SLO telemetry (DESIGN.md 7).

The port's own copy of ``repro.cluster.telemetry``, unchanged in
behaviour but for ``SLO``'s two defaults, which derive from the H100 step
cost (``PER_TOKEN_MS``, ``TTFT_MS``): the port imports nothing of
``repro``.

Collapse at fleet scale is invisible in mean throughput until it is
catastrophic; it shows up first in the latency tail and in *goodput* -
tokens delivered by requests that met their SLO.  This module aggregates:

* TTFT p50/p95/p99 and per-token decode latency p50/p95/p99;
* goodput-under-SLO (tok/s from SLO-met requests only) and attainment;
* per-replica active/parked occupancy (end-of-run and peak), the direct
  observable the GCR-aware router steers on;
* replica lifecycle (spawn/retire times) and the integrated
  **replica-ms** bill - the cost metric a scale-in policy must beat a
  scale-out-only policy on;
* prefix-cache economics: fleet-wide hit rate over queried prefix
  tokens, TTFT split **warm vs cold** (did the turn land where its
  prefix was cached?), and warm tokens destroyed by scale-in - the
  observables that separate an affinity router from ``gcr_aware``;
* per-pod rollups (``ClusterResult.per_pod``): each pod's replica
  count, arrivals, completions, SLO attainment, and goodput, keyed by
  the fleet's shared ``FleetTopology`` - the observable a pod-scoped
  scale decision is judged on (a pool-scalar controller can look
  healthy in aggregate while one pod burns).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..serving.engine import (T_FIXED_MS, T_TOK_MS, Request, SimServeEngine,
                              percentile)

__all__ = ["SLO", "ClusterResult", "ClusterTelemetry", "percentile"]

# the default per-token objective: twice the H100 step of a full active set
# at the launcher's default active limit of 384 streams, no thrash, so a
# stream kept in the batch meets it and one the fleet parks or thrashes
# does not: 2 x (T_FIXED_MS + T_TOK_MS x 384)
PER_TOKEN_MS = 2 * (T_FIXED_MS + T_TOK_MS * 384)

# the default time-to-first-token objective: the reference's 2,000 ms
# counted in the reference's decode steps of a full active set at the same
# 384 streams (3.0 + 0.02 x 384 = 10.68 ms, its StepCostModel defaults), so
# about 187 steps, times the H100 step there (38.22 + 0.2040 x 384 =
# 116.56 ms): 2000 x 116.56 / 10.68, about 21.8 s.  A first token waits for
# the streams ahead of it to free slots, and those streams take steps, not
# milliseconds, so the objective keeps its meaning in steps; the reference's
# 2,000 ms is 17 H100 steps, shorter than one request's life on the card
REF_TTFT_MS = 2000.0
REF_STEP_384_MS = 3.0 + 0.02 * 384
TTFT_MS = REF_TTFT_MS / REF_STEP_384_MS * (T_FIXED_MS + T_TOK_MS * 384)


@dataclass(frozen=True)
class SLO:
    """Per-request service objective."""

    # time to first token (TTFT_MS when built)
    ttft_ms: float = field(default_factory=lambda: TTFT_MS)
    # mean inter-token latency after the first (PER_TOKEN_MS when built)
    per_token_ms: float = field(default_factory=lambda: PER_TOKEN_MS)

    def met(self, r: Request) -> bool:
        if r.done_ms < 0 or r.first_token_ms < 0:
            return False
        if r.first_token_ms - r.arrive_ms > self.ttft_ms:
            return False
        decode_ms = r.done_ms - r.first_token_ms
        return decode_ms / max(1, r.gen_len - 1) <= self.per_token_ms


@dataclass
class ClusterResult:
    offered: int
    completed: int
    sim_ms: float
    token_throughput: float              # tokens/s, all completed work
    request_throughput: float            # requests/s
    goodput_tok_s: float                 # tokens/s from SLO-met requests
    slo_attainment: float                # SLO-met / offered
    ttft_p50_ms: float
    ttft_p95_ms: float
    ttft_p99_ms: float
    per_token_p50_ms: float
    per_token_p95_ms: float
    per_token_p99_ms: float
    per_replica: List[Dict[str, float]] = field(default_factory=list)
    per_pod: List[Dict[str, float]] = field(default_factory=list)
    stats: Dict[str, float] = field(default_factory=dict)
    # time-resolved fleet metrics from obs.WindowedMetrics (one dict per
    # closed virtual-time window, keys per obs.WINDOW_FIELDS); empty
    # unless the run was driven with a windowed Observability bundle
    windows: List[Dict[str, Any]] = field(default_factory=list)

    def to_json(self, indent: Optional[int] = None) -> str:
        """Machine-readable result: the full dataclass (aggregates,
        per-replica/per-pod rollups, stats, window series) as JSON with
        keys matching the windowed-metrics schema."""
        return json.dumps(asdict(self), indent=indent, sort_keys=True)

    def summary(self) -> str:
        return (f"offered={self.offered} done={self.completed} "
                f"tok/s={self.token_throughput:,.0f} "
                f"goodput={self.goodput_tok_s:,.0f} "
                f"slo={self.slo_attainment:.0%} "
                f"ttft_p99={self.ttft_p99_ms:,.0f}ms "
                f"tpt_p99={self.per_token_p99_ms:.1f}ms "
                f"replicas={len(self.per_replica)} "
                f"replica_s={self.stats.get('replica_ms', 0.0) / 1e3:,.1f}")


class ClusterTelemetry:
    """Accumulates fleet observations; ``finalize`` renders a ClusterResult.

    Peak occupancy is tracked by the engines themselves
    (``SimServeEngine.peak_active``/``peak_parked``, updated O(1) at the
    submit outcome and step end - the points the fleet used to sample), so
    the event loop pays nothing per event for it."""

    def __init__(self, slo: Optional[SLO] = None) -> None:
        self.slo = slo if slo is not None else SLO()
        self.scale_events: List[float] = []
        self.scale_in_events: List[float] = []
        self.spawn_ms: Dict[int, float] = {}
        self.retire_ms: Dict[int, float] = {}
        self.migrated = 0
        self.prefix_tokens_lost = 0
        # fault plane (DESIGN.md 11); all zero on a clean run, and the
        # fault stats/rows only render when something here moved, so a
        # run without a schedule emits byte-identical results
        self.fault_events = 0
        self.crashes = 0
        self.restarts = 0
        self.requeued = 0
        self.lost = 0
        self.ejections = 0
        self.restorations = 0
        self.crash_count: Dict[int, int] = {}
        self.downtime_ms: Dict[int, float] = {}
        self._down_since: Dict[int, float] = {}

    def on_scale(self, now_ms: float) -> None:
        self.scale_events.append(now_ms)

    def on_fault(self, op: str, idx: int, now_ms: float) -> None:
        """A non-crash fault edge was applied (limp/blackout/restart)."""
        self.fault_events += 1

    def on_crash(self, idx: int, now_ms: float, requeued: int = 0,
                 lost: int = 0, prefix_tokens_lost: int = 0) -> None:
        self.fault_events += 1
        self.crashes += 1
        self.crash_count[idx] = self.crash_count.get(idx, 0) + 1
        self.requeued += requeued
        self.lost += lost
        self.prefix_tokens_lost += prefix_tokens_lost
        self._down_since[idx] = now_ms

    def on_restart(self, idx: int, now_ms: float) -> None:
        self.restarts += 1
        since = self._down_since.pop(idx, None)
        if since is not None:
            self.downtime_ms[idx] = (self.downtime_ms.get(idx, 0.0)
                                     + max(0.0, now_ms - since))

    def on_eject(self, n_ejected: int, n_restored: int,
                 now_ms: float) -> None:
        self.ejections += n_ejected
        self.restorations += n_restored

    def on_spawn(self, idx: int, now_ms: float) -> None:
        self.spawn_ms[idx] = now_ms

    def on_retire(self, idx: int, now_ms: float, migrated: int = 0,
                  prefix_tokens_lost: int = 0) -> None:
        self.retire_ms[idx] = now_ms
        self.scale_in_events.append(now_ms)
        self.migrated += migrated
        self.prefix_tokens_lost += prefix_tokens_lost

    def finalize(self, now_ms: float, replicas: List[SimServeEngine],
                 offered: int, migrating: int = 0,
                 events: int = 0, topology=None,
                 pod_arrivals: Optional[Dict[int, int]] = None,
                 windows: Optional[List[Dict[str, float]]] = None,
                 hedges_issued: int = 0,
                 cancelled_hedges: int = 0) -> ClusterResult:
        completed: List[Request] = []
        for eng in replicas:
            completed.extend(eng.completed)
        tokens = sum(eng.tokens_out for eng in replicas)

        # One pass over completions, ONE sort per latency series; the
        # warm/cold prefix split is a boolean mask carried through the
        # TTFT argsort (a masked take of a sorted array is sorted), so no
        # series is ever sorted twice and all percentiles - full, warm,
        # cold - derive from the same sorted array via the shared
        # nearest-rank rule.
        fin = [r for r in completed if r.first_token_ms >= 0]
        ttft_l = [r.first_token_ms - r.arrive_ms for r in fin]
        per_tok_l = [(r.done_ms - r.first_token_ms)
                     / max(1, r.gen_len - 1) for r in fin]
        had_l = [r.prefix_len > 0 for r in fin]
        warm_l = [r.prefix_hit_tokens > 0 for r in fin]
        gen_l = [r.gen_len for r in fin]
        pod_l = [r.pod for r in fin]
        ttft_arr = np.asarray(ttft_l, dtype=np.float64)
        per_tok_arr = np.asarray(per_tok_l, dtype=np.float64)
        order = np.argsort(ttft_arr, kind="stable")
        ttft = ttft_arr[order]
        had = np.asarray(had_l, dtype=bool)[order]
        was_warm = np.asarray(warm_l, dtype=bool)[order]
        warm = ttft[had & was_warm]
        cold = ttft[had & ~was_warm]
        per_tok = np.sort(per_tok_arr)
        # SLO accounting on the same arrays (identical comparisons to
        # SLO.met, vectorized; completed requests always have done_ms>=0)
        met_mask = ((ttft_arr <= self.slo.ttft_ms)
                    & (per_tok_arr <= self.slo.per_token_ms))
        n_met = int(np.count_nonzero(met_mask))
        met_gen = int(np.asarray(gen_l, dtype=np.int64)[met_mask].sum()) \
            if gen_l else 0
        dur_s = max(now_ms, 1e-9) / 1e3

        cache_hits = sum(eng.prefix_cache.hit_tokens for eng in replicas
                         if eng.prefix_cache is not None)
        cache_asks = sum(eng.prefix_cache.query_tokens for eng in replicas
                         if eng.prefix_cache is not None)

        # per-pod rollups: request-pod view of completions/attainment
        # (goodput is judged where the traffic lives) plus the replica
        # count the topology files under the pod (capacity view)
        per_pod: List[Dict[str, float]] = []
        if topology is not None:
            pod_arr_in = pod_arrivals or {}
            # bucket by the pod the router served (requests reduce
            # modulo the partition), matching the fleet's arrival rows
            pod_np = np.asarray(pod_l, dtype=np.int64) % topology.n_pods
            for p in range(topology.n_pods):
                sel = pod_np == p
                done_p = int(np.count_nonzero(sel))
                met_p = int(np.count_nonzero(met_mask & sel))
                met_gen_p = int(np.asarray(gen_l, dtype=np.int64)
                                [met_mask & sel].sum()) if gen_l else 0
                # capacity view: replicas currently filed under the pod
                # and not retired (cumulative history lives in PodView)
                n_replicas_p = sum(1 for i in range(len(replicas))
                                   if topology.pod_of(i) == p
                                   and i not in self.retire_ms)
                arr_p = pod_arr_in.get(p, 0)
                per_pod.append({
                    "pod": p,
                    "replicas": n_replicas_p,
                    "arrivals": arr_p,
                    "completed": done_p,
                    "slo_met": met_p,
                    "attainment": met_p / max(1, arr_p),
                    "goodput_tok_s": met_gen_p / dur_s,
                })

        # fault plane: close out downtime for replicas still dead at the
        # end, and decide once whether this run exercised faults at all
        # (clean runs must render byte-identical rows and stats)
        for i, since in self._down_since.items():
            self.downtime_ms[i] = (self.downtime_ms.get(i, 0.0)
                                   + max(0.0, now_ms - since))
        self._down_since.clear()
        faulted = bool(self.fault_events or self.ejections
                       or self.restorations or hedges_issued
                       or cancelled_hedges)

        per_replica = []
        replica_ms = 0.0
        for i, eng in enumerate(replicas):
            spawn = self.spawn_ms.get(i, 0.0)
            retire = self.retire_ms.get(i, -1.0)
            # spawn/retire land on bookkeeping ticks that may sit past the
            # last measured event, so clamp each lifetime term at >= 0
            life = max(0.0, (retire if retire >= 0.0 else now_ms) - spawn)
            # a crashed span bills no replica-ms: the process is gone
            life = max(0.0, life - self.downtime_ms.get(i, 0.0))
            replica_ms += life
            pc = eng.prefix_cache
            per_replica.append({
                "pod": topology.pod_of(i) if topology is not None else 0,
                "tokens": eng.tokens_out,
                "completed": len(eng.completed),
                "active_end": len(eng.active),
                "parked_end": eng.admission.num_parked,
                "peak_active": eng.peak_active,
                "peak_parked": eng.peak_parked,
                "promotions": getattr(eng.admission, "stat_promotions", 0),
                "demotions": getattr(eng.admission, "stat_demotions", 0),
                "spawn_ms": spawn,
                "retire_ms": retire,
                "life_ms": life,
                "cache_tokens": pc.tokens if pc else 0,
                "cache_hit_rate": (pc.hit_tokens / pc.query_tokens
                                   if pc and pc.query_tokens else 0.0),
            })
            if faulted:
                per_replica[-1]["crashes"] = self.crash_count.get(i, 0)
                per_replica[-1]["downtime_ms"] = \
                    self.downtime_ms.get(i, 0.0)

        res = ClusterResult(
            offered=offered,
            completed=len(completed),
            sim_ms=now_ms,
            token_throughput=tokens / dur_s,
            request_throughput=len(completed) / dur_s,
            goodput_tok_s=met_gen / dur_s,
            slo_attainment=n_met / max(1, offered),
            ttft_p50_ms=percentile(ttft, 0.50),
            ttft_p95_ms=percentile(ttft, 0.95),
            ttft_p99_ms=percentile(ttft, 0.99),
            per_token_p50_ms=percentile(per_tok, 0.50),
            per_token_p95_ms=percentile(per_tok, 0.95),
            per_token_p99_ms=percentile(per_tok, 0.99),
            per_replica=per_replica,
            per_pod=per_pod,
            windows=windows or [],
            stats={"scale_events": len(self.scale_events),
                   "scale_in_events": len(self.scale_in_events),
                   "migrated": self.migrated,
                   "migrating_end": migrating,
                   "sim_events": float(events),
                   "replica_ms": replica_ms,
                   "prefix_hit_rate": (cache_hits / cache_asks
                                       if cache_asks else 0.0),
                   "prefix_tokens_lost": float(self.prefix_tokens_lost),
                   "warm_completed": float(len(warm)),
                   "cold_completed": float(len(cold)),
                   "ttft_warm_p50_ms": percentile(warm, 0.50),
                   "ttft_warm_p99_ms": percentile(warm, 0.99),
                   "ttft_cold_p50_ms": percentile(cold, 0.50),
                   "ttft_cold_p99_ms": percentile(cold, 0.99)},
        )
        if faulted:
            res.stats.update({
                "fault_events": float(self.fault_events),
                "crashes": float(self.crashes),
                "restarts": float(self.restarts),
                "requeued": float(self.requeued),
                "lost": float(self.lost),
                "ejections": float(self.ejections),
                "restorations": float(self.restorations),
                "hedges_issued": float(hedges_issued),
                "cancelled_hedges": float(cancelled_hedges),
                "downtime_ms": float(sum(self.downtime_ms.values())),
            })
        return res
