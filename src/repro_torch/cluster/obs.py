"""Flight recorder for the collapse (DESIGN.md 9).

The port's own copy of ``repro.cluster.obs``, unchanged in behaviour:
the port imports nothing of ``repro``.

Scalability collapse is a *time-domain* phenomenon: the paper's thesis is
that throughput fades or drops abruptly as threads pile onto a saturated
lock, and GCR's own evaluation watches admission/passivation dynamics
unfold over time.  End-of-run aggregates (``ClusterResult``) cannot
localize that onset, so this module adds three observers that can:

* ``SpanTracer``      - per-request lifecycle spans: arrival -> route
  decision (with the candidate occupancy gauges and signal staleness the
  router actually saw, plus the scoring router's own candidate keys) ->
  GCR admit/park/unpark/demote -> first token -> complete/migrate.
  Exportable as structured JSONL and as Chrome-trace-event JSON that
  Perfetto / ``chrome://tracing`` loads directly;
* ``FlightRecorder``  - the control-plane log: every autoscaler tick's
  ``ScaleDecision`` (action, pod, reason), the victim-selection rationale
  (per-candidate sort keys from ``controller.victim_scores``), every bus
  publish, and the last-published ``ReplicaReport`` store - stamped with
  per-report staleness - that the tick read.  A scaling misfire can be
  root-caused post-hoc from this log alone;
* ``WindowedMetrics`` - counters/gauges rolled up per fixed virtual-time
  window: time series of goodput, SLO attainment, queue depth (parked),
  active-set size, and cache hit rate per replica/pod/fleet.  The
  ``detect_collapse_onset`` scanner flags the first *loaded* window whose
  goodput drops >= ``drop_frac`` below the running peak while offered
  load holds (low-load ramp/drain windows are excluded, so queue-building
  overload with intact service rate is NOT flagged - only a true
  service-rate collapse is).

**Zero-overhead contract.**  All hooks are guarded by ``obs is not None``
(fleet loop) / ``self.obs is not None`` (engine), and every recording
read is pure: no observer may mutate engine state, RNG streams, float
evaluation order, or event order.  With observability disabled the six
golden traces stay bit-identical and ``perf_guard`` stays within factor;
with it *enabled* the traces must STILL be bit-identical - observation
never perturbs the simulation (``tests/test_obs.py`` pins both).

**Window semantics.**  Counters bucket by event time: arrivals by arrive
time, completions by ``done_ms`` (step effects are banked at step start
and stamped with the step's end, which is strictly ahead of the loop
clock, so a completion can never land in an already-closed window).
Gauges are sampled at window close - the first processed event at or
past the boundary - which is exact for event-free gap windows because
fleet state only changes at events.  Token counts attribute a request's
full ``generated`` at its completion window.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SPAN_SCHEMA", "FLIGHT_SCHEMA", "WINDOW_SCHEMA", "SPAN_EVENTS",
           "FLIGHT_KINDS", "SpanTracer", "FlightRecorder", "WindowedMetrics",
           "Observability", "detect_collapse_onset", "chrome_trace",
           "span_conservation", "validate_spans", "validate_flight",
           "validate_windows", "write_jsonl", "read_jsonl"]

# the reference's schema names: both packages' exports read alike
SPAN_SCHEMA = "repro.obs.span.v1"
FLIGHT_SCHEMA = "repro.obs.flight.v1"
WINDOW_SCHEMA = "repro.obs.window.v1"

SPAN_EVENTS = ("arrive", "migrate_in", "route", "admit", "park", "unpark",
               "demote", "first_token", "complete", "migrate_out",
               "hedge", "cancel")
FLIGHT_KINDS = ("publish", "scale_tick", "spawn", "retire", "fault")

SCALE_ACTIONS = ("none", "add", "remove")

# fleet-scope window row keys, in CSV column order (the machine-readable
# contract shared with ClusterResult.to_json / cluster_bench --json)
WINDOW_FIELDS = ("window", "t_start_ms", "t_end_ms", "arrivals", "completed",
                 "slo_met", "tokens", "good_tokens", "migrated",
                 "throughput_tok_s", "goodput_tok_s", "slo_attainment",
                 "replicas", "active", "parked", "cache_tokens",
                 "cache_hit_rate")


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

class SpanTracer:
    """In-memory per-request lifecycle event log.

    ``emit`` appends one flat dict per event; the stream is exported as
    JSONL (``records``) or folded into Chrome trace events
    (``chrome_trace``).  Scoring routers deposit their per-candidate keys
    via ``note_scores`` inside ``route()``; the fleet's post-route hook
    collects them with ``take_scores`` and attaches them to the ``route``
    span event, so the recorded scores are exactly the ones the placement
    scan computed (not a recomputation that could drift).
    """

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self._scores: Optional[List[Dict[str, Any]]] = None
        self._scorer: str = ""

    def emit(self, event: str, t_ms: float, rid: int, **fields) -> None:
        rec: Dict[str, Any] = {"kind": "span", "event": event,
                               "t_ms": t_ms, "rid": rid}
        rec.update(fields)
        self.events.append(rec)

    # -- router score hand-off ----------------------------------------------
    def note_scores(self, router: str,
                    scores: List[Dict[str, Any]]) -> None:
        self._scorer = router
        self._scores = scores

    def take_scores(self) -> Tuple[str, Optional[List[Dict[str, Any]]]]:
        out = (self._scorer, self._scores)
        self._scorer, self._scores = "", None
        return out

    def records(self) -> List[Dict[str, Any]]:
        """Header + events, ready for ``write_jsonl``."""
        return [{"kind": "header", "schema": SPAN_SCHEMA,
                 "n_events": len(self.events)}] + self.events


class _EngineObs:
    """Engine-side tracer adapter, bound to one replica index.

    ``SimServeEngine`` calls these at the three lifecycle points only it
    can see (first-token stamping, passive-queue promotion, demotion);
    each call site is guarded by ``self.obs is not None`` so a disabled
    engine pays one attribute test per hook point and nothing else.
    """

    __slots__ = ("tracer", "idx")

    def __init__(self, tracer: SpanTracer, idx: int) -> None:
        self.tracer = tracer
        self.idx = idx

    def on_first_tokens(self, pending: Dict[int, Any], t_ms: float) -> None:
        emit = self.tracer.emit
        idx = self.idx
        for rid in pending:
            emit("first_token", t_ms, rid, replica=idx)

    def on_unpark(self, rid: int, t_ms: float) -> None:
        self.tracer.emit("unpark", t_ms, rid, replica=self.idx)

    def on_demote(self, rid: int, t_ms: float) -> None:
        self.tracer.emit("demote", t_ms, rid, replica=self.idx)


# ---------------------------------------------------------------------------
# control-plane flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Control-plane decision log.

    One entry per autoscaler tick (``scale_tick``, action ``none``/
    ``add``/``remove`` with the decision's pod/victim/reason and the
    last-published report store the tick read, staleness-stamped), plus
    ``publish``/``spawn``/``retire`` lifecycle entries.  Entries are
    read-only observations of bus state - the recorder never publishes or
    snapshots, so recording cannot refresh a stale signal.
    """

    def __init__(self) -> None:
        self.entries: List[Dict[str, Any]] = []

    def on_publish(self, t_ms: float, idx: int, report) -> None:
        self.entries.append({"kind": "publish", "t_ms": t_ms,
                             "replica": idx,
                             "report": dataclasses.asdict(report)})

    def on_scale_tick(self, t_ms: float, decision,
                      snapshot: List[Dict[str, Any]],
                      rationale: Optional[List[Dict[str, Any]]] = None
                      ) -> None:
        if decision is None:
            action, pod, victim, reason, remove = "none", None, "", "", None
        elif decision.add is not None:
            action, pod = "add", decision.pod
            victim, reason, remove = "", decision.reason, None
        elif decision.remove is not None:
            action, pod = "remove", decision.pod
            victim, reason = decision.victim, decision.reason
            remove = decision.remove
        else:
            action, pod = "none", decision.pod
            victim, reason, remove = decision.victim, decision.reason, None
        rec: Dict[str, Any] = {"kind": "scale_tick", "t_ms": t_ms,
                               "action": action, "pod": pod,
                               "victim": victim, "reason": reason,
                               "remove": remove, "snapshot": snapshot}
        if rationale is not None:
            rec["victim_rationale"] = rationale
        self.entries.append(rec)

    def on_spawn(self, t_ms: float, idx: int,
                 pod: Optional[int]) -> None:
        self.entries.append({"kind": "spawn", "t_ms": t_ms,
                             "replica": idx, "pod": pod})

    def on_retire(self, t_ms: float, idx: int, migrated: int,
                  drain_end_ms: float) -> None:
        self.entries.append({"kind": "retire", "t_ms": t_ms,
                             "replica": idx, "migrated": migrated,
                             "drain_end_ms": drain_end_ms})

    def on_fault(self, t_ms: float, idx: int, op: str,
                 **detail) -> None:
        """A fault-plane edge (limp/blackout/crash/restart/eject/
        restore) was applied to replica ``idx``."""
        rec: Dict[str, Any] = {"kind": "fault", "t_ms": t_ms,
                               "replica": idx, "op": op}
        rec.update(detail)
        self.entries.append(rec)

    def decisions(self) -> List[Dict[str, Any]]:
        """The non-no-op scale decisions, in tick order."""
        return [r for r in self.entries
                if r["kind"] == "scale_tick" and r["action"] != "none"]

    def records(self) -> List[Dict[str, Any]]:
        return [{"kind": "header", "schema": FLIGHT_SCHEMA,
                 "n_entries": len(self.entries)}] + self.entries


# ---------------------------------------------------------------------------
# windowed metrics registry
# ---------------------------------------------------------------------------

def _bump(bucket: Dict[str, int], field: str, amt: int = 1) -> None:
    bucket[field] = bucket.get(field, 0) + amt


class WindowedMetrics:
    """Counters/gauges per fixed virtual-time window, three scopes.

    Counters (arrivals, routed, completed, SLO-met, tokens, migrated)
    bucket by event time; gauges (active, parked, cache occupancy) are
    sampled at window close.  ``fleet_rows`` / ``replica_rows`` /
    ``pod_rows`` hold the closed windows in time order; the fleet rows
    are the schema ``cluster_bench --json`` and the windows CSV share.

    Open-window accumulation is preallocated int64 numpy planes
    (window x counter, window x replica x counter, window x pod x
    counter), doubled on demand past ``prealloc_windows``; rows are
    materialized as plain-int dicts at close, so the public schema -
    and its JSON/CSV digests - is unchanged from the dict-of-dicts
    representation this replaces.
    """

    # column layouts: fleet = (arrivals, completed, slo_met, tokens,
    # good_tokens, migrated); replica = (routed, completed, tokens,
    # faults); pod = (arrivals, completed, slo_met, good_tokens)

    def __init__(self, window_ms: float, slo=None,
                 prealloc_windows: int = 256) -> None:
        if window_ms <= 0.0:
            raise ValueError("window_ms must be > 0")
        if prealloc_windows < 1:
            raise ValueError("prealloc_windows must be >= 1")
        self.window_ms = float(window_ms)
        self.slo = slo
        self.prealloc_windows = int(prealloc_windows)
        self.fleet_rows: List[Dict[str, Any]] = []
        self.replica_rows: List[Dict[str, Any]] = []
        self.pod_rows: List[Dict[str, Any]] = []
        self._open = 0                       # lowest un-closed window index
        w = self.prealloc_windows
        self._fa = np.zeros((w, 6), dtype=np.int64)
        self._ra = np.zeros((w, 8, 4), dtype=np.int64)
        self._pa = np.zeros((w, 4, 4), dtype=np.int64)
        self.totals: Dict[str, int] = {
            "arrivals": 0, "completed": 0, "slo_met": 0, "tokens": 0,
            "good_tokens": 0, "migrated": 0}

    # -- counter events ------------------------------------------------------
    def _win(self, t_ms: float) -> int:
        return int(t_ms // self.window_ms)

    def _grow(self, k: int, rep: int = -1, pod: int = -1) -> None:
        """Double whichever plane dimension ``k``/``rep``/``pod`` outgrew."""
        nw = self._fa.shape[0]
        while k >= nw:
            nw *= 2
        nr = self._ra.shape[1]
        while rep >= nr:
            nr *= 2
        np_ = self._pa.shape[1]
        while pod >= np_:
            np_ *= 2
        if nw != self._fa.shape[0]:
            fa = np.zeros((nw, 6), dtype=np.int64)
            fa[:self._fa.shape[0]] = self._fa
            self._fa = fa
        if (nw, nr) != self._ra.shape[:2]:
            ra = np.zeros((nw, nr, 4), dtype=np.int64)
            ra[:self._ra.shape[0], :self._ra.shape[1]] = self._ra
            self._ra = ra
        if (nw, np_) != self._pa.shape[:2]:
            pa = np.zeros((nw, np_, 4), dtype=np.int64)
            pa[:self._pa.shape[0], :self._pa.shape[1]] = self._pa
            self._pa = pa

    def on_arrival(self, t_ms: float, pod: int) -> None:
        k = self._win(t_ms)
        if k >= self._fa.shape[0] or pod >= self._pa.shape[1]:
            self._grow(k, pod=pod)
        self._fa[k, 0] += 1
        self._pa[k, pod, 0] += 1
        self.totals["arrivals"] += 1

    def on_routed(self, t_ms: float, replica: int) -> None:
        k = self._win(t_ms)
        if k >= self._ra.shape[0] or replica >= self._ra.shape[1]:
            self._grow(k, rep=replica)
        self._ra[k, replica, 0] += 1

    def on_migrate(self, t_ms: float) -> None:
        k = self._win(t_ms)
        if k >= self._fa.shape[0]:
            self._grow(k)
        self._fa[k, 5] += 1
        self.totals["migrated"] += 1

    def on_fault(self, t_ms: float, replica: int) -> None:
        k = self._win(t_ms)
        if k >= self._ra.shape[0] or replica >= self._ra.shape[1]:
            self._grow(k, rep=replica)
        self._ra[k, replica, 3] += 1

    def on_completion(self, r, replica: int, pod: int) -> None:
        k = self._win(r.done_ms)
        met = self.slo.met(r) if self.slo is not None else False
        gen = r.generated
        if (k >= self._fa.shape[0] or replica >= self._ra.shape[1]
                or pod >= self._pa.shape[1]):
            self._grow(k, rep=replica, pod=pod)
        f = self._fa[k]
        f[1] += 1
        f[3] += gen
        rep = self._ra[k, replica]
        rep[1] += 1
        rep[2] += gen
        p = self._pa[k, pod]
        p[1] += 1
        self.totals["completed"] += 1
        self.totals["tokens"] += gen
        if met:
            f[2] += 1
            f[4] += gen
            p[2] += 1
            p[3] += gen
            self.totals["slo_met"] += 1
            self.totals["good_tokens"] += gen

    # -- window close --------------------------------------------------------
    def close_through(self, k_last: int,
                      gauges: List[Dict[str, Any]]) -> None:
        """Materialize rows for windows ``[self._open, k_last]``.

        ``gauges`` is one per-live-replica sample taken at the close
        point; fleet state is constant between events, so the same
        sample is exact for every event-free window in the range."""
        w = self.window_ms
        dur_s = w / 1e3
        active = sum(g["active"] for g in gauges)
        parked = sum(g["parked"] for g in gauges)
        ctok = sum(g["cache_tokens"] for g in gauges)
        chit = sum(g["cache_hit_tokens"] for g in gauges)
        cask = sum(g["cache_query_tokens"] for g in gauges)
        by_pod: Dict[int, List[Dict[str, Any]]] = {}
        for g in gauges:
            by_pod.setdefault(g["pod"], []).append(g)
        if k_last >= self._fa.shape[0]:
            self._grow(k_last)
        n_rep = self._ra.shape[1]
        for k in range(self._open, k_last + 1):
            # every value leaves the int64 planes as a Python int: the
            # row schema (json.dumps / repr digests) predates numpy here
            f = self._fa[k]
            completed = int(f[1])
            tokens = int(f[3])
            good = int(f[4])
            met = int(f[2])
            self.fleet_rows.append({
                "window": k, "t_start_ms": k * w, "t_end_ms": (k + 1) * w,
                "arrivals": int(f[0]),
                "completed": completed, "slo_met": met,
                "tokens": tokens, "good_tokens": good,
                "migrated": int(f[5]),
                "throughput_tok_s": tokens / dur_s,
                "goodput_tok_s": good / dur_s,
                "slo_attainment": met / max(1, completed),
                "replicas": len(gauges), "active": active, "parked": parked,
                "cache_tokens": ctok,
                "cache_hit_rate": chit / cask if cask else 0.0,
            })
            reps = self._ra[k]
            for g in gauges:
                ri = g["replica"]
                c = reps[ri] if ri < n_rep else None
                self.replica_rows.append({
                    "window": k, "replica": ri, "pod": g["pod"],
                    "routed": int(c[0]) if c is not None else 0,
                    "completed": int(c[1]) if c is not None else 0,
                    "tokens": int(c[2]) if c is not None else 0,
                    "faults": int(c[3]) if c is not None else 0,
                    "active": g["active"], "parked": g["parked"],
                    "active_limit": g["active_limit"],
                    "cache_tokens": g["cache_tokens"],
                    "cache_hit_rate": g["cache_hit_rate"],
                })
            # a pod appears in counters iff something arrived at or
            # completed in it this window, so any-nonzero is exactly the
            # legacy touched-pods dict-key set
            pods = self._pa[k]
            touched = set(int(i)
                          for i in np.nonzero(pods.any(axis=1))[0])
            n_pod = pods.shape[0]
            for pod in sorted(set(by_pod) | touched):
                c = pods[pod] if pod < n_pod else None
                pg = by_pod.get(pod, [])
                done_p = int(c[1]) if c is not None else 0
                met_p = int(c[2]) if c is not None else 0
                self.pod_rows.append({
                    "window": k, "pod": pod,
                    "arrivals": int(c[0]) if c is not None else 0,
                    "completed": done_p,
                    "slo_met": met_p,
                    "goodput_tok_s": (int(c[3]) if c is not None
                                      else 0) / dur_s,
                    "slo_attainment": met_p / max(1, done_p),
                    "replicas": len(pg),
                    "active": sum(g["active"] for g in pg),
                    "parked": sum(g["parked"] for g in pg),
                })
        self._open = k_last + 1


def detect_collapse_onset(windows: Sequence[Dict[str, Any]],
                          drop_frac: float = 0.5,
                          load_frac: float = 0.5,
                          min_peak_tok_s: float = 0.0
                          ) -> Optional[Dict[str, Any]]:
    """First *loaded* window where goodput collapsed under held load.

    A window is *loaded* when its arrivals are at least ``load_frac`` of
    the busiest window's - this excludes the ramp-in and the post-arrival
    drain, so an overloaded-but-serving fleet (queue grows, service rate
    intact, late completions miss SLO only after arrivals stop) is not
    flagged.  Within the loaded windows a running goodput peak is
    tracked; the onset is the first window at or below
    ``(1 - drop_frac) * peak`` (with ``peak > min_peak_tok_s``), i.e.
    goodput fell >= ``drop_frac`` while offered load held - the paper's
    collapse signature in the time domain.  Returns ``None`` when no
    window qualifies (the GCR-aware claim), else a report dict.
    """
    if not windows:
        return None
    max_arr = max(w["arrivals"] for w in windows)
    if max_arr <= 0:
        return None
    peak = 0.0
    peak_win = None
    for w in windows:
        if w["arrivals"] < load_frac * max_arr:
            continue
        g = w["goodput_tok_s"]
        if peak > min_peak_tok_s and g <= (1.0 - drop_frac) * peak:
            return {"window": w["window"], "t_ms": w["t_start_ms"],
                    "goodput_tok_s": g, "peak_tok_s": peak,
                    "peak_window": peak_win,
                    "drop_frac": 1.0 - g / peak}
        if g > peak:
            peak, peak_win = g, w["window"]
    return None


# ---------------------------------------------------------------------------
# the bundle the fleet threads through
# ---------------------------------------------------------------------------

class Observability:
    """Per-run observer bundle: spans + flight recorder + windowed metrics.

    Build one, pass it to ``Fleet``/``run_fleet`` via ``obs=``; like the
    fleet it is single-use (``begin`` binds the run).  ``window_ms <= 0``
    disables the metrics registry; ``spans=False`` / ``flight=False``
    disable the other two, so e.g. a metrics-only bundle adds no span
    cost to a sweep.  Every hook below is a pure read of fleet state -
    recording must never perturb the simulation.
    """

    def __init__(self, window_ms: float = 0.0, spans: bool = True,
                 flight: bool = True, slo=None,
                 prealloc_windows: int = 256) -> None:
        self.tracer = SpanTracer() if spans else None
        self.recorder = FlightRecorder() if flight else None
        self.metrics = (WindowedMetrics(window_ms, slo,
                                        prealloc_windows=prealloc_windows)
                        if window_ms > 0.0 else None)
        self.next_roll = float("inf")
        self._fleet = None
        self._cands: List[Dict[str, Any]] = []

    # -- run lifecycle -------------------------------------------------------
    def begin(self, fleet) -> None:
        if self._fleet is not None:
            raise RuntimeError("Observability is single-run; build a fresh "
                               "bundle per Fleet.run")
        self._fleet = fleet
        m = self.metrics
        if m is not None:
            if m.slo is None:
                m.slo = fleet.telemetry.slo
            self.next_roll = m.window_ms
        if self.tracer is not None:
            fleet.router.tracer = self.tracer
            for i, eng in enumerate(fleet.replicas):
                eng.obs = _EngineObs(self.tracer, i)

    def roll(self, t_ms: float) -> None:
        """Close every window whose end is at or before ``t_ms`` (called
        by the fleet loop when ``t >= next_roll``)."""
        m = self.metrics
        k = int(t_ms // m.window_ms)
        if k > m._open:
            m.close_through(k - 1, self._sample())
        self.next_roll = (k + 1) * m.window_ms

    def finish(self, end_ms: float) -> None:
        m = self.metrics
        if m is not None:
            m.close_through(int(end_ms // m.window_ms), self._sample())
            self.next_roll = float("inf")
        if self.tracer is not None and self._fleet is not None:
            self._fleet.router.tracer = None

    def _sample(self) -> List[Dict[str, Any]]:
        """Ground-truth per-replica gauges (the observer is omniscient;
        only *control-plane* reads are staleness-bound)."""
        fleet = self._fleet
        topo = fleet.topology
        out = []
        for i, eng in enumerate(fleet.replicas):
            if fleet.retired[i]:
                continue
            pc = eng.prefix_cache
            asks = pc.query_tokens if pc else 0
            out.append({
                "replica": i, "pod": topo.pod_of(i),
                "active": len(eng.active),
                "parked": eng.admission.num_parked,
                "active_limit": getattr(eng.admission, "active_limit",
                                        None),
                "cache_tokens": pc.tokens if pc else 0,
                "cache_hit_tokens": pc.hit_tokens if pc else 0,
                "cache_query_tokens": asks,
                "cache_hit_rate": (pc.hit_tokens / asks
                                   if pc and asks else 0.0),
            })
        return out

    # -- fleet hooks ---------------------------------------------------------
    def on_inject(self, req, kind: str, t_ms: float, pod: int) -> None:
        """An arrival or migrant re-arrival, *before* the route call -
        candidate gauges captured here are exactly the state the router
        is about to read (routing is pure, nothing mutates between)."""
        m = self.metrics
        if m is not None:
            if kind == "arrive":
                m.on_arrival(t_ms, pod)
            else:
                m.on_migrate(t_ms)
        tr = self.tracer
        if tr is not None:
            if kind == "arrive":
                tr.emit("arrive", t_ms, req.rid, pod=req.pod,
                        prompt_len=req.prompt_len, gen_len=req.gen_len,
                        session_id=req.session_id)
            elif req.first_token_ms < 0.0:
                # not yet streaming: a crash-requeued clone (restarts
                # from scratch, may re-emit first_token) or a pre-token
                # migrant - either way the stream is cold on arrival
                tr.emit("migrate_in", t_ms, req.rid, pod=req.pod,
                        cold=True)
            else:
                tr.emit("migrate_in", t_ms, req.rid, pod=req.pod)
            self._cands = self._candidates(t_ms)

    def _candidates(self, t_ms: float) -> List[Dict[str, Any]]:
        cands = []
        for v in self._fleet.live_views():
            cands.append({
                "idx": v.idx,
                "num_active": v.num_active,
                "num_parked": v.num_parked,
                "outstanding": v.outstanding,
                "active_limit": v.active_limit,
                "cache_tokens": v.cache_tokens,
                "staleness_ms": v.age_ms(t_ms),
            })
        return cands

    def on_routed(self, req, idx: int, admitted: bool,
                  t_ms: float) -> None:
        m = self.metrics
        if m is not None:
            m.on_routed(t_ms, idx)
        tr = self.tracer
        if tr is not None:
            scorer, scores = tr.take_scores()
            route: Dict[str, Any] = {"kind": "span", "event": "route",
                                     "t_ms": t_ms, "rid": req.rid,
                                     "replica": idx,
                                     "router": self._fleet.router.name,
                                     "candidates": self._cands}
            if scores is not None:
                route["scorer"] = scorer
                route["scores"] = scores
            tr.events.append(route)
            tr.emit("admit" if admitted else "park", t_ms, req.rid,
                    replica=idx)

    def on_completions(self, done, idx: int) -> None:
        m = self.metrics
        tr = self.tracer
        if m is not None:
            n_pods = self._fleet.topology.n_pods
            for r in done:
                m.on_completion(r, idx, r.pod % n_pods)
        if tr is not None:
            slo = self._fleet.telemetry.slo
            for r in done:
                tr.emit("complete", r.done_ms, r.rid, replica=idx,
                        generated=r.generated, slo_met=slo.met(r))

    def on_publish(self, idx: int, t_ms: float, report) -> None:
        if self.recorder is not None:
            self.recorder.on_publish(t_ms, idx, report)

    def on_scale(self, t_ms: float, decision) -> None:
        rec = self.recorder
        if rec is None:
            return
        fleet = self._fleet
        bus = fleet.bus
        live = fleet.live_indices()
        snap = []
        for i in live:
            r = bus.reports[i]
            d = dataclasses.asdict(r)
            d["replica"] = i
            d["staleness_ms"] = t_ms - r.t_ms
            snap.append(d)
        rationale = None
        if decision is not None and decision.remove is not None:
            from .controller import victim_scores
            cands = live
            if decision.pod is not None:
                pod_of = fleet.topology.pod_of
                cands = [i for i in live if pod_of(i) == decision.pod]
            try:
                keys = victim_scores(decision.victim,
                                     [bus.reports[i] for i in cands], cands,
                                     getattr(fleet, "ejected", ()))
                rationale = [{"replica": cands[j], "key": list(keys[j])}
                             for j in range(len(cands))]
            except ValueError:
                rationale = None
        rec.on_scale_tick(t_ms, decision, snap, rationale)

    def on_spawn(self, idx: int, t_ms: float, eng,
                 pod: Optional[int]) -> None:
        if self.tracer is not None:
            eng.obs = _EngineObs(self.tracer, idx)
        if self.recorder is not None:
            self.recorder.on_spawn(t_ms, idx, pod)

    def on_retire(self, idx: int, t_ms: float, drain_end_ms: float,
                  active_moved, parked_moved) -> None:
        if self.recorder is not None:
            self.recorder.on_retire(t_ms, idx,
                                    len(active_moved) + len(parked_moved),
                                    drain_end_ms)
        tr = self.tracer
        if tr is not None:
            for r in active_moved:
                tr.emit("migrate_out", drain_end_ms, r.rid, replica=idx,
                        resident=True)
            for r in parked_moved:
                tr.emit("migrate_out", t_ms, r.rid, replica=idx,
                        resident=False)

    # -- fault-plane hooks ---------------------------------------------------
    def on_fault(self, idx: int, t_ms: float, op: str, requeued: int = 0,
                 lost: int = 0, moved=()) -> None:
        """A fault edge (or health eject/restore) hit replica ``idx``;
        ``moved`` carries the crash-requeued streams as ``(req, t_out)``
        so their migrate_out spans keep the lifecycle conserved."""
        if self.recorder is not None:
            if op == "crash":
                self.recorder.on_fault(t_ms, idx, op, requeued=requeued,
                                       lost=lost)
            else:
                self.recorder.on_fault(t_ms, idx, op)
        if self.metrics is not None:
            self.metrics.on_fault(t_ms, idx)
        tr = self.tracer
        if tr is not None:
            for r, t_out in moved:
                tr.emit("migrate_out", t_out, r.rid, replica=idx,
                        resident=False)

    def on_hedge(self, twin, t_ms: float) -> None:
        """A hedge duplicate was issued; captured *before* the route
        call, same contract as ``on_inject``."""
        tr = self.tracer
        if tr is not None:
            tr.emit("hedge", t_ms, twin.rid)
            self._cands = self._candidates(t_ms)

    def on_cancel(self, req, idx: int, t_ms: float) -> None:
        """A hedge copy was cancelled (``idx`` = -1: cancelled while its
        KV was in transit, i.e. off any replica)."""
        if self.tracer is not None:
            self.tracer.emit("cancel", t_ms, req.rid, replica=idx)

    # -- results -------------------------------------------------------------
    @property
    def windows(self) -> List[Dict[str, Any]]:
        """Closed fleet-scope window rows (empty when metrics disabled)."""
        return self.metrics.fleet_rows if self.metrics is not None else []

    def onset(self, drop_frac: float = 0.5,
              load_frac: float = 0.5) -> Optional[Dict[str, Any]]:
        return detect_collapse_onset(self.windows, drop_frac=drop_frac,
                                     load_frac=load_frac)

    def export(self, prefix: str) -> Dict[str, str]:
        """Write every enabled stream next to ``prefix``:
        ``.spans.jsonl`` / ``.trace.json`` (Perfetto-loadable) /
        ``.flight.jsonl`` / ``.windows.csv``.  Returns stream->path."""
        paths: Dict[str, str] = {}
        if self.tracer is not None:
            p = f"{prefix}.spans.jsonl"
            write_jsonl(p, self.tracer.records())
            paths["spans"] = p
            p = f"{prefix}.trace.json"
            with open(p, "w") as f:
                json.dump(chrome_trace(self.tracer, self.recorder,
                                       self.metrics), f)
            paths["trace"] = p
        if self.recorder is not None:
            p = f"{prefix}.flight.jsonl"
            write_jsonl(p, self.recorder.records())
            paths["flight"] = p
        if self.metrics is not None:
            p = f"{prefix}.windows.csv"
            with open(p, "w", newline="") as f:
                wr = csv.DictWriter(f, fieldnames=WINDOW_FIELDS)
                wr.writeheader()
                for row in self.metrics.fleet_rows:
                    wr.writerow(row)
            paths["windows"] = p
        return paths


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def write_jsonl(path: str, records: Sequence[Dict[str, Any]]) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def chrome_trace(tracer: SpanTracer,
                 recorder: Optional[FlightRecorder] = None,
                 metrics: Optional[WindowedMetrics] = None
                 ) -> Dict[str, Any]:
    """Fold the observer streams into Chrome trace-event JSON.

    One ``X`` slice per request (arrival to completion, on its final
    serving replica's process track), ``i`` instants for the mid-life
    transitions, control-plane instants for scale actions, and ``C``
    counter tracks from the fleet window rows.  Timestamps are
    microseconds per the trace-event spec (virtual ms x 1000).
    """
    evs: List[Dict[str, Any]] = []
    pids: Dict[int, str] = {0: "control-plane"}
    by_rid: Dict[int, List[Dict[str, Any]]] = {}
    for e in tracer.events:
        by_rid.setdefault(e["rid"], []).append(e)
    for rid in sorted(by_rid):
        es = sorted(by_rid[rid], key=lambda e: e["t_ms"])  # lint: disable=R203(export-only view; stable sort keeps the tracer's deterministic emission order on ties)
        t0 = es[0]["t_ms"]
        dones = [e for e in es if e["event"] == "complete"]
        t1 = dones[-1]["t_ms"] if dones else es[-1]["t_ms"]
        rep = -1
        for e in reversed(es):
            if e.get("replica") is not None:
                rep = e["replica"]
                break
        pid = rep + 1 if rep >= 0 else 0
        if pid:
            pids.setdefault(pid, f"replica-{rep}")
        evs.append({"name": f"r{rid}", "cat": "request", "ph": "X",
                    "pid": pid, "tid": rid, "ts": t0 * 1e3,
                    "dur": max(t1 - t0, 0.0) * 1e3,
                    "args": {"events": [[e["event"], e["t_ms"]]
                                        for e in es]}})
        for e in es:
            if e["event"] in ("park", "unpark", "demote", "first_token",
                              "migrate_out"):
                evs.append({"name": e["event"], "cat": "lifecycle",
                            "ph": "i", "s": "t", "pid": pid, "tid": rid,
                            "ts": e["t_ms"] * 1e3})
    if recorder is not None:
        for r in recorder.entries:
            if r["kind"] == "scale_tick" and r["action"] != "none":
                evs.append({"name": f"scale:{r['action']}",
                            "cat": "control", "ph": "i", "s": "g",
                            "pid": 0, "tid": 0, "ts": r["t_ms"] * 1e3,
                            "args": {"reason": r["reason"],
                                     "pod": r["pod"]}})
    if metrics is not None:
        for w in metrics.fleet_rows:
            evs.append({"name": "fleet", "ph": "C", "pid": 0,
                        "ts": w["t_start_ms"] * 1e3,
                        "args": {"goodput_tok_s": w["goodput_tok_s"],
                                 "active": w["active"],
                                 "parked": w["parked"]}})
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": name}} for pid, name in sorted(pids.items())]
    return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# schema validation (hand-rolled: no external schema dependency)
# ---------------------------------------------------------------------------

def span_conservation(records: Sequence[Dict[str, Any]]
                      ) -> Dict[str, Any]:
    """Reconstruct lifecycle conservation counts from a span stream.

    Returns aggregate per-event counts plus per-request ``violations``:
    every request must arrive exactly once, every injection (arrive +
    migrate_in) must produce exactly one route and one admit-or-park,
    completions/first-tokens are at-most-once, and a stream can only
    unpark as often as it was parked or demoted.
    """
    per: Dict[int, Dict[str, int]] = {}
    cold_in: Dict[int, int] = {}
    for r in records:
        if r.get("kind") != "span":
            continue
        _bump(per.setdefault(r["rid"], {}), r["event"])
        if r["event"] == "migrate_in" and r.get("cold"):
            cold_in[r["rid"]] = cold_in.get(r["rid"], 0) + 1
    agg: Dict[str, Any] = {ev + "s": 0 for ev in SPAN_EVENTS}
    violations: List[str] = []
    for rid in sorted(per):
        c = per[rid]
        for ev, n in c.items():
            # tolerate unknown events (validate_spans flags them)
            agg[ev + "s"] = agg.get(ev + "s", 0) + n
        if c.get("arrive", 0) != 1:
            violations.append(f"rid {rid}: {c.get('arrive', 0)} arrivals")
        # a hedge is an injection of a duplicate copy sharing the rid:
        # it routes and places like any arrival, and lets the stream
        # legitimately complete (or first-token) once per extra copy
        hedges = c.get("hedge", 0)
        injected = c.get("arrive", 0) + c.get("migrate_in", 0) + hedges
        routes = c.get("route", 0)
        placed = c.get("admit", 0) + c.get("park", 0)
        if routes != injected:
            violations.append(f"rid {rid}: {routes} routes for "
                              f"{injected} injections")
        if placed != routes:
            violations.append(f"rid {rid}: {placed} admit/park for "
                              f"{routes} routes")
        if c.get("complete", 0) > 1 + hedges:
            violations.append(f"rid {rid}: completed twice")
        # a COLD re-injection (a crash-requeued clone, ``cold`` flag on
        # its migrate_in span) restarts the stream from scratch, so it
        # may re-emit first_token; a warm migrant carries its progress
        # and must not
        if c.get("first_token", 0) > 1 + hedges + cold_in.get(rid, 0):
            violations.append(f"rid {rid}: two first tokens")
        if c.get("cancel", 0) > hedges:
            violations.append(f"rid {rid}: more cancels than hedges")
        if c.get("unpark", 0) > c.get("park", 0) + c.get("demote", 0):
            violations.append(f"rid {rid}: more unparks than park+demote")
    agg["requests"] = len(per)
    agg["violations"] = violations
    return agg


_SPAN_FIELDS = {"route": ("replica", "candidates"),
                "admit": ("replica",), "park": ("replica",),
                "unpark": ("replica",), "demote": ("replica",),
                "first_token": ("replica",), "complete": ("replica",),
                "migrate_out": ("replica",), "cancel": ("replica",)}


def validate_spans(records: Sequence[Dict[str, Any]]) -> List[str]:
    """Schema + conservation check of a span stream; [] means valid."""
    errs: List[str] = []
    if not records:
        return ["empty span stream"]
    head = records[0]
    if head.get("kind") != "header" or head.get("schema") != SPAN_SCHEMA:
        errs.append(f"first record is not a {SPAN_SCHEMA} header")
    body = [r for r in records if r.get("kind") != "header"]
    if head.get("kind") == "header" \
            and head.get("n_events") not in (None, len(body)):
        errs.append(f"header says {head['n_events']} events, "
                    f"stream has {len(body)}")
    for i, r in enumerate(body):
        where = f"record {i}"
        if r.get("kind") != "span":
            errs.append(f"{where}: kind {r.get('kind')!r} != 'span'")
            continue
        ev = r.get("event")
        if ev not in SPAN_EVENTS:
            errs.append(f"{where}: unknown event {ev!r}")
            continue
        if not isinstance(r.get("rid"), int):
            errs.append(f"{where}: rid missing or not int")
        if not isinstance(r.get("t_ms"), (int, float)):
            errs.append(f"{where}: t_ms missing or not numeric")
        for fld in _SPAN_FIELDS.get(ev, ()):
            if fld not in r:
                errs.append(f"{where}: {ev} missing {fld!r}")
        if ev == "route" and not isinstance(r.get("candidates"), list):
            errs.append(f"{where}: route candidates is not a list")
    cons = span_conservation(records)
    errs.extend(cons["violations"])
    return errs


def validate_flight(records: Sequence[Dict[str, Any]]) -> List[str]:
    """Schema check of a flight-recorder stream; [] means valid."""
    errs: List[str] = []
    if not records:
        return ["empty flight stream"]
    head = records[0]
    if head.get("kind") != "header" or head.get("schema") != FLIGHT_SCHEMA:
        errs.append(f"first record is not a {FLIGHT_SCHEMA} header")
    for i, r in enumerate(records[1:]):
        where = f"entry {i}"
        kind = r.get("kind")
        if kind not in FLIGHT_KINDS:
            errs.append(f"{where}: unknown kind {kind!r}")
            continue
        if not isinstance(r.get("t_ms"), (int, float)):
            errs.append(f"{where}: t_ms missing or not numeric")
        if kind == "scale_tick":
            if r.get("action") not in SCALE_ACTIONS:
                errs.append(f"{where}: bad action {r.get('action')!r}")
            if not isinstance(r.get("snapshot"), list):
                errs.append(f"{where}: snapshot is not a list")
        elif kind == "publish":
            if not isinstance(r.get("report"), dict):
                errs.append(f"{where}: publish without report")
        elif not isinstance(r.get("replica"), int):
            errs.append(f"{where}: {kind} without replica index")
    return errs


def validate_windows(rows: Sequence[Dict[str, Any]]) -> List[str]:
    """Schema + monotonicity check of fleet window rows; [] means valid."""
    errs: List[str] = []
    prev_win = None
    for i, w in enumerate(rows):
        where = f"window row {i}"
        missing = [f for f in WINDOW_FIELDS if f not in w]
        if missing:
            errs.append(f"{where}: missing fields {missing}")
            continue
        if prev_win is not None and w["window"] <= prev_win:
            errs.append(f"{where}: window index not increasing")
        if w["t_end_ms"] <= w["t_start_ms"]:
            errs.append(f"{where}: t_end_ms <= t_start_ms")
        for f in ("arrivals", "completed", "slo_met", "tokens",
                  "good_tokens", "migrated", "replicas", "active",
                  "parked"):
            if w[f] < 0:
                errs.append(f"{where}: negative {f}")
        if w["slo_met"] > w["completed"]:
            errs.append(f"{where}: slo_met > completed")
        if w["good_tokens"] > w["tokens"]:
            errs.append(f"{where}: good_tokens > tokens")
        prev_win = w["window"]
    return errs


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.cluster.obs --validate spans.jsonl [...]
# ---------------------------------------------------------------------------

def _read_windows_csv(path: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    with open(path, newline="") as f:
        for raw in csv.DictReader(f):
            row: Dict[str, Any] = {}
            for k, v in raw.items():
                try:
                    row[k] = float(v)
                except (TypeError, ValueError):
                    row[k] = v
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.obs",
        description="validate emitted observability streams")
    ap.add_argument("--validate", metavar="SPANS_JSONL",
                    help="span stream to schema-check")
    ap.add_argument("--flight", metavar="FLIGHT_JSONL",
                    help="flight-recorder stream to schema-check")
    ap.add_argument("--windows", metavar="WINDOWS_CSV",
                    help="fleet window series to schema-check")
    args = ap.parse_args(argv)
    if not (args.validate or args.flight or args.windows):
        ap.error("nothing to validate")
    failed = False
    for label, path, check in (
            ("spans", args.validate,
             lambda p: validate_spans(read_jsonl(p))),
            ("flight", args.flight,
             lambda p: validate_flight(read_jsonl(p))),
            ("windows", args.windows,
             lambda p: validate_windows(_read_windows_csv(p)))):
        if not path:
            continue
        errs = check(path)
        if errs:
            failed = True
            print(f"{label}: {path}: {len(errs)} error(s)")
            for e in errs[:20]:
                print(f"  {e}")
        else:
            print(f"{label}: {path}: ok")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
