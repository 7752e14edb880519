"""Fleet autoscaling policies (DESIGN.md 7).

The port's own copy of ``repro.cluster.controller``, unchanged in
behaviour but for ``MigrationCost``'s defaults, which are the H100's: the
port imports nothing of ``repro``.

The paper's wrapper grows and shrinks a lock's active set from observed
contention; the fleet controller grows and shrinks the *replica pool* from
observed SLO attainment.  Both read cheap, possibly-stale signals
(``signals.SignalBus``) and both must pay a real cost to shrink - GCR
re-parks a thread, the fleet migrates KV state off the retiring replica.

* ``ScaleDecision``       - one tick's verdict: add an engine (optionally
  *into a named pod*), or retire a replica index chosen by an explicit
  victim policy (its unfinished streams migrate to the survivors after a
  KV-transfer delay charged to the virtual clock);
* ``MigrationCost``       - that delay's model (base handoff + bytes/bw);
* ``select_victim``       - the shared victim policies:
  ``least_outstanding`` (fewest unfinished streams, the legacy rule) and
  ``coldest_cache`` (fewest published warm prefix-KV tokens - scale-in
  destroys the retiree's cache, so the warm ``prefix_tokens_lost`` is
  part of the *decision*, not just an after-the-fact counter);
* ``QueueDepthAutoscaler``- the first threshold hook, kept as the baseline:
  scale out on parked backlog, never scale in;
* ``SLOAutoscaler``       - the production-shaped policy: scale out on
  goodput/TTFT-attainment regression with backlog present, scale in when
  the survivors can absorb the active load, and (``predictive=True``)
  track the arrival-rate trend so the diurnal ramp is met ahead of time
  instead of after the tail blows up.  ``season_period_ms`` adds a
  periodic (day-phase) component to that fit for multi-day diurnal
  traces; ``pod_scoped=True`` makes every decision **topology-scoped**:
  per-pod attainment/backlog/arrival-share rollups (``signals.PodView``
  over the shared ``FleetTopology``), scale-out *into the saturated
  pod*, scale-in of a victim *within the most idle pod* - the GCR-NUMA
  discipline (admit/cull per socket, not per machine) applied to the
  replica pool.

Every *replica-side* input comes from the signal bus, so controllers are
exactly as stale as the router - ``period_ms=0`` makes both omniscient.
The arrival counters (fleet-wide and per-pod) are the one exception: the
control plane lives in the load balancer and counts arrivals first-hand,
so the predictive model's rate signal is always fresh.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import H100
from ..serving.engine import T_FIXED_MS, SimServeEngine
from .signals import ReplicaReport
from .topology import FleetTopology


class _SingleFleet:
    """Autoscalers carry cross-tick state (cooldowns, counter baselines),
    so an instance is valid for exactly one fleet run - reuse would seed
    run 2 with run 1's history and silently skew its decisions."""

    _fleet = None

    def _bind(self, fleet) -> None:
        if self._fleet is None:
            self._fleet = fleet
        elif self._fleet is not fleet:
            raise RuntimeError(
                f"{type(self).__name__} instances are single-fleet; "
                "build a fresh autoscaler per run")


@dataclass(frozen=True)
class ScaleDecision:
    """One autoscaler tick's verdict.  At most one of add/remove is set.

    ``pod`` scopes the decision to a pod of the fleet's ``FleetTopology``:
    on scale-out the spawned replica is *assigned to that pod* (instead
    of inheriting the static index-parity pod), on scale-in it records
    which pod the victim was drained from.  ``victim`` names the policy
    that chose ``remove`` (see ``select_victim``) so telemetry and logs
    can attribute the warm-state cost of the retirement.
    """

    add: Optional[SimServeEngine] = None
    remove: Optional[int] = None      # replica index to retire + drain
    pod: Optional[int] = None         # target pod (None = pool-scalar)
    victim: str = ""                  # policy that picked `remove`
    reason: str = ""


VICTIM_POLICIES = ("least_outstanding", "coldest_cache")


def victim_scores(policy: str, reports: Sequence[ReplicaReport],
                  live: Sequence[int],
                  ejected: Sequence[int] = ()) -> List[tuple]:
    """Per-candidate sort key of a victim policy, lowest key retires.

    This is the *rationale* behind ``select_victim`` - the flight
    recorder (``obs.FlightRecorder``) logs it per scale-in decision so a
    retirement can be root-caused from the trace alone.  The keys are
    exactly the tuples ``select_victim`` minimizes, so the logged
    rationale can never drift from the decision.

    ``ejected`` (the health plane's outlier set, Malthusian "cull the
    sick") prepends a membership flag to every key: an ejected replica
    sorts before any healthy one, so a scale-in preferentially retires
    the replica routing already wrote off.  Empty ``ejected`` returns
    the legacy keys unchanged."""
    if policy == "coldest_cache":
        keys = [(reports[j].cache_tokens, reports[j].outstanding, live[j])
                for j in range(len(live))]
    elif policy == "least_outstanding" or policy == "":
        keys = [(reports[j].outstanding, live[j])
                for j in range(len(live))]
    else:
        raise ValueError(f"unknown victim policy {policy!r} "
                         f"(want one of {VICTIM_POLICIES})")
    if ejected:
        sick = frozenset(ejected)
        keys = [((0 if live[j] in sick else 1,) + keys[j])
                for j in range(len(live))]
    return keys


def select_victim(policy: str, reports: Sequence[ReplicaReport],
                  live: Sequence[int],
                  ejected: Sequence[int] = ()) -> int:
    """Position in ``live`` of the replica a scale-in should retire.

    ``least_outstanding`` is the legacy rule (fewest unfinished streams,
    ties to the lowest replica index).  ``coldest_cache`` retires the
    replica whose *published* prefix cache holds the fewest warm tokens
    (ties: fewest outstanding, then lowest index): the retiree's cache
    dies with it and not-yet-prefilled migrants lose their pinned hits,
    so the cheapest replica to kill is the one whose warm state is
    already worthless - this is what turns ``prefix_tokens_lost`` from
    an after-the-fact counter into an input of the decision.  Reports
    come off the signal bus, so victim selection is exactly as stale as
    every other control-plane read.  A non-empty ``ejected`` set makes
    health-ejected replicas the preferred victims (see
    ``victim_scores``).
    """
    keys = victim_scores(policy, reports, live, ejected)
    return min(range(len(live)), key=keys.__getitem__)


@dataclass(frozen=True)
class MigrationCost:
    """Virtual-time cost of moving one stream off a retiring replica.

    Active streams pay for their resident KV over the inter-replica link;
    parked streams hold no KV (parking is free, per the paper) and pay
    only the control-plane handoff."""

    # per-stream handoff: the migrant rejoins at the destination's next
    # step, so it waits one H100 step floor (T_FIXED_MS, the host's work)
    base_ms: float = T_FIXED_MS
    # the link between replicas: H100.network_bw (50 GB/s), in bytes a ms
    bw_bytes_per_ms: float = H100.network_bw / 1e3

    def ms(self, resident_tokens: int, kv_bytes_per_tok: float) -> float:
        return (self.base_ms
                + resident_tokens * kv_bytes_per_tok / self.bw_bytes_per_ms)


class QueueDepthAutoscaler(_SingleFleet):
    """Scale out when mean parked depth per replica crosses a threshold.

    The first hook, now reading the signal bus instead of live engines (so
    it lags exactly like the router under staleness).  Deliberately has no
    scale-in: parked streams cost nothing, so it never lets go of a
    replica - the baseline the SLO controller must beat on replica-ms.
    """

    def __init__(self, cfg, max_replicas: int = 8,
                 parked_per_replica: Optional[float] = None,
                 cooldown_ms: float = 2000.0) -> None:
        self.cfg = cfg
        self.max_replicas = max_replicas
        # default trigger: a full active set's worth of parked streams
        self.parked_per_replica = (float(cfg.active_limit)
                                   if parked_per_replica is None
                                   else parked_per_replica)
        self.cooldown_ms = cooldown_ms
        self._last_scale_ms = -1e18

    def __call__(self, fleet, now_ms: float) -> Optional[ScaleDecision]:
        self._bind(fleet)
        live = fleet.live_indices()
        if len(live) >= self.max_replicas:
            return None
        if now_ms - self._last_scale_ms < self.cooldown_ms:
            return None
        views = fleet.bus.views
        parked = sum(views[i].num_parked for i in live)
        if parked / len(live) <= self.parked_per_replica:
            return None
        self._last_scale_ms = now_ms
        return ScaleDecision(add=self.cfg.make_engine(),
                             reason=f"parked {parked} > "
                                    f"{self.parked_per_replica:g}/replica")


class SLOAutoscaler(_SingleFleet):
    """SLO-attainment-driven scale-out, headroom-driven scale-in.

    Per tick (reading only bus snapshots):

    * window attainment = SLO-met / completed since the previous tick;
    * **out** when attainment is under ``target_attainment`` AND parked
      backlog exists (a miss with no backlog means the pool is not the
      bottleneck), or when the predictive model wants more replicas;
    * **in**  when the window met target, nothing is parked, and the
      survivors' active-set capacity absorbs the current active load with
      ``scale_in_util`` slack - the victim is the least-outstanding live
      replica, and its streams migrate at ``MigrationCost`` (charged by
      the fleet to the virtual clock, so a bad scale-in shows up as TTFT
      regression, not as a free lunch);
    * ``predictive=True`` fits a linear trend to the bus's arrival-rate
      windows and sizes the pool for the rate ``lead_ms`` ahead
      (``ceil(projected_rps / rps_per_replica)``), which is what tracks
      the diurnal ramp without waiting for the SLO to burn first;
    * ``season_period_ms=T`` upgrades that fit to **seasonality-aware**:
      once the window covers >= 1.25 periods, the projection is a
      least-squares ``mean + trend + sin/cos(2*pi*t/T)`` fit, so on a
      multi-day diurnal trace the controller anticipates tomorrow's ramp
      from yesterday's phase instead of extrapolating the last slope
      (which points the wrong way at every inflection); short windows
      fall back to the linear trend, and ``season_period_ms=None``
      (default) IS the linear trend, decision for decision;
    * ``victim`` picks the scale-in victim policy (``select_victim``):
      the default ``least_outstanding`` is the legacy rule, and
      ``coldest_cache`` spends warm prefix state deliberately - it
      retires the replica whose published cache holds the least;
    * ``pod_scoped=True`` (with a >1-pod ``FleetTopology`` on the fleet)
      makes every decision per pod from ``signals.PodView`` rollups:
      scale out *into* the pod whose attainment is burning (the spawned
      replica is pod-assigned, so pod-affine routers feed it that pod's
      traffic immediately), scale in from the most idle pod when the
      pod's own survivors absorb the pod's own active load, and run the
      predictive model per pod on per-pod arrival counters - each pod is
      sized ahead of its *own* diurnal phase.  ``min_per_pod`` keeps
      every pod routable.
    """

    def __init__(self, cfg, max_replicas: int = 8, min_replicas: int = 1,
                 target_attainment: float = 0.95,
                 scale_in_util: float = 0.6,
                 cooldown_out_ms: float = 1000.0,
                 cooldown_in_ms: float = 2500.0,
                 predictive: bool = False, lead_ms: float = 5000.0,
                 rps_per_replica: Optional[float] = None,
                 history: int = 8,
                 season_period_ms: Optional[float] = None,
                 victim: str = "least_outstanding",
                 pod_scoped: bool = False,
                 min_per_pod: int = 1) -> None:
        if victim not in VICTIM_POLICIES:
            raise ValueError(f"unknown victim policy {victim!r}")
        self.cfg = cfg
        self.max_replicas = max_replicas
        self.min_replicas = max(1, min_replicas)
        self.target_attainment = target_attainment
        self.scale_in_util = scale_in_util
        self.cooldown_out_ms = cooldown_out_ms
        self.cooldown_in_ms = cooldown_in_ms
        self.predictive = predictive
        self.lead_ms = lead_ms
        self.rps_per_replica = rps_per_replica
        self.season_period_ms = season_period_ms
        self.victim = victim
        self.pod_scoped = pod_scoped
        self.min_per_pod = max(1, min_per_pod)
        if season_period_ms is not None:
            # the seasonal fit needs >= 1.25 periods of rate marks in the
            # window; the default 8-tick history would never see one
            history = max(history, 96)
        self._hist: Deque[Tuple[float, int]] = deque(maxlen=max(3, history))
        self._prev: Optional[Tuple[float, int, int]] = None
        self._last_out = -1e18
        self._last_in = -1e18
        # pod-scoped state: per-pod arrival histories, counter baselines,
        # and cooldown clocks.  Cooldowns are PER POD: each pod is its
        # own capacity pool, so growing the rising pod must not freeze
        # the falling pod's scale-in (a global interlock would chronically
        # block retirement under anti-phase load - the exact regime
        # pod-scoped scaling exists for)
        self._pod_hist: Dict[int, Deque[Tuple[float, int]]] = {}
        self._pod_prev: Optional[Dict[int, Tuple[int, int]]] = None
        self._pod_last_out: Dict[int, float] = {}
        self._pod_last_in: Dict[int, float] = {}

    # -- predictive model ----------------------------------------------------
    @staticmethod
    def _rate_points(marks: List[Tuple[float, int]]
                     ) -> List[Tuple[float, float]]:
        """Arrival-counter marks -> (mid-window time, rps) rate points."""
        pts: List[Tuple[float, float]] = []
        for (t0, a0), (t1, a1) in zip(marks, marks[1:]):
            if t1 > t0:
                pts.append((0.5 * (t0 + t1), (a1 - a0) / (t1 - t0) * 1e3))
        return pts

    def _project_rps(self, pts: List[Tuple[float, float]]) -> float:
        """Arrival rate projected ``lead_ms`` past the last rate point.

        Seasonal mode (``season_period_ms``) fits
        ``c0 + c1*t + c2*sin(wt) + c3*cos(wt)`` by least squares once the
        window spans >= 1.25 periods (the phase is unidentifiable on
        less), else - and always without a period - the legacy linear
        trend, kept term-for-term so default-knob runs are bit-identical.
        """
        period = self.season_period_ms
        if period and len(pts) >= 8 \
                and pts[-1][0] - pts[0][0] >= 1.25 * period:
            t = np.asarray([p[0] for p in pts], dtype=np.float64)
            r = np.asarray([p[1] for p in pts], dtype=np.float64)
            w = 2.0 * math.pi / period
            design = np.column_stack(
                [np.ones_like(t), t, np.sin(w * t), np.cos(w * t)])
            coef, _res, rank, _sv = np.linalg.lstsq(design, r, rcond=None)
            if rank == design.shape[1]:      # phase actually identified
                tf = pts[-1][0] + self.lead_ms
                proj = float(coef[0] + coef[1] * tf
                             + coef[2] * math.sin(w * tf)
                             + coef[3] * math.cos(w * tf))
                return max(0.0, proj)
        # least-squares slope of rps over time, projected lead_ms ahead
        n = len(pts)
        mt = sum(t for t, _ in pts) / n
        mr = sum(r for _, r in pts) / n
        var = sum((t - mt) ** 2 for t, _ in pts)
        slope = (sum((t - mt) * (r - mr) for t, r in pts) / var
                 if var > 0 else 0.0)
        return max(0.0, pts[-1][1] + slope * self.lead_ms)

    def _desired_from(self, hist) -> Optional[int]:
        """Replicas needed for the projected arrival rate of one counter
        history, or None when the model has no opinion (not predictive /
        not enough history).  Shared by the pool-scalar and per-pod
        paths so their projection gating can never diverge."""
        if not self.predictive or self.rps_per_replica is None \
                or hist is None or len(hist) < 3:
            return None
        pts = self._rate_points(list(hist))
        if len(pts) < 2:
            return None
        proj = self._project_rps(pts)
        return int(math.ceil(proj / self.rps_per_replica))

    def _desired(self) -> Optional[int]:
        return self._desired_from(self._hist)

    def _pod_desired(self, pod: int) -> Optional[int]:
        """Per-pod replica need from the pod's own arrival history (the
        same projection model, so each pod tracks its own phase)."""
        return self._desired_from(self._pod_hist.get(pod))

    def __call__(self, fleet, now_ms: float) -> Optional[ScaleDecision]:
        self._bind(fleet)
        topo: Optional[FleetTopology] = getattr(fleet, "topology", None)
        if self.pod_scoped and topo is not None and topo.n_pods > 1:
            return self._pod_tick(fleet, topo, now_ms)
        live = fleet.live_indices()
        # cumulative counters sum over EVERY replica ever registered -
        # retired replicas keep their history on the bus, so the window
        # delta stays monotone across a scale-in (summing survivors only
        # would go negative and fake a perfect window)
        all_reports = fleet.bus.snapshot(
            now_ms, range(len(fleet.bus.engines)))
        done = sum(r.completed for r in all_reports)
        met = sum(r.slo_met for r in all_reports)
        reports = [all_reports[i] for i in live]   # occupancy gauges: live only
        self._hist.append((now_ms, fleet.bus.arrivals))
        if self._prev is None:            # first tick: just baseline counters
            self._prev = (now_ms, done, met)
            return None
        _, pd, pm = self._prev
        self._prev = (now_ms, done, met)
        d_done, d_met = done - pd, met - pm
        parked = sum(r.num_parked for r in reports)
        active = sum(r.num_active for r in reports)
        if d_done > 0:
            att = d_met / d_done
        else:
            # nothing completed: a stalled-but-loaded window is the worst
            # SLO state there is, not a perfect one
            att = 0.0 if parked > 0 else 1.0
        limits = [r.active_limit if r.active_limit is not None
                  else self.cfg.active_limit for r in reports]
        n = len(live)
        desired = self._desired()

        if n < self.max_replicas \
                and now_ms - self._last_out >= self.cooldown_out_ms:
            breach = att < self.target_attainment and parked > 0
            if breach or (desired is not None and desired > n):
                self._last_out = now_ms
                why = (f"attainment {att:.0%} < "
                       f"{self.target_attainment:.0%}" if breach
                       else f"projected need {desired} > {n}")
                return ScaleDecision(add=self.cfg.make_engine(), reason=why)

        if n > self.min_replicas \
                and now_ms - self._last_in >= self.cooldown_in_ms \
                and now_ms - self._last_out >= self.cooldown_in_ms:
            k = select_victim(self.victim, reports, live,
                              getattr(fleet, "ejected", ()))
            rest = sum(limits) - limits[k]
            drained = (parked == 0 and att >= self.target_attainment
                       and active <= self.scale_in_util * rest)
            if drained and (desired is None or desired < n):
                self._last_in = now_ms
                return ScaleDecision(
                    remove=live[k], victim=self.victim,
                    reason=f"active {active} fits {self.scale_in_util:g}x "
                           f"of remaining {rest} ({self.victim} victim)")
        return None

    # -- pod-scoped decisions ------------------------------------------------
    def _pod_tick(self, fleet, topo: FleetTopology,
                  now_ms: float) -> Optional[ScaleDecision]:
        """Topology-scoped tick: one PodView rollup per pod, the same
        out/in conditions as the scalar path but evaluated per pod, and
        at most one (the most urgent) decision per tick."""
        live = fleet.live_indices()
        pviews = fleet.bus.pod_views(topo, live, now_ms)
        maxlen = self._hist.maxlen
        for pv in pviews:
            hist = self._pod_hist.get(pv.pod)
            if hist is None:
                hist = deque(maxlen=maxlen)
                self._pod_hist[pv.pod] = hist
            hist.append((now_ms, pv.arrivals))
        if self._pod_prev is None:        # first tick: baseline counters
            self._pod_prev = {pv.pod: (pv.completed, pv.slo_met)
                              for pv in pviews}
            return None
        att: Dict[int, float] = {}
        desired: Dict[int, Optional[int]] = {}
        for pv in pviews:
            pd, pm = self._pod_prev.get(pv.pod, (0, 0))
            self._pod_prev[pv.pod] = (pv.completed, pv.slo_met)
            d_done, d_met = pv.completed - pd, pv.slo_met - pm
            if d_done > 0:
                att[pv.pod] = d_met / d_done
            else:
                # same stall rule as the scalar path, per pod
                att[pv.pod] = 0.0 if pv.num_parked > 0 else 1.0
            desired[pv.pod] = self._pod_desired(pv.pod)
        n = len(live)

        if n < self.max_replicas:
            burning = [
                pv for pv in pviews
                if now_ms - self._pod_last_out.get(pv.pod, -1e18)
                >= self.cooldown_out_ms
                and ((att[pv.pod] < self.target_attainment
                      and pv.num_parked > 0)
                     or (desired[pv.pod] is not None
                         and desired[pv.pod] > len(pv.replicas)))]
            if burning:
                # worst attainment first, then deepest backlog, then pod id
                pv = min(burning,
                         key=lambda v: (att[v.pod], -v.num_parked, v.pod))
                self._pod_last_out[pv.pod] = now_ms
                breach = (att[pv.pod] < self.target_attainment
                          and pv.num_parked > 0)
                why = (f"pod {pv.pod} attainment {att[pv.pod]:.0%} < "
                       f"{self.target_attainment:.0%}" if breach
                       else f"pod {pv.pod} projected need "
                            f"{desired[pv.pod]} > {len(pv.replicas)}")
                return ScaleDecision(add=self.cfg.make_engine(),
                                     pod=pv.pod, reason=why)

        if n > self.min_replicas:
            # most idle pod first; the pod must absorb its own active
            # load with the victim gone (pod-local capacity check - the
            # routers keep pod traffic in-pod, so pool-global slack in
            # some other pod cannot absorb this pod's streams)
            for pv in sorted(pviews, key=lambda v: (v.utilization, v.pod)):
                p = pv.pod
                if now_ms - self._pod_last_in.get(p, -1e18) \
                        < self.cooldown_in_ms \
                        or now_ms - self._pod_last_out.get(p, -1e18) \
                        < self.cooldown_in_ms:
                    continue
                if len(pv.replicas) <= self.min_per_pod or pv.unlimited:
                    continue
                if pv.num_parked > 0 or att[p] < self.target_attainment:
                    continue
                want = desired[p]
                if want is not None and want >= len(pv.replicas):
                    continue
                # pod_views just captured every report at this now_ms
                # (live bus) / reads the last publish (periodic bus), so
                # the last-published store IS the victim's signal - no
                # second capture pass
                reports = [fleet.bus.reports[i] for i in pv.replicas]
                k = select_victim(self.victim, reports, pv.replicas,
                                  getattr(fleet, "ejected", ()))
                limits = [r.active_limit if r.active_limit is not None
                          else self.cfg.active_limit for r in reports]
                rest = sum(limits) - limits[k]
                if pv.num_active <= self.scale_in_util * rest:
                    self._pod_last_in[p] = now_ms
                    return ScaleDecision(
                        remove=pv.replicas[k], pod=p, victim=self.victim,
                        reason=f"pod {p} active {pv.num_active} fits "
                               f"{self.scale_in_util:g}x of remaining "
                               f"{rest} ({self.victim} victim)")
        return None


def make_autoscaler(kind, cfg, rps_per_replica=None,
                    max_replicas: int = 8,
                    victim: str = "least_outstanding",
                    pod_scoped: bool = False,
                    season_period_ms: Optional[float] = None):
    """Dispatcher for ``run_fleet``/CLI: False/None, 'queue' (or True),
    'slo', 'predictive', or an already-built callable.  ``victim``,
    ``pod_scoped``, and ``season_period_ms`` thread through to the
    ``SLOAutoscaler`` kinds (defaults reproduce the legacy policy)."""
    if kind in (False, None):
        return None
    if callable(kind):
        return kind
    if kind in (True, "queue"):
        return QueueDepthAutoscaler(cfg, max_replicas=max_replicas)
    if kind in ("slo", "predictive"):
        return SLOAutoscaler(cfg, max_replicas=max_replicas,
                             predictive=(kind == "predictive"),
                             rps_per_replica=rps_per_replica,
                             victim=victim, pod_scoped=pod_scoped,
                             season_period_ms=season_period_ms)
    raise ValueError(f"unknown autoscaler kind {kind!r}")
