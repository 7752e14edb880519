"""Serving engines with GCR admission: the port of
``repro.serving.engine``.

* ``SimServeEngine`` - virtual-time continuous batching with an explicit
  decode-step cost model, ``StepCostModel``, whose constants are one H100
  serving qwen3-0.6b (below).  It exhibits the serving-level *scalability
  collapse* the paper describes for locks: as more streams are admitted,
  resident KV exceeds the HBM budget (swap thrash) and per-step latency
  grows, so throughput fades and then falls off a cliff.  GCR admission
  (``core.admission.GCRAdmission`` / ``core.pod_aware.GCRPod``) parks
  excess streams and keeps throughput at the peak - the Figure 6
  phenomenology at the serving layer.  Everything from ``percentile`` to
  ``SimServeEngine`` is the reference's code, unchanged in behaviour
  (``tests/test_torch_sim_serving.py`` holds the two equal under the
  reference's constants).

* ``TorchServeEngine`` - drives a real model (prefill + decode_step) with
  slot management over a fixed batch; the port of ``JaxServeEngine``.

Step-cost model (per decode step over the active batch):
    t = t_fixed + t_tok * B_active
      + thrash(KV_resident / HBM budget)      [superlinear beyond 1.0]
      + t_xpod * cross_pod_mix                [GCR-POD's target]

Its defaults, for one H100 80 GB holding qwen3-0.6b whole:

* ``t_fixed_ms``, ``t_tok_ms``: intercept and slope of a least-squares
  fit of the wall time of one full-width bf16 qwen3-0.6b ``decode_step``
  against the active streams n in ``CALIBRATION_STREAMS`` (1 to 256),
  caches prefilled to 640 positions, ``max_len`` 1024
  (``python -m repro_torch.serving.calibrate``, which ``chip_smoke.py``'s
  ``sim_phase`` runs and holds these constants against).  Wall, not
  busy, time: the step a user waits for.
* ``kv_bytes_per_tok``: the bf16 K and V of one token of
  ``CALIBRATION_ARCH``, 2 x 28 layers x 8 kv heads x 128 x 2 bytes =
  114,688.
* ``hbm_budget``: 0.6 x ``H100.hbm_bytes`` = 48e9 bytes, the reference's
  0.6 KV share of one card.
* ``thrash_coef``: at load 2 with n = 256 streams (the calibration's
  largest) the thrash term ``thrash_coef * (2 - 1)**2 * n`` equals the
  time to page one budget of KV out and back in over the card's host
  link, ``2 x hbm_budget / H2D_BYTES_PER_S``; so ``thrash_coef = 2 x
  hbm_budget / H2D_BYTES_PER_S / 256`` (in ms), with the pinned
  host-to-device copy rate ``calibrate`` measures (1 GiB, median of 5).
* ``t_xpod_ms``: one step's new K and V for a full active set of 256
  streams over ``H100.network_bw`` (50 GB/s, the link between nodes):
  256 x 114,688 B / 50e9 B/s = 0.587 ms.
* ``t_prefill_ms_per_tok`` stays 0.0: the reference's opt-in switch.  The
  charge the launcher switches on with a prefix cache,
  ``PREFILL_MS_PER_TOK``, is the slope of ``calibrate``'s prefill walls
  against their prompt tokens.
"""

from __future__ import annotations

from heapq import heappop as _heappop, heappush as _heappush
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..config import H100
from ..configs import get_config
from ..core.admission import GCRAdmission, NoAdmission
from ..core.pod_aware import GCRPod
from ..models import decode_step, prefill
from ..runtime import trace

# -- the H100 constants of StepCostModel (module docstring) ------------------
# the replica they describe: one H100 serving CALIBRATION_ARCH, whose step
# ``calibrate`` times at CALIBRATION_STREAMS active streams; the derived
# terms below read the arch's shape and the largest stream count from here
CALIBRATION_ARCH = "qwen3-0.6b"
CALIBRATION_STREAMS = (1, 8, 32, 64, 128, 256)
# measured by ``python -m repro_torch.serving.calibrate`` on NVIDIA H100
# 80GB HBM3, 700.00 W (torch 2.11.0+cu128): the means of four runs, three
# in a fresh process and one inside ``chip_smoke.py``'s sim phase, whose
# decode fits read (31.45, 0.2321), (37.09, 0.2093), (38.96, 0.2009) and
# (45.36, 0.1736), whose prefill slopes read 0.005910, 0.005914, 0.005897
# and 0.005881 ms a token and whose copies read 53.29, 55.00, 53.04 and
# 49.59 GB/s; the step is host bound, and the host it shares sets its
# floor within about 20% of the mean, so the sim phase fails only when one
# of these is more than 35% off its own run's measurement
T_FIXED_MS = 38.22                # fitted intercept, ms a decode step
T_TOK_MS = 0.2040                 # fitted slope, ms a step per active stream
H2D_BYTES_PER_S = 52.73e9         # pinned host-to-device copy, 1 GiB
PREFILL_MS_PER_TOK = 0.005900     # fitted prefill slope, ms a prompt token
# derived: 2 (K, V) x layers x kv heads x head dim x 2 bytes (bf16), for
# qwen3-0.6b 2 x 28 x 8 x 128 x 2 = 114,688
_ARCH = get_config(CALIBRATION_ARCH)
KV_BYTES_PER_TOK = 2.0 * _ARCH.n_layers * _ARCH.n_kv_heads * _ARCH.d_head * 2
_N = CALIBRATION_STREAMS[-1]
THRASH_COEF = 2 * 0.6 * H100.hbm_bytes / H2D_BYTES_PER_S / _N * 1e3
T_XPOD_MS = _N * KV_BYTES_PER_TOK / H100.network_bw * 1e3

# Admissions whose tick() is exactly ``step += 1`` and which promote only
# inside release(): the whole leap-chain contract (``adm.step += k`` banks k
# ticks with no other side effect) is proven against these three concrete
# classes, so subclasses and foreign admissions fall back to per-step mode.
_LEAP_ADMISSIONS = (GCRAdmission, GCRPod, NoAdmission)


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence: the
    smallest value with at least ``q`` of the mass at or below it, i.e.
    index ``ceil(q*n) - 1`` (the epsilon guards float noise like
    0.99 * 100 -> 99.00000000000001).  Shared by the engine's ServeResult
    and the cluster telemetry so both layers report the same statistic.
    Accepts lists and numpy arrays (telemetry sorts once with numpy and
    derives every split from the one sorted array)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    idx = min(n - 1, max(0, math.ceil(q * n - 1e-9) - 1))
    return float(sorted_vals[idx])


@dataclass(slots=True)
class Request:
    rid: int
    prompt_len: int
    gen_len: int
    pod: int = 0
    arrive_ms: float = 0.0
    # session/prefix identity (cluster workloads): follow-up turns of one
    # conversation share a session_id; prefix_id names the KV-shareable
    # prefix group (== session_id for conversations, but a shared system
    # prompt could give many sessions one prefix_id); prefix_len is how
    # many of this request's prompt tokens are covered by that prefix.
    session_id: int = -1
    prefix_id: int = -1
    prefix_len: int = 0
    # runtime state
    generated: int = 0
    done_ms: float = -1.0
    first_token_ms: float = -1.0
    prefix_hit_tokens: int = 0    # prompt tokens served from a prefix cache
    replica: int = -1             # fleet replica that served this request
    # engine-internal lazy-token bookkeeping (DESIGN.md 3): while active,
    # generated == _base_gen + (engine steps - _join_step); _join_seq is
    # the active-set insertion sequence (-1 = not active), which both
    # validates finish-calendar entries and restores insertion order for
    # same-step completions
    _join_step: int = field(init=False, default=0)
    _base_gen: int = field(init=False, default=0)
    _join_seq: int = field(init=False, default=-1)

    def fresh(self) -> "Request":
        """Copy with runtime state reset, so one workload list can drive
        many engine/fleet runs without cross-contamination."""
        return Request(self.rid, self.prompt_len, self.gen_len, self.pod,
                       self.arrive_ms, self.session_id, self.prefix_id,
                       self.prefix_len)


@dataclass
class StepCostModel:
    """Decode-step latency model (ms) for one engine step; its defaults are
    one H100 serving qwen3-0.6b (module docstring)."""

    t_fixed_ms: float = T_FIXED_MS   # step floor at no streams
    t_tok_ms: float = T_TOK_MS       # per active stream
    kv_bytes_per_tok: float = KV_BYTES_PER_TOK
    # KV share of one card's HBM: the reference's 0.6 share of H100's 80 GB
    hbm_budget: float = 0.6 * H100.hbm_bytes
    thrash_coef: float = THRASH_COEF  # ms per unit oversubscription
    t_xpod_ms: float = T_XPOD_MS     # cross-pod mixing penalty (per step)
    # Prefill compute per prompt token NOT covered by a prefix-cache hit,
    # charged to the step a stream first decodes in.  0.0 by default so
    # every pre-existing seeded result stays bit-identical; the cluster
    # affinity benches opt in (prefill is what warm routing saves).
    t_prefill_ms_per_tok: float = 0.0

    def step_ms(self, n_active: int, resident_tokens: int,
                pod_mix: float, prefill_tokens: int = 0) -> float:
        t = self.t_fixed_ms + self.t_tok_ms * n_active
        load = resident_tokens * self.kv_bytes_per_tok / self.hbm_budget
        if load > 1.0:
            # beyond-HBM: swapping KV pages in/out each step (superlinear)
            t += self.thrash_coef * (load - 1.0) ** 2 * max(1, n_active)
        t += self.t_xpod_ms * pod_mix
        t += self.t_prefill_ms_per_tok * prefill_tokens
        return t


class PrefixCache:
    """Bounded LRU model of a replica's cached prefix KV blocks.

    Entries are keyed by ``prefix_id`` and valued in *tokens* of prefix
    KV resident on the replica.  A hit discounts the prefill charge of a
    newly admitted stream (``StepCostModel.t_prefill_ms_per_tok``); the
    decode-resident KV itself is unchanged - blocks must exist either
    way, a hit only skips recomputing them.  This is the L2 analogue of
    GCR-NUMA's warm-socket preference: the session whose prefix is
    cached here is the waiter whose lock state is already warm on this
    socket.  Completed requests insert their full history (prompt +
    generated), which is exactly the next turn's shareable prefix;
    eviction is LRU over prefix groups, so an un-followed conversation
    ages out.
    """

    def __init__(self, capacity_tokens: int) -> None:
        if capacity_tokens <= 0:
            raise ValueError("capacity_tokens must be > 0")
        self.capacity_tokens = capacity_tokens
        self._entries: "OrderedDict[int, int]" = OrderedDict()
        self.tokens = 0               # current occupancy
        self.hit_tokens = 0           # cumulative tokens served from cache
        self.query_tokens = 0         # cumulative prefix tokens looked up
        self.evicted_tokens = 0       # cumulative tokens evicted

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prefix_id: int, want_tokens: int) -> int:
        """Tokens of ``prefix_id`` resident (capped at ``want_tokens``);
        touches the entry's LRU position."""
        if want_tokens <= 0:
            return 0
        self.query_tokens += want_tokens
        cached = self._entries.get(prefix_id)
        if cached is None:
            return 0
        self._entries.move_to_end(prefix_id)
        hit = min(cached, want_tokens)
        self.hit_tokens += hit
        return hit

    def insert(self, prefix_id: int, tokens: int) -> None:
        """Grow ``prefix_id``'s entry to ``tokens`` (entries never shrink
        short of eviction), evicting LRU entries to stay under capacity."""
        if tokens <= 0:
            return
        old = self._entries.pop(prefix_id, 0)
        self.tokens -= old
        keep = max(old, min(tokens, self.capacity_tokens))
        while self.tokens + keep > self.capacity_tokens and self._entries:
            _, ev = self._entries.popitem(last=False)
            self.tokens -= ev
            self.evicted_tokens += ev
        self._entries[prefix_id] = keep
        self.tokens += keep

    def clear(self) -> None:
        """Drop every entry (a crash takes the replica's warm KV with
        it).  Cumulative hit/query counters survive - they describe
        served history, not contents - and the dropped tokens count as
        evicted, so fleet-wide churn telemetry sees the loss."""
        self.evicted_tokens += self.tokens
        self._entries.clear()
        self.tokens = 0


@dataclass
class ServeResult:
    completed: int
    sim_ms: float
    token_throughput: float          # tokens/s
    request_throughput: float        # requests/s
    p50_latency_ms: float
    p99_latency_ms: float
    mean_ttft_ms: float
    unfairness: float                # paper Section 6.1 metric over streams
    stats: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        return (f"done={self.completed} tok/s={self.token_throughput:,.0f} "
                f"p50={self.p50_latency_ms:.0f}ms p99={self.p99_latency_ms:.0f}ms "
                f"ttft={self.mean_ttft_ms:.0f}ms unfair={self.unfairness:.2f}")


class SimServeEngine:
    """Virtual-time continuous batching with pluggable admission.

    Two ways to drive it:

    * ``run(requests)`` - self-clocked: the engine owns virtual time and
      processes arrivals/steps to completion (the single-replica benches).
    * ``submit()`` / ``step(now)`` - externally clocked: a shared event loop
      (``cluster.fleet.Fleet``) injects arrivals and asks for one decode
      step at a time, so N replicas advance on one clock.

    **Incremental accounting (DESIGN.md 3).**  Per-step observables are
    maintained as integer counters updated O(1) at the membership events
    (submit/admit/demote/finish) instead of O(active) rescans per step:

    * ``_resident``   - sum of ``prompt_len + generated`` over the active
      set (token counts are ints, so the incremental sum is *exact* and
      seeded traces stay bit-identical with the rescanning core);
    * ``_pod_count``  - active streams per pod (the cross-pod mix);
    * ``_pending_prefill`` - streams admitted but not yet decoded, in
      active-set insertion order (the order prefill charges and prefix
      cache inserts must be applied in);
    * per-stream token counts are *lazy*: a stream that joined the active
      set at step ``j`` with ``base`` tokens has ``base + (nsteps - j)``
      tokens after step ``nsteps``, so the per-step token loop is gone -
      completions are detected by a (finish_step, join_seq, rid) heap and
      materialized only at membership boundaries.  ``join_seq`` ties
      same-step completions back to active-dict insertion order, so the
      completion order (and with it LRU cache behavior and telemetry) is
      bit-identical to the per-stream rescan.
    """

    __slots__ = ("admission", "cost", "avg_prompt", "prefix_cache",
                 "requests", "active", "completed", "tokens_out",
                 "_resident", "_nsteps", "_join_seq", "_pod_count",
                 "_pending_prefill", "_finish_heap", "_is_pod_adm",
                 "_has_cancel", "_reports_demoted", "peak_active",
                 "peak_parked", "obs", "leap_stepping", "_leap",
                 "_leap_ok")

    def __init__(self, admission, cost: Optional[StepCostModel] = None,
                 avg_prompt: int = 512,
                 prefix_cache: Optional[PrefixCache] = None,
                 leap_stepping: bool = True):
        self.admission = admission
        self.cost = cost or StepCostModel()
        self.avg_prompt = avg_prompt
        self.prefix_cache = prefix_cache
        self.requests: Dict[int, Request] = {}
        self.active: Dict[int, Request] = {}
        self.completed: List[Request] = []
        self.tokens_out = 0
        # engine-side span hook (cluster.obs._EngineObs), installed by an
        # Observability bundle; None is the zero-overhead default - the
        # three step() hook sites guard on it and emit nothing
        self.obs = None
        # steady-state leap stepping (DESIGN.md 3): when the active set is
        # unchanged between events and resident KV sits below the HBM
        # knee, step_ms is constant, so step_leap() banks N identical
        # steps in one call.  The leaped clock is produced by the same
        # chained float additions the per-step loop would execute, so
        # traces stay bit-identical; False forces per-step iteration
        self.leap_stepping = leap_stepping
        # gate terms that never change after construction, folded to one
        # flag off the per-boundary path (obs stays a dynamic check: the
        # observability bundle installs engine hooks per run)
        self._leap_ok = (leap_stepping
                         and type(self) is SimServeEngine
                         and type(admission) in _LEAP_ADMISSIONS)
        self._reset_accounting()

    # -- incremental accounting ----------------------------------------------
    def _reset_accounting(self) -> None:
        self._resident = 0            # sum(prompt+generated) over active
        self._nsteps = 0              # completed decode steps
        self._join_seq = 0            # monotone active-set insertion counter
        self._pod_count: Dict[int, int] = {}
        self._pending_prefill: Dict[int, Request] = {}
        self._finish_heap: List[tuple] = []
        # active leap chain metadata: (first_boundary, chain_dt, n_chained,
        # n_active) while a banked chain is in flight, else None (the fleet
        # truncates against this when an arrival lands mid-chain)
        self._leap = None
        self._is_pod_adm = isinstance(self.admission, GCRPod)
        self._has_cancel = hasattr(self.admission, "cancel")
        self._reports_demoted = hasattr(self.admission, "last_demoted")
        # peak occupancy, tracked at the submit outcome and at step end -
        # the exact points the fleet telemetry used to sample, so the
        # reported peaks are unchanged while the per-event sampling cost
        # is gone (cluster.telemetry reads these at finalize)
        self.peak_active = 0
        self.peak_parked = 0

    def _activate(self, r: Request) -> None:
        """Stream enters the active set (fresh admit or re-promotion)."""
        rid = r.rid
        gen = r.generated
        nsteps = self._nsteps
        self.active[rid] = r
        seq = self._join_seq
        self._join_seq = seq + 1
        r._join_step = nsteps
        r._base_gen = gen
        r._join_seq = seq
        self._resident += r.prompt_len + gen
        pod = r.pod
        pods = self._pod_count
        pods[pod] = pods.get(pod, 0) + 1
        _heappush(self._finish_heap,
                  (nsteps + r.gen_len - gen, seq, rid))
        if r.first_token_ms < 0:
            # insertion position must track the active dict's (a demoted
            # stream re-joins at the end, so pop before re-inserting)
            self._pending_prefill.pop(rid, None)
            self._pending_prefill[rid] = r

    def _deactivate(self, rid: int) -> Request:
        """Stream leaves the active set; materializes its lazy token count
        (exact: one token per step since it joined)."""
        r = self.active.pop(rid)
        r.generated = r._base_gen + (self._nsteps - r._join_step)
        r._join_seq = -1
        self._resident -= r.prompt_len + r.generated
        c = self._pod_count[r.pod] - 1
        if c:
            self._pod_count[r.pod] = c
        else:
            del self._pod_count[r.pod]
        self._pending_prefill.pop(rid, None)
        return r

    def _materialize_active(self) -> None:
        """Write every active stream's exact token count back onto the
        request (telemetry/inspection sync point); keeps the lazy
        bookkeeping consistent so stepping can continue afterwards."""
        nsteps = self._nsteps
        for r in self.active.values():
            r.generated = r._base_gen + (nsteps - r._join_step)
            r._join_step = nsteps
            r._base_gen = r.generated

    # -- steppable API (shared by run() and the cluster fleet loop) ----------
    def submit(self, r: Request) -> bool:
        """Register an arriving request.  True => admitted to the batch now;
        False => parked in the admission's passive queue."""
        self.requests[r.rid] = r
        if r.first_token_ms < 0:
            # not yet prefilled anywhere (covers migrated parked streams,
            # which re-probe the *new* replica's cache): pin whatever slice
            # of the prefix is warm here; already-prefilled migrants keep
            # their hit stats - their prefill was paid on the old replica
            r.prefix_hit_tokens = (
                self.prefix_cache.lookup(r.prefix_id, r.prefix_len)
                if self.prefix_cache is not None and r.prefix_id >= 0
                else 0)
        if self.admission.offer(r.rid, r.pod):
            self._activate(r)
            n = len(self.active)
            if n > self.peak_active:
                self.peak_active = n
            return True
        p = self.admission.num_parked
        if p > self.peak_parked:
            self.peak_parked = p
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.active)

    @property
    def outstanding(self) -> int:
        """Streams on this replica that have not finished (active + parked)."""
        return len(self.active) + self.admission.num_parked

    def occupancy(self) -> Dict[str, Optional[int]]:
        """Cheap occupancy/progress counters for the cluster metrics bus
        (``cluster.signals``).  This is what the replica *publishes*; a
        router reading a stale copy of it is the modeled reality."""
        pc = self.prefix_cache
        return {
            "num_active": len(self.active),
            "num_parked": self.admission.num_parked,
            "active_limit": getattr(self.admission, "active_limit", None),
            "outstanding": self.outstanding,
            "tokens_out": self.tokens_out,
            "completed": len(self.completed),
            "cache_tokens": pc.tokens if pc else 0,
            "cache_hit_tokens": pc.hit_tokens if pc else 0,
            "cache_query_tokens": pc.query_tokens if pc else 0,
            # eviction pressure: cumulative warm tokens this replica has
            # churned out - published for cache-health telemetry (victim
            # selection today reads only cache_tokens occupancy)
            "cache_evicted_tokens": pc.evicted_tokens if pc else 0,
        }

    def drain(self) -> tuple:
        """Evacuate every unfinished stream (fleet scale-in): returns
        ``(active_moved, parked_moved)`` and leaves the engine empty of
        live work.  Finished requests and token counts stay behind for
        telemetry.  Active streams carry resident KV (the migration cost
        the fleet charges); parked streams hold none."""
        active_moved: List[Request] = []
        parked_moved: List[Request] = []
        for r in self.requests.values():
            if r.done_ms >= 0:
                continue
            (active_moved if r.rid in self.active else parked_moved).append(r)
        for r in active_moved + parked_moved:
            del self.requests[r.rid]
            if r.first_token_ms < 0 and self.prefix_cache is not None \
                    and r.prefix_id >= 0 and r.prefix_len > 0:
                # the stream never prefilled here, so its probe moves with
                # it (it will re-probe the destination at re-submit) -
                # refund this cache's stats or the fleet-wide hit rate
                # would double-count the query's denominator
                self.prefix_cache.query_tokens -= r.prefix_len
                self.prefix_cache.hit_tokens -= r.prefix_hit_tokens
        # materialize departing streams' exact token counts (the migration
        # cost is billed on resident KV) and zero the active-set counters
        for rid in list(self.active):
            self._deactivate(rid)
        self._finish_heap.clear()
        self._leap = None
        self.admission.drain()
        return active_moved, parked_moved

    def cancel(self, rid: int, now: float = 0.0) -> bool:
        """Withdraw an unfinished stream (fleet hedging: the twin that
        lost the race).  Returns False if the stream is unknown here or
        its completion is already banked - a banked effect is committed
        and cancellation never rolls it back.  An active stream's slot
        is released through the admission exactly like a completion
        (promotions and demotions included), so occupancy accounting
        cannot drift; a parked stream is withdrawn from the passive
        queue.  Tokens decoded so far stay billed - the work happened.
        """
        r = self.requests.get(rid)
        if r is None or r.done_ms >= 0:
            return False
        adm = self.admission
        obs = self.obs
        if rid in self.active:
            self._deactivate(rid)
            del self.requests[rid]
            for new_rid in adm.release(rid):
                if new_rid in self.requests and new_rid not in self.active \
                        and self.requests[new_rid].done_ms < 0:
                    self._activate(self.requests[new_rid])
                    if obs is not None:
                        obs.on_unpark(new_rid, now)
            if self._reports_demoted:
                for rid2 in adm.last_demoted:
                    if rid2 in self.active:
                        self._deactivate(rid2)
                        if obs is not None:
                            obs.on_demote(rid2, now)
            else:
                for rid2 in list(self.active.keys()):
                    if rid2 not in getattr(adm, "active", {rid2: None}):
                        self._deactivate(rid2)
                        if obs is not None:
                            obs.on_demote(rid2, now)
        else:
            del self.requests[rid]
            if self._has_cancel:
                adm.cancel(rid)
        if r.first_token_ms < 0 and self.prefix_cache is not None \
                and r.prefix_id >= 0 and r.prefix_len > 0:
            # never prefilled here: refund the probe, as drain() does
            self.prefix_cache.query_tokens -= r.prefix_len
            self.prefix_cache.hit_tokens -= r.prefix_hit_tokens
        return True

    def step(self, now: float) -> tuple:
        """One decode step over the active batch, starting at virtual time
        ``now``.  Returns ``(dt_ms, finished_requests)``; finished requests
        carry ``done_ms = now + dt``.  Idle engine => ``(0.0, [])``.

        Streams submitted while a step is in flight (fleet mode) join
        ``self.active`` immediately but only decode from the next step."""
        adm = self.admission
        active = self.active
        obs = self.obs
        if not active:
            return 0.0, []
        n_entry = len(active)
        resident = self._resident       # == sum(prompt+generated), exact
        if self._is_pod_adm:
            pod_mix = adm.active_pod_mix()
        elif len(self._pod_count) == 1:
            pod_mix = 0.0               # pod-pure active set, exact
        else:
            pod_mix = 1.0 - max(self._pod_count.values()) / n_entry
        # streams entering their first step prefill now; prefix-cache hits
        # (r.prefix_hit_tokens, pinned at submit) are blocks already warm
        # on this replica and are not recomputed
        prefill = 0
        pc = self.prefix_cache
        pending = self._pending_prefill
        if pending:
            for r in pending.values():
                uncached = r.prompt_len - r.prefix_hit_tokens
                if uncached > 0:
                    prefill += uncached
                if pc is not None and r.prefix_id >= 0:
                    # after prefill the prompt KV blocks exist on this
                    # replica, so a follow-up turn arriving mid-decode can
                    # already hit them (completion later extends the entry
                    # over the generated tokens)
                    pc.insert(r.prefix_id, r.prompt_len)
        # StepCostModel.step_ms, inlined term-for-term (identical float
        # evaluation order): this is the innermost line of every bench
        cost = self.cost
        dt = cost.t_fixed_ms + cost.t_tok_ms * n_entry
        load = resident * cost.kv_bytes_per_tok / cost.hbm_budget
        if load > 1.0:
            dt += cost.thrash_coef * (load - 1.0) ** 2 * max(1, n_entry)
        dt += cost.t_xpod_ms * pod_mix
        if prefill:
            dt += cost.t_prefill_ms_per_tok * prefill
        end = now + dt
        adm.tick()

        # every stream active at step entry decodes one token: O(1) counter
        # bumps; per-stream counts stay lazy until a membership boundary
        self._nsteps += 1
        cur = self._nsteps
        self.tokens_out += n_entry
        self._resident += n_entry
        if pending:
            for r in pending.values():
                r.first_token_ms = end
            if obs is not None:
                obs.on_first_tokens(pending, end)
            pending.clear()

        # completions: drain the finish calendar up to this step, drop
        # stale entries (demoted/re-joined streams), and restore active-set
        # insertion order via the join sequence numbers
        finish_heap = self._finish_heap
        if not finish_heap or finish_heap[0][0] > cur:
            return dt, []
        requests = self.requests
        finished: List[tuple] = []
        while finish_heap and finish_heap[0][0] <= cur:
            _fs, seq, rid = _heappop(finish_heap)
            # .get: a cancelled stream (fleet hedging) leaves its
            # calendar entry behind; a live entry still validates by
            # join sequence exactly as before
            r = requests.get(rid)
            if r is not None and r._join_seq == seq:
                finished.append((seq, rid))
        if not finished:
            return dt, []
        finished.sort()
        # stamp completions before any release processing: an admission may
        # try to re-admit a just-finished (demoted) stream, and the guard
        # below reads done_ms
        for _seq, rid in finished:
            requests[rid].done_ms = end
        done: List[Request] = []
        reports_demoted = self._reports_demoted
        for _seq, rid in finished:
            if rid in active:
                done.append(self._deactivate(rid))
            else:                   # demoted after finishing: un-park it
                done.append(requests[rid])
                if self._has_cancel:
                    adm.cancel(rid)
            for new_rid in adm.release(rid):
                # promoted/work-conserved admissions (may demote someone)
                if new_rid in requests and new_rid not in active and \
                        requests[new_rid].done_ms < 0:
                    self._activate(requests[new_rid])
                    if obs is not None:
                        obs.on_unpark(new_rid, end)
            # demotions: active streams the admission evicted during this
            # release (reported O(1); generic admissions fall back to the
            # legacy scan)
            if reports_demoted:
                for rid2 in adm.last_demoted:
                    if rid2 in active:
                        self._deactivate(rid2)
                        if obs is not None:
                            obs.on_demote(rid2, end)
            else:
                for rid2 in list(active.keys()):
                    if rid2 not in getattr(adm, "active", {rid2: None}):
                        self._deactivate(rid2)
                        if obs is not None:
                            obs.on_demote(rid2, end)
        if pc is not None:
            for r in done:
                if r.prefix_id >= 0:
                    # the finished turn's full history is exactly the next
                    # turn's shareable prefix
                    pc.insert(r.prefix_id, r.prompt_len + r.generated)
        self.completed.extend(done)
        # post-completion occupancy peaks (work-conserve refills the active
        # set and demotions grow the queue mid-step; this is the legacy
        # post-step sampling point)
        n = len(active)
        if n > self.peak_active:
            self.peak_active = n
        p = adm.num_parked
        if p > self.peak_parked:
            self.peak_parked = p
        return dt, done

    # -- steady-state leap stepping (DESIGN.md 3) ---------------------------
    def step_leap(self, now: float, bank_lt: float = math.inf,
                  bank_le: float = math.inf,
                  end_le: float = math.inf,
                  max_bank: int = 0) -> tuple:
        """One decode step, then bank as many *identical* follow-up steps
        as provably nothing can observe.  Returns ``(end_ms, finished,
        n_steps)``: ``end_ms`` is the boundary the next step event belongs
        at and ``n_steps`` counts decode steps banked (>= 1; the caller's
        event accounting owes ``n_steps - 1`` extra events).

        A follow-up step is identical to its predecessor when the active
        set is unchanged (no completion due, no arrival or admin event
        yet) and resident KV stays at or below the HBM-thrash knee: every
        term of the step cost is then a function of unchanged state, so
        ``dt`` is literally the same float.  The chain clock is produced
        by the same repeated ``b += dt`` additions the per-step loop
        would execute - never ``t0 + k*dt``, whose single rounding differs
        from k chained roundings - so leaped boundaries are bit-identical
        to per-step iteration.

        Bounds: a step *starting* at boundary ``b`` is banked only while
        ``b < bank_lt`` (strict: an arrival at ``b`` wins the time tie
        and must observe pre-step counters) and ``b <= bank_le`` (the
        fleet still processes events landing exactly at ``max_ms``); a
        step *ending* at ``e`` is banked only while ``e <= end_le`` (the
        caller's admin-event horizon; end-equality is safe because the
        admin event was pushed earlier, holds the smaller heap sequence,
        and therefore pops before the boundary's step event in the
        per-step world too - after every chained step is already banked).

        ``max_bank`` > 0 caps the number of banked follow-ups.  Shorter
        chains are invisible (banked steps are bit-identical whether they
        ride one chain or several), so any cap value preserves
        bit-identity; the fleet uses it to keep rollback work bounded on
        replicas whose cost is about to change (limplock windows).
        """
        dt, done = self.step(now)
        self._leap = None
        end = now + dt
        if dt <= 0.0 or done or not self._leap_ok or self.obs is not None:
            return end, done, 1
        # completion bound: the earliest finish-calendar entry fires on the
        # step that reaches its finish step, so at most k further steps are
        # completion-free; stale entries (demoted streams) only stop the
        # chain early, never late
        fh = self._finish_heap
        if not fh:
            return end, done, 1
        k = fh[0][0] - self._nsteps - 1
        if k <= 0:
            return end, done, 1
        if 0 < max_bank < k:
            k = max_bank
        active = self.active
        n = len(active)
        cost = self.cost
        adm = self.admission
        # chain step cost, term-for-term the floats step() would produce:
        # no prefill (pending cleared by the step above), no thrash (knee
        # bound below), pod mix frozen with the membership
        if self._is_pod_adm:
            pod_mix = adm.active_pod_mix()
        elif len(self._pod_count) == 1:
            pod_mix = 0.0
        else:
            pod_mix = 1.0 - max(self._pod_count.values()) / n
        dtc = cost.t_fixed_ms + cost.t_tok_ms * n
        dtc += cost.t_xpod_ms * pod_mix
        # HBM knee: banked step m enters with resident R + (m-1)*n tokens
        # (integer-exact), and step() charges thrash strictly above load
        # 1.0, so the chain must satisfy (R + (c-1)*n)*kvb/hbm <= 1.0 -
        # monotone in c, so the largest admissible c binary-searches
        R = self._resident
        kvb = cost.kv_bytes_per_tok
        hb = cost.hbm_budget
        if R * kvb / hb > 1.0:
            return end, done, 1
        if (R + (k - 1) * n) * kvb / hb > 1.0:
            lo, hi = 1, k               # knee holds at lo, fails at hi
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if (R + (mid - 1) * n) * kvb / hb > 1.0:
                    hi = mid
                else:
                    lo = mid
            k = lo
        b = end
        cnt = 0
        while cnt < k and b < bank_lt and b <= bank_le:
            e2 = b + dtc
            if e2 > end_le:
                break
            b = e2
            cnt += 1
        if cnt == 0:
            return end, done, 1
        # bank the chain: every counter a later observer reads moves by
        # exactly what cnt per-step calls would have applied (tick() is
        # step += 1 for every admission the gate above admits; membership,
        # peaks, prefill and completions are all provably untouched)
        self._nsteps += cnt
        adm.step += cnt
        self.tokens_out += cnt * n
        self._resident += cnt * n
        self._leap = (end, dtc, cnt, n)
        return b, done, 1 + cnt

    def leap_truncate(self, ta: float) -> tuple:
        """Roll back the banked steps of the in-flight leap chain that a
        per-step loop would not yet have executed at time ``ta`` (an
        arrival or migrate submit landing mid-chain).  A chained step is
        kept iff its bank point - the boundary whose step event the
        per-step loop would have popped - is strictly before ``ta``
        (arrivals win time ties, so a step banked exactly at ``ta`` has
        not happened yet).  Returns ``(boundary_ms, n_rolled_back)``
        where ``boundary_ms`` is where the replica's next step event now
        belongs; ``(inf, 0)`` if no chain is in flight.  The rollback is
        integer-exact: chained steps changed nothing but the four
        counters re-adjusted here."""
        leap = self._leap
        if leap is None:
            return math.inf, 0
        e, dtc, cnt, n = leap
        j = 0
        while j < cnt and e < ta:
            e += dtc
            j += 1
        u = cnt - j
        if u:
            self._nsteps -= u
            self.admission.step -= u
            self.tokens_out -= u * n
            self._resident -= u * n
        self._leap = None
        return e, u

    def leap_submit(self, r: Request, ta: float) -> tuple:
        """Submit an arrival landing mid-chain, keeping the chain alive
        when the request merely parks.

        The submit must see exactly the counters a per-step loop would
        hold at ``ta``, so the not-yet-due banked tail (same strict-<
        walk as ``leap_truncate``) is rewound first.  If the admission
        parks the request the active set - and with it every future
        boundary and every banked effect - is untouched, so the tail is
        re-banked and the chain survives; only an *activation* (membership
        change => the next step's cost changes) truncates for real.

        Returns ``(boundary_ms, n_rolled_back, admitted)``: rolled-back
        > 0 means the caller owes the same event/sequence refunds as
        after ``leap_truncate``; 0 with ``admitted=False`` means the
        chain (and the caller's pending boundary) is intact."""
        e, dtc, cnt, n = self._leap
        j = 0
        while j < cnt and e < ta:
            e += dtc
            j += 1
        u = cnt - j
        adm = self.admission
        if u:
            self._nsteps -= u
            adm.step -= u
            self.tokens_out -= u * n
            self._resident -= u * n
        if not self.submit(r):
            if u:                       # parked: re-bank the tail
                self._nsteps += u
                adm.step += u
                self.tokens_out += u * n
                self._resident += u * n
            return e, 0, False
        self._leap = None
        return e, u, True

    # -- self-clocked driver -------------------------------------------------
    def run(self, requests: List[Request], max_ms: float = 60_000.0
            ) -> ServeResult:
        self.requests.clear()
        self.active.clear()
        self.completed.clear()
        self.tokens_out = 0
        self._reset_accounting()
        adm = self.admission
        now = 0.0
        pending = sorted(requests, key=lambda r: (r.arrive_ms, r.rid))
        pi = 0
        n_pending = len(pending)
        # self-clocked leaping: between arrivals nothing external can
        # observe the engine, so a chain may bank straight to the next
        # arrival (strict: the loop admits arrive_ms <= now before
        # stepping, so a step starting at the arrival's time runs with
        # changed membership) or to max_ms (strict: the while condition)
        leap = self._leap_ok and self.obs is None

        while now < max_ms:
            # arrivals
            while pi < n_pending and pending[pi].arrive_ms <= now:
                self.submit(pending[pi])
                pi += 1
            if not self.active and pi >= n_pending and not adm.num_parked:
                break
            if not self.active:
                # idle until next arrival
                if pi < n_pending:
                    now = max(now, pending[pi].arrive_ms)
                    continue
                break
            if leap:
                nxt = pending[pi].arrive_ms if pi < n_pending else math.inf
                now, _, _ = self.step_leap(
                    now, bank_lt=nxt if nxt < max_ms else max_ms)
            else:
                dt, _ = self.step(now)
                now += dt

        return self._result(now)

    def _result(self, now: float) -> ServeResult:
        adm = self.admission
        self._materialize_active()      # per-stream counts for unfairness
        completed = self.completed
        lat = sorted((r.done_ms - r.arrive_ms) for r in completed) or [0.0]
        ttft = [r.first_token_ms - r.arrive_ms for r in completed
                if r.first_token_ms >= 0] or [0.0]
        per_stream = sorted(r.generated for r in self.requests.values())
        half = len(per_stream) // 2
        unfair = (sum(per_stream[half:]) / max(1, sum(per_stream))
                  if per_stream else 0.5)
        dur_s = max(now, 1e-9) / 1e3
        return ServeResult(
            completed=len(completed),
            sim_ms=now,
            token_throughput=self.tokens_out / dur_s,
            request_throughput=len(completed) / dur_s,
            p50_latency_ms=percentile(lat, 0.50),
            p99_latency_ms=percentile(lat, 0.99),
            mean_ttft_ms=float(np.mean(ttft)),
            unfairness=unfair,
            stats={
                "promotions": getattr(adm, "stat_promotions", 0),
                "demotions": getattr(adm, "stat_demotions", 0),
                "parked_end": adm.num_parked,
            },
        )


def make_admission(kind: str, active_limit: int, n_pods: int = 2,
                   promote_every: int = 64):
    if kind == "none":
        return NoAdmission()
    if kind == "gcr":
        return GCRAdmission(active_limit, promote_every)
    if kind == "gcr_pod":
        return GCRPod(active_limit, n_pods, promote_every)
    raise ValueError(f"unknown admission kind {kind!r}")


class TorchServeEngine:
    """Batched decode over a real model with fixed slots + GCR admission.

    The batch has ``n_slots`` lanes; admitted streams occupy lanes, parked
    streams wait in the GCR queue.  ``params`` must live on ``device``
    (default ``cuda``)."""

    def __init__(self, cfg, params, n_slots: int, max_len: int,
                 admission_kind: str = "gcr", promote_every: int = 16,
                 device=None) -> None:
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.admission = make_admission(admission_kind, n_slots,
                                        promote_every=promote_every)
        self._decode = lambda p, c, t: decode_step(cfg, p, c, t)
        self._prefill = lambda p, b: prefill(cfg, p, b, max_len=max_len)

    @staticmethod
    def _greedy(logits: torch.Tensor) -> torch.Tensor:
        return logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        """prompts: (n_streams, prompt_len) int32.  Greedy decode; streams
        beyond the active limit are parked and admitted as slots free.

        Under a recording profiler the call is the span
        ``repro_torch.engine.generate``, each prefill and decode call a
        ``repro_torch.engine.prefill`` / ``.decode`` span inside it, each
        admitted stream a ``repro_torch.admission.admit`` instant, and the
        counters of ``runtime.trace`` are reset at entry."""
        if trace.recording():
            trace.reset()
        with trace.span("repro_torch.engine.generate"):
            return self._generate(prompts, gen_len)

    def _generate(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        n = prompts.shape[0]
        out = np.zeros((n, gen_len), np.int32)
        waiting = list(range(n))
        active: List[int] = []
        progress = {i: 0 for i in range(n)}

        while waiting or active:
            # admission
            newly = []
            while waiting:
                sid = waiting[0]
                if self.admission.offer(sid):
                    trace.instant("repro_torch.admission.admit")
                    newly.append(sid)
                    waiting.pop(0)
                else:
                    break  # queue is FIFO; head parked => all parked
            active.extend(newly)
            if not active:
                break
            # (re)prefill the active batch
            batch = {"tokens": torch.as_tensor(prompts[active],
                                               device=self.device)}
            with trace.span("repro_torch.engine.prefill"):
                logits, cache = self._prefill(self.params, batch)
            tok = self._greedy(logits)
            for _ in range(gen_len):
                tok_host = tok.cpu().numpy()
                for j, sid in enumerate(active):
                    if progress[sid] < gen_len:
                        out[sid, progress[sid]] = tok_host[j, 0]
                        progress[sid] += 1
                with trace.span("repro_torch.engine.decode"):
                    logits, cache = self._decode(self.params, cache, tok)
                tok = self._greedy(logits)
            done = [sid for sid in active if progress[sid] >= gen_len]
            for sid in done:
                self.admission.release(sid)
            active = [sid for sid in active if progress[sid] < gen_len]
        return out
