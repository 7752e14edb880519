"""Open-loop arrival generation for the fleet simulator (DESIGN.md L2).

The port's own copy of ``repro.cluster.workload``, unchanged in
behaviour: the port imports nothing of ``repro``.

Closed-loop workloads - a fixed population of streams whose next request
waits for the previous one - self-throttle as latency grows, which *hides*
scalability collapse: the offered load falls exactly when the system is
drowning.  The USL-style collapse sweep needs offered load to be an
independent variable, so the cluster subsystem drives replicas with
**open-loop** arrival processes (arrivals do not care how the fleet is
doing):

* ``poisson``  - homogeneous Poisson at a target RPS;
* ``bursty``   - two-state Markov-modulated Poisson (calm/burst), mean
  rate held at the target RPS - the flash-crowd shape that defeats
  averaged-occupancy routing;
* ``diurnal``  - sinusoidal ramp-up/ramp-down over the window (thinned
  Poisson), the daily traffic curve an autoscaler must track;
* ``sessions`` - multi-turn conversations: session starts are Poisson,
  each session runs several turns separated by exponential think time,
  and every follow-up turn's prompt carries the full conversation
  history as a KV-shareable prefix (``Request.session_id`` /
  ``prefix_id`` / ``prefix_len``) - the workload where routing a turn
  away from its warm replica costs real prefill;
* ``replay``   - seeded trace replay from explicit rows (``to_trace``
  round-trips any generated workload, sessions included);
* ``uniform``  - the legacy serving-bench shape (uniform arrivals in a
  window), kept for the single-replica benches.

All generators are exactly deterministic under a fixed seed.  Sessions
stay **open-loop**: every turn's arrival time is drawn up front, so a
drowning fleet still receives the follow-up turns on schedule (a real
user re-prompts whether or not the previous answer was fast).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..serving.engine import Request

WORKLOADS = ("poisson", "bursty", "diurnal", "sessions", "uniform")


@dataclass(frozen=True)
class WorkloadSpec:
    """Per-request shape distribution (lengths in tokens)."""

    prompt_range: Tuple[int, int] = (256, 1024)
    gen_range: Tuple[int, int] = (64, 256)
    n_pods: int = 2

    @property
    def mean_prompt(self) -> float:
        return 0.5 * (self.prompt_range[0] + self.prompt_range[1])

    @property
    def mean_gen(self) -> float:
        return 0.5 * (self.gen_range[0] + self.gen_range[1])

    @property
    def mean_resident(self) -> float:
        """Mean KV-resident tokens of an in-flight request (full prompt +
        half the generation) - the footprint capacity math keys off."""
        return self.mean_prompt + self.mean_gen / 2


DEFAULT_SPEC = WorkloadSpec()


def _materialize(arrive_ms: Sequence[float], spec: WorkloadSpec,
                 rng: np.random.Generator, start_rid: int = 0
                 ) -> List[Request]:
    """Attach prompt/gen lengths and a pod to each arrival time.

    Pods are *drawn*, not assigned round-robin: a deterministic
    ``rid % n_pods`` pattern happens to agree with round-robin routing
    (request k -> replica k % n), which would hand the occupancy-blind
    baseline accidental pod purity."""
    out = []
    for i, t in enumerate(arrive_ms):
        rid = start_rid + i
        out.append(Request(
            rid=rid,
            prompt_len=int(rng.integers(*spec.prompt_range)),
            gen_len=int(rng.integers(*spec.gen_range)),
            pod=int(rng.integers(0, spec.n_pods)),
            arrive_ms=float(t)))
    return out


def poisson(rps: float, duration_ms: float, spec: WorkloadSpec = DEFAULT_SPEC,
            seed: int = 0, start_rid: int = 0) -> List[Request]:
    """Homogeneous Poisson arrivals at ``rps`` over ``duration_ms``."""
    if rps <= 0:
        return []
    rng = np.random.default_rng(seed)
    rate_per_ms = rps / 1e3
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_per_ms)
        if t >= duration_ms:
            break
        times.append(t)
    return _materialize(times, spec, rng, start_rid)


def bursty(rps: float, duration_ms: float, spec: WorkloadSpec = DEFAULT_SPEC,
           seed: int = 0, burst_factor: float = 4.0,
           dwell_ms: Tuple[float, float] = (2000.0, 500.0),
           start_rid: int = 0) -> List[Request]:
    """Two-state Markov-modulated Poisson process (calm <-> burst).

    State dwell times are exponential with means ``dwell_ms``; the burst
    state arrives ``burst_factor`` x faster than the calm state, with the
    calm rate solved so the *time-averaged* rate equals ``rps`` - sweeps
    stay comparable with ``poisson`` at the same nominal load.
    """
    if rps <= 0:
        return []
    rng = np.random.default_rng(seed)
    d0, d1 = dwell_ms
    # stationary occupancy of each state is proportional to its mean dwell
    pi1 = d1 / (d0 + d1)
    calm = rps / (1.0 - pi1 + pi1 * burst_factor)
    rates_per_ms = (calm / 1e3, calm * burst_factor / 1e3)
    times: List[float] = []
    t, state = 0.0, 0
    state_end = rng.exponential(d0)
    while t < duration_ms:
        gap = rng.exponential(1.0 / rates_per_ms[state])
        if t + gap >= state_end:
            # advance to the state boundary, switch, and redraw there
            t = state_end
            state = 1 - state
            state_end = t + rng.exponential(dwell_ms[state])
            continue
        t += gap
        if t < duration_ms:
            times.append(t)
    return _materialize(times, spec, rng, start_rid)


def diurnal(rps_peak: float, duration_ms: float,
            spec: WorkloadSpec = DEFAULT_SPEC, seed: int = 0,
            floor: float = 0.1, start_rid: int = 0,
            cycles: int = 1, phase: float = 0.0) -> List[Request]:
    """Sinusoidal ramp:
    rate(t) = peak * (floor + (1-floor) sin^2(pi (cycles t/T + phase))).

    Implemented by thinning a homogeneous Poisson at the peak rate, so the
    arrival stream is exact, not binned.  ``cycles`` repeats the daily
    curve (a multi-day trace for seasonality-aware controllers);
    ``phase`` shifts it in units of a full cycle, so two streams at
    phases 0 and 0.25 peak a quarter-day apart.  The defaults
    ``cycles=1, phase=0.0`` evaluate the exact historical expression
    (``1*t/T + 0.0 == t/T`` in floats), so existing seeded traces are
    bit-identical.
    """
    if rps_peak <= 0:
        return []
    rng = np.random.default_rng(seed)
    rate_per_ms = rps_peak / 1e3
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_per_ms)
        if t >= duration_ms:
            break
        frac = floor + (1.0 - floor) \
            * np.sin(np.pi * (cycles * t / duration_ms + phase)) ** 2
        if rng.uniform() < frac:
            times.append(t)
    return _materialize(times, spec, rng, start_rid)


def pod_skewed_diurnal(rps_peak: float, duration_ms: float,
                       spec: WorkloadSpec = DEFAULT_SPEC, seed: int = 0,
                       floor: float = 0.1, cycles: int = 1,
                       phases: Sequence[float] = (0.0, 0.25),
                       amp_scale: Optional[Sequence[float]] = None,
                       floors: Optional[Sequence[float]] = None
                       ) -> List[Request]:
    """Per-pod skewed diurnal load: pod ``p`` receives its own diurnal
    stream at ``phases[p]`` of a cycle with peak
    ``rps_peak * amp_scale[p]`` and floor ``floors[p]``, so the pods
    saturate at *different times and depths* - the workload where a
    pool-scalar controller wastes spawns on whichever pod index parity
    points at, while a pod-scoped controller grows the pod that is
    actually burning.  ``floors[p] = 1.0`` makes pod ``p`` a flat
    (phase-free) stream - the steady-traffic pod beside a swinging one
    is the hardest skew for aggregate signals, which see only the blend.
    Each pod's stream draws from an independent seeded generator
    (``seed + p``); requests are force-stamped with their pod and merged
    by arrival time with globally unique rids.
    """
    amp_scale = amp_scale if amp_scale is not None else [1.0] * len(phases)
    floors = floors if floors is not None else [floor] * len(phases)
    streams: List[List[Request]] = []
    offset = 0
    for p, phase in enumerate(phases):
        s = diurnal(rps_peak * amp_scale[p], duration_ms, spec,
                    seed=seed + p, floor=floors[p], start_rid=offset,
                    cycles=cycles, phase=phase)
        for r in s:
            r.pod = p          # the stream IS this pod's traffic
        offset += len(s)
        streams.append(s)
    merged = [r for s in streams for r in s]
    merged.sort(key=lambda r: (r.arrive_ms, r.rid))
    return merged


def sessions(rps: float, duration_ms: float, spec: WorkloadSpec = DEFAULT_SPEC,
             seed: int = 0, turns_range: Tuple[int, int] = (2, 6),
             think_ms: float = 1500.0,
             followup_range: Tuple[int, int] = (16, 96),
             start_rid: int = 0,
             prefix_groups: int = 0,
             group_zipf: float = 1.2,
             sys_prompt_range: Tuple[int, int] = (128, 512)
             ) -> List[Request]:
    """Multi-turn conversation arrivals at a target *request* rate ``rps``.

    Session starts are homogeneous Poisson at ``rps / mean(turns_range)``
    so the time-averaged turn rate matches ``rps`` (sweeps stay comparable
    with ``poisson`` at the same nominal load; turns cut off at the window
    edge shave the realized rate slightly).  Each session draws a turn
    count, a pod (conversations do not hop pods), and an opening prompt;
    follow-up turns arrive an exponential think time after the previous
    turn and their prompt is the full history so far (``prefix_len``
    KV-shareable tokens) plus a fresh user message from
    ``followup_range``.  ``prefix_id == session_id``: one conversation is
    one prefix group.

    **Shared system-prompt prefix groups** (``prefix_groups > 0``): every
    session additionally belongs to one of ``prefix_groups`` groups -
    think product surfaces sharing a system prompt - drawn Zipf-ish
    (group ``k`` with weight ``(k+1)^-group_zipf``, so group 0 is hot and
    the tail is cold: realistic cache skew).  The group's system prompt
    (length from ``sys_prompt_range``, drawn once per group) prefixes the
    opening prompt, so even a session's *first* turn has
    ``prefix_len > 0`` and can land warm where its group is cached;
    ``prefix_id`` is the *group* id for every turn (many sessions, one
    prefix group - the group's cache entry pools the longest history
    materialized on that replica).  ``to_trace``/``replay`` round-trip
    both forms (session, group, and prefix length all ride the 7-column
    rows).  ``prefix_groups=0`` (default) draws nothing extra and is
    bit-identical to the historical generator.
    """
    if rps <= 0:
        return []
    rng = np.random.default_rng(seed)
    grouped = prefix_groups > 0
    if grouped:
        # group state up front, so per-session draw order is stable
        sys_len = [int(rng.integers(*sys_prompt_range))
                   for _ in range(prefix_groups)]
        w = np.arange(1, prefix_groups + 1, dtype=np.float64) ** -group_zipf
        w /= w.sum()
    mean_turns = 0.5 * (turns_range[0] + turns_range[1])
    start_rate_per_ms = rps / mean_turns / 1e3
    rows = []    # (arrive_ms, session, prompt, gen, prefix_id, pfx_len, pod)
    t, sid = 0.0, 0
    while True:
        t += rng.exponential(1.0 / start_rate_per_ms)
        if t >= duration_ms:
            break
        n_turns = int(rng.integers(turns_range[0], turns_range[1] + 1))
        pod = int(rng.integers(0, spec.n_pods))
        if grouped:
            group = int(rng.choice(prefix_groups, p=w))
            base = sys_len[group]
        else:
            group, base = sid, 0
        at, history = t, base
        for _turn in range(n_turns):
            if at >= duration_ms:
                break
            new_toks = (int(rng.integers(*spec.prompt_range))
                        if history == base
                        else int(rng.integers(*followup_range)))
            gen = int(rng.integers(*spec.gen_range))
            # the opening turn's shareable prefix is the group's system
            # prompt (0 in ungrouped mode); follow-ups share their full
            # history, system prompt included
            rows.append((at, sid, history + new_toks, gen, group, history,
                         pod))
            history += new_toks + gen
            at += rng.exponential(think_ms)
        sid += 1
    rows.sort(key=lambda e: (e[0], e[1]))
    return [Request(rid=start_rid + i, prompt_len=p, gen_len=g, pod=pod,
                    arrive_ms=a, session_id=s, prefix_id=pid,
                    prefix_len=pfx)
            for i, (a, s, p, g, pid, pfx, pod) in enumerate(rows)]


def to_trace(requests: Sequence[Request]) -> List[Tuple]:
    """Serialize any workload to replayable rows (``replay`` round-trips
    this, session identity included)."""
    return [(r.arrive_ms, r.prompt_len, r.gen_len, r.pod,
             r.session_id, r.prefix_id, r.prefix_len) for r in requests]


def replay(trace: Iterable[Tuple], start_rid: int = 0) -> List[Request]:
    """Replay explicit trace rows ``(arrive_ms, prompt_len, gen_len, pod)``
    or the 7-column ``to_trace`` form with
    ``(..., session_id, prefix_id, prefix_len)`` appended."""
    out = []
    for i, row in enumerate(trace):
        if len(row) not in (4, 7):
            # a 5/6-column row would silently lose its session identity
            raise ValueError(f"trace row {i} has {len(row)} columns; "
                             "expected 4 (legacy) or 7 (to_trace)")
        t, p, g, pod = row[:4]
        s, pfx_id, pfx_len = row[4:] if len(row) == 7 else (-1, -1, 0)
        out.append(Request(rid=start_rid + i, prompt_len=int(p),
                           gen_len=int(g), pod=int(pod), arrive_ms=float(t),
                           session_id=int(s), prefix_id=int(pfx_id),
                           prefix_len=int(pfx_len)))
    out.sort(key=lambda r: (r.arrive_ms, r.rid))
    return out


def uniform(n: int, window_ms: float = 500.0,
            spec: WorkloadSpec = DEFAULT_SPEC, seed: int = 0,
            start_rid: int = 0) -> List[Request]:
    """Legacy single-replica bench shape: n requests, arrivals uniform in
    ``[0, window_ms)``.  Draw order matches the historical serving-bench
    generator so seeded results stay bit-identical."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rid = start_rid + i
        out.append(Request(
            rid=rid,
            prompt_len=int(rng.integers(*spec.prompt_range)),
            gen_len=int(rng.integers(*spec.gen_range)),
            pod=rid % spec.n_pods,
            arrive_ms=float(rng.uniform(0, window_ms))))
    return out


def make_workload(kind: str, rps: float, duration_ms: float,
                  spec: WorkloadSpec = DEFAULT_SPEC, seed: int = 0
                  ) -> List[Request]:
    """Dispatcher used by benches and the launcher.  For ``uniform`` the
    request count is derived from rps * duration."""
    if kind == "poisson":
        return poisson(rps, duration_ms, spec, seed)
    if kind == "bursty":
        return bursty(rps, duration_ms, spec, seed)
    if kind == "diurnal":
        return diurnal(rps, duration_ms, spec, seed)
    if kind == "sessions":
        return sessions(rps, duration_ms, spec, seed)
    if kind == "uniform":
        return uniform(int(rps * duration_ms / 1e3), duration_ms, spec, seed)
    raise ValueError(f"unknown workload kind {kind!r}")
