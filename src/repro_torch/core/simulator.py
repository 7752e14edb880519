"""Deterministic discrete-event simulator of lock contention.

The port's own copy of ``repro.core.simulator``, unchanged in behaviour:
the port imports nothing of ``repro``.

Why a simulator: CPython serializes threads, and a host with few cores
cannot stand in for the paper's machines, so wall-clock multithreaded runs
show the *qualitative* collapse but cannot reproduce the paper's
machine-scale numbers.  The simulator models the three mechanisms the
paper identifies as causing scalability collapse (Section 1) and lets us
reproduce Figures 1, 6, 7, 8, 9 and 11 exactly and
deterministically:

1. **Preemption** - more runnable threads than logical CPUs dilates all timed
   work (time-sharing) and can preempt the next-in-line lock waiter, stalling
   FIFO handoffs (the MCS oversubscription cliff).
2. **Coherence traffic** - global-spin locks pay a handoff cost growing with
   the number of spinners (the TTAS storm); queue locks pay a single cache
   line transfer, cheap intra-socket and expensive across sockets.
3. **Cache pressure** - the more *distinct threads circulating* through the
   lock, the more LLC thrash: critical and non-critical sections inflate once
   the circulating set exceeds an LLC capacity threshold.

Lock models: TTAS, Ticket, MCS (spin / spin-then-park), parking mutex
(pthread), Malthusian [Dice'17], and the GCR / GCR-NUMA wrappers over any of
them - mirroring ``locks.py``/``gcr.py`` at the semantic level (active-set
counter, FIFO passive queue, THRESHOLD promotion, work conservation,
per-socket queues + preferred-socket rotation).

Everything is seeded; identical inputs give identical outputs.
"""

from __future__ import annotations

import heapq
import itertools
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# Machine specs (paper Section 6)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MachineSpec:
    name: str
    sockets: int
    cpus_per_socket: int          # logical CPUs
    quantum_us: float = 4000.0    # scheduler time slice
    ctx_switch_us: float = 5.0    # park/unpark round trip
    spin_limit_us: float = 10.0   # spin phase of spin-then-park (~2x ctx)
    cl_local_us: float = 0.06     # cache-line transfer, same socket
    cl_remote_us: float = 0.35    # cache-line transfer, cross socket
    coherence_coef: float = 0.25  # global-spin storm cost per spinner
    llc_threads: int = 24         # circulating threads the LLC can absorb
    pressure_coef: float = 0.03   # inflation per circulating thread over cap
    pressure_window_us: float = 2000.0  # window defining "circulating"

    @property
    def cpus(self) -> int:
        return self.sockets * self.cpus_per_socket


# The paper's three machines.
X6_2 = MachineSpec("X6-2", sockets=2, cpus_per_socket=20)
X5_4 = MachineSpec("X5-4", sockets=4, cpus_per_socket=36, llc_threads=48)
T7_2 = MachineSpec("T7-2", sockets=2, cpus_per_socket=256, llc_threads=128,
                   cl_remote_us=0.5)
MACHINES = {m.name: m for m in (X6_2, X5_4, T7_2)}


# ---------------------------------------------------------------------------
# Simulation core
# ---------------------------------------------------------------------------


@dataclass
class SimThread:
    tid: int
    socket: int
    ops: int = 0
    spinning: bool = False
    parked: bool = False
    in_timed: bool = False      # in CS or NCS (consuming a CPU)
    wake_at: float = -1.0       # when an unparking thread becomes runnable
    gen: int = 0                # waiting-state generation (guards stale events)


@dataclass
class SimResult:
    lock: str
    machine: str
    n_threads: int
    duration_us: float
    total_ops: int
    per_thread_ops: List[int]
    handoffs: int
    handoff_sum_us: float

    @property
    def throughput_mops(self) -> float:
        """Total throughput in ops per simulated second / 1e6."""
        return self.total_ops / self.duration_us

    @property
    def avg_handoff_us(self) -> float:
        return self.handoff_sum_us / max(1, self.handoffs)

    @property
    def unfairness(self) -> float:
        """Paper Section 6.1: share of ops done by the upper half of threads."""
        ops = sorted(self.per_thread_ops)
        half = len(ops) // 2
        total = sum(ops) or 1
        return sum(ops[half:]) / total


class Simulation:
    """Event-driven engine; locks are plug-in policies over its primitives."""

    def __init__(self, machine: MachineSpec, n_threads: int, cs_us: float,
                 ncs_us: float, seed: int = 0) -> None:
        self.m = machine
        self.rng = random.Random(seed)
        self.now = 0.0
        self._heap: List = []
        self._seq = itertools.count()
        self.threads = [
            SimThread(tid=i, socket=i % machine.sockets)
            for i in range(n_threads)
        ]
        self.cs_us = cs_us
        self.ncs_us = ncs_us
        self.n_spinning = 0
        self.n_timed = 0
        # circulating-set tracking (cache-pressure model): distinct threads
        # that completed an acquisition within pressure_window_us
        self._op_log: deque = deque()          # (time, tid)
        self._op_counts: Dict[int, int] = {}   # tid -> ops inside window
        # handoff bookkeeping
        self.last_release_at: Optional[float] = None
        self.handoffs = 0
        self.handoff_sum = 0.0

    # -- load model ----------------------------------------------------------
    def runnable(self) -> int:
        return self.n_timed + self.n_spinning

    def dilation(self) -> float:
        """Time-sharing dilation once runnable threads exceed CPUs."""
        r = self.runnable()
        return max(1.0, r / self.m.cpus)

    def record_op(self, th: SimThread) -> None:
        """An acquisition completed: ``th`` is circulating through the lock."""
        self._op_log.append((self.now, th.tid))
        self._op_counts[th.tid] = self._op_counts.get(th.tid, 0) + 1

    def circulating(self) -> int:
        """Distinct threads that completed an op inside the pressure window.

        This is the paper's "number of distinct threads circulating through
        the lock" (Section 1): parked passive threads fall out of the set,
        which is exactly how GCR relieves LLC pressure.
        """
        horizon = self.now - self.m.pressure_window_us
        log, counts = self._op_log, self._op_counts
        while log and log[0][0] < horizon:
            _, tid = log.popleft()
            c = counts[tid] - 1
            if c:
                counts[tid] = c
            else:
                del counts[tid]
        return len(counts)

    def pressure(self) -> float:
        """LLC pressure from the circulating thread set."""
        over = max(0, self.circulating() - self.m.llc_threads)
        return 1.0 + self.m.pressure_coef * over

    def preemption_delay(self) -> float:
        """Expected stall when handing off to a *spinning* thread that may be
        preempted (only when oversubscribed)."""
        r = self.runnable()
        if r <= self.m.cpus:
            return 0.0
        p_off_cpu = 1.0 - self.m.cpus / r
        if self.rng.random() >= p_off_cpu:
            return 0.0
        mean_wait = (r / self.m.cpus - 1.0) * self.m.quantum_us / 2.0
        return self.rng.expovariate(1.0 / mean_wait) if mean_wait > 0 else 0.0

    def cl_cost(self, a_socket: int, b_socket: int) -> float:
        return (self.m.cl_local_us if a_socket == b_socket
                else self.m.cl_remote_us)

    # -- event plumbing --------------------------------------------------------
    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def run(self, duration_us: float) -> None:
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if t > duration_us:
                break
            self.now = t
            fn()

    # -- thread state accounting -------------------------------------------------
    def set_spinning(self, th: SimThread, on: bool) -> None:
        if th.spinning != on:
            th.spinning = on
            self.n_spinning += 1 if on else -1

    def set_timed(self, th: SimThread, on: bool) -> None:
        if th.in_timed != on:
            th.in_timed = on
            self.n_timed += 1 if on else -1

    def set_parked(self, th: SimThread, on: bool) -> None:
        th.parked = on

    def schedule_wake_to_spin(self, th: SimThread, delay: float) -> None:
        """Unpark ``th``; it starts spinning after ``delay`` (ctx switch).

        The wake event is generation-guarded so that a thread granted the
        lock (or re-parked) before the event fires is not spuriously marked
        as spinning.
        """
        self.set_parked(th, False)
        t = self.now + delay
        th.wake_at = t
        g = th.gen

        def wake() -> None:
            if th.gen == g and not th.parked:
                self.set_spinning(th, True)

        self.at(t, wake)

    def enqueue_stp_waiter(self, th: SimThread) -> None:
        """Spin-then-park waiting (paper Section 3): spin for spin_limit_us,
        then park.  If the lock arrives within the spin window - which is the
        common case once GCR has shrunk the queue - no context switch is ever
        paid; that is the Figure 6(b) recovery mechanism."""
        self.set_spinning(th, True)
        g = th.gen

        def give_up_spinning() -> None:
            if th.gen == g and th.spinning:
                self.set_spinning(th, False)
                self.set_parked(th, True)

        self.at(self.now + self.m.spin_limit_us, give_up_spinning)

    def consume_waiter(self, releaser: SimThread, th: SimThread) -> float:
        """Hand the lock toward ``th``: returns the handoff delay and clears
        its waiting state (spin flag / park / mid-wake residual)."""
        delay = self.cl_cost(releaser.socket, th.socket)
        if th.spinning:
            self.set_spinning(th, False)
            delay += self.preemption_delay()
        elif th.parked:
            self.set_parked(th, False)
            delay += self.m.ctx_switch_us
        elif th.wake_at > self.now:
            delay += th.wake_at - self.now  # still mid-wakeup
        th.wake_at = -1.0
        th.gen += 1  # invalidate any pending wake/park events
        return delay


# ---------------------------------------------------------------------------
# Lock policy interface
# ---------------------------------------------------------------------------


class SimLock:
    """A lock policy: receives attempt/release, calls back ``grant``."""

    name = "simlock"

    def __init__(self, sim: Simulation, grant: Callable[[SimThread], None]):
        self.sim = sim
        self._grant_cb = grant
        self.holder: Optional[SimThread] = None
        self.free = True
        self.last_holder_socket = 0

    def grant(self, th: SimThread, extra_delay: float = 0.0) -> None:
        """Schedule thread ``th`` to own the lock after ``extra_delay``."""
        sim = self.sim
        self.free = False
        self.holder = th
        release_at = sim.now + extra_delay
        if sim.last_release_at is not None:
            sim.handoffs += 1
            sim.handoff_sum += release_at - sim.last_release_at
        sim.at(release_at, lambda: self._grant_cb(th))

    # policy API
    def attempt(self, th: SimThread) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def release(self, th: SimThread) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class SimTTAS(SimLock):
    """Global-spin TTAS: coherence storm on handoff, locality-biased winner."""

    name = "ttas"

    def __init__(self, sim, grant):
        super().__init__(sim, grant)
        self.spinners: List[SimThread] = []
        self.recent_holders: deque = deque(maxlen=4)

    def attempt(self, th: SimThread) -> None:
        if self.free:
            self.grant(th, self.sim.cl_cost(self.last_holder_socket, th.socket))
            return
        self.spinners.append(th)
        self.sim.set_spinning(th, True)

    def release(self, th: SimThread) -> None:
        self.last_holder_socket = th.socket
        self.recent_holders.append(th.tid)
        self.free = True
        self.holder = None
        if not self.spinners:
            return
        # Cache-affinity bias (paper Section 6.1: "the thread on the same
        # core or socket as a previous lock holder is likely to win as it has
        # the lock word in its cache").  A spinner with the line in its L1
        # observes the release ~100ns before anyone else and its CAS wins the
        # race essentially deterministically => gross unfairness.
        recent = set(self.recent_holders)
        weights = [
            1e5 if s.tid in recent else
            (8.0 if s.socket == th.socket else 1.0)
            for s in self.spinners
        ]
        winner = self.sim.rng.choices(self.spinners, weights=weights, k=1)[0]
        self.spinners.remove(winner)
        # Coherence storm: every spinner slams the lock line on each handoff,
        # and spinners are spread across sockets (remote-line cost dominates).
        storm = (self.sim.m.coherence_coef * (len(self.spinners) + 1)
                 * self.sim.m.cl_remote_us)
        delay = self.sim.consume_waiter(th, winner)
        self.grant(winner, delay + storm)


class SimTicket(SimLock):
    """FIFO global spinning (ticket): storm on one line + strict order."""

    name = "ticket"

    def __init__(self, sim, grant):
        super().__init__(sim, grant)
        self.queue: deque[SimThread] = deque()

    def attempt(self, th: SimThread) -> None:
        if self.free and not self.queue:
            self.grant(th, self.sim.cl_cost(self.last_holder_socket, th.socket))
            return
        self.queue.append(th)
        self.sim.set_spinning(th, True)

    def release(self, th: SimThread) -> None:
        self.last_holder_socket = th.socket
        self.free = True
        self.holder = None
        if not self.queue:
            return
        nxt = self.queue.popleft()
        # Ticket spinners also share one line, but the winner is predetermined
        # (FIFO), so the storm constant is lower than TTAS's race.
        storm = (0.5 * self.sim.m.coherence_coef * (len(self.queue) + 1)
                 * self.sim.m.cl_remote_us)
        delay = self.sim.consume_waiter(th, nxt)
        self.grant(nxt, delay + storm)


class SimMCS(SimLock):
    """Queue lock with local spinning; ``spin`` or ``spin_then_park`` waiters.

    spin:  every waiter spins (fast handoff; all waiters load the CPUs -
           collapse once oversubscribed, paper Figure 6a).
    stp:   waiters park; each new queue head starts waking when its
           predecessor acquires, so short critical sections eat an unpark on
           the critical path (the low-thread-count droop of Figure 6b).
    """

    def __init__(self, sim, grant, policy: str = "spin"):
        super().__init__(sim, grant)
        self.policy = policy
        self.queue: deque[SimThread] = deque()
        self.name = f"mcs_{'stp' if policy == 'spin_then_park' else 'spin'}"

    def attempt(self, th: SimThread) -> None:
        if self.free and not self.queue:
            self.grant(th, self.sim.cl_cost(self.last_holder_socket, th.socket))
            return
        self.queue.append(th)
        if self.policy == "spin":
            self.sim.set_spinning(th, True)
        else:
            # every MCS waiter spins on its own node, then parks
            self.sim.enqueue_stp_waiter(th)

    def release(self, th: SimThread) -> None:
        self.last_holder_socket = th.socket
        self.free = True
        self.holder = None
        if not self.queue:
            return
        nxt = self.queue.popleft()
        self.grant(nxt, self.sim.consume_waiter(th, nxt))


class SimMutexPark(SimLock):
    """Parking (pthread-style) mutex: every contended handoff unparks."""

    name = "pthread"

    def __init__(self, sim, grant):
        super().__init__(sim, grant)
        self.queue: deque[SimThread] = deque()

    def attempt(self, th: SimThread) -> None:
        if self.free:  # barging: a fresh arrival grabs a free lock
            self.grant(th, self.sim.cl_cost(self.last_holder_socket, th.socket))
            return
        self.queue.append(th)
        self.sim.set_parked(th, True)

    def release(self, th: SimThread) -> None:
        self.last_holder_socket = th.socket
        self.free = True
        self.holder = None
        if not self.queue:
            return
        nxt = self.queue.popleft()
        self.sim.set_parked(nxt, False)
        delay = self.sim.m.ctx_switch_us + self.sim.cl_cost(th.socket, nxt.socket)
        self.grant(nxt, delay)


class SimMalthusian(SimLock):
    """Dice'17: MCS + culling excess waiters to a parked LIFO passive list."""

    def __init__(self, sim, grant, policy: str = "spin",
                 reinsert_every: int = 64):
        super().__init__(sim, grant)
        self.policy = policy
        self.queue: deque[SimThread] = deque()
        self.passive: List[SimThread] = []
        self.releases = 0
        self.reinsert_every = reinsert_every
        self.name = f"malthusian_{'stp' if policy == 'spin_then_park' else 'spin'}"

    def attempt(self, th: SimThread) -> None:
        if self.free and not self.queue:
            self.grant(th, self.sim.cl_cost(self.last_holder_socket, th.socket))
            return
        self.queue.append(th)
        if self.policy == "spin":
            self.sim.set_spinning(th, True)
        else:
            self.sim.enqueue_stp_waiter(th)

    def _cull(self) -> None:
        # Incremental culling (Dice'17 culls one excess waiter per unlock).
        # Passive-listed waiters keep their waiting policy: under ``spin``
        # they continue spinning (and keep loading the CPUs - the reason
        # Malthusian-spin gives "no relief" in paper Figure 8a); under
        # spin-then-park they are forced to park.
        if len(self.queue) > 1:
            victim = self.queue.pop()
            if self.policy != "spin":
                victim.gen += 1  # cancel the pending spin-phase timeout
                if victim.spinning:
                    self.sim.set_spinning(victim, False)
                self.sim.set_parked(victim, True)
            self.passive.append(victim)

    def release(self, th: SimThread) -> None:
        self.releases += 1
        self.last_holder_socket = th.socket
        self.free = True
        self.holder = None
        if self.releases % self.reinsert_every == 0 and self.passive:
            back = self.passive.pop()  # LIFO
            self.queue.append(back)    # keeps its current waiting state
        self._cull()
        if not self.queue:
            return
        nxt = self.queue.popleft()
        self.grant(nxt, self.sim.consume_waiter(th, nxt))


# ---------------------------------------------------------------------------
# GCR / GCR-NUMA wrappers (semantics of gcr.py over the simulator)
# ---------------------------------------------------------------------------


class SimGCR(SimLock):
    """GCR wrapper: active-set restriction + FIFO passive queue + promotion.

    Passive threads park (the paper's spin-then-park with the head spinning);
    the head's monitoring is modeled as immediate detection when the active
    set drains (it spins on the counters) plus one cache-line transfer.
    """

    def __init__(self, sim, grant, inner_factory, enter_threshold: int = 4,
                 join_threshold: int = 2, promote_threshold: int = 0x4000,
                 numa: bool = False, socket_rotate_every: int = 0x1000):
        super().__init__(sim, grant)
        self.inner: SimLock = inner_factory(sim, grant)
        self.name = (("gcr_numa(" if numa else "gcr(") + self.inner.name + ")")
        self.enter_threshold = enter_threshold
        self.join_threshold = join_threshold
        self.promote_threshold = promote_threshold
        self.num_active = 0
        self.num_acqs = 0
        # Section 4.4 monitor back-off: the queue head samples numActive only
        # every nextCheckActive pauses (doubling, capped).  Transient dips of
        # the active set between samples go unnoticed - this is what keeps
        # the circulating set small and stable (without it, every NCS-induced
        # dip would admit another passive thread and thrash the LLC).
        self._check_interval_us = 0.1
        self._next_check_at = 0.0
        self._check_cap_us = 1000.0
        self.numa = numa
        self.n_sockets = sim.m.sockets if numa else 1
        self.queues: List[deque[SimThread]] = [deque()
                                               for _ in range(self.n_sockets)]
        self.preferred = 0
        self.socket_rotate_every = socket_rotate_every

    # -- passive-queue helpers -------------------------------------------------
    def _qidx(self, th: SimThread) -> int:
        return th.socket % self.n_sockets

    def _eligible_queue(self) -> Optional[deque]:
        q = self.queues[self.preferred]
        if q:
            return q
        for qq in self.queues:
            if qq:
                return qq
        return None

    def _admit_head(self) -> None:
        """Promote the eligible queue head into the active set."""
        q = self._eligible_queue()
        if q is None:
            return
        head = q.popleft()
        # The head was spinning on the counters: detection costs one line
        # transfer; a (rare) parked head pays the unpark.
        delay = self.sim.m.cl_local_us + self.sim.consume_waiter(head, head)
        self.num_active += 1
        # New head of that queue becomes the monitor: cancel its pending
        # spin-phase timeout (it must keep spinning); unpark it if needed.
        if q:
            nh = q[0]
            nh.gen += 1
            if nh.parked:
                self.sim.schedule_wake_to_spin(nh, self.sim.m.ctx_switch_us)
        self.sim.at(self.sim.now + delay, lambda: self.inner.attempt(head))

    # -- lock API ----------------------------------------------------------------
    def attempt(self, th: SimThread) -> None:
        eligible = (not self.numa or th.socket == self.preferred
                    or not self.queues[self.preferred])
        if eligible and self.num_active <= self.enter_threshold:
            self.num_active += 1
            self.inner.attempt(th)
            return
        q = self.queues[self._qidx(th)]
        q.append(th)
        if len(q) == 1:
            self.sim.set_spinning(th, True)   # the head must spin (monitor)
        else:
            self.sim.enqueue_stp_waiter(th)   # passive non-heads: stp

    def release(self, th: SimThread) -> None:
        self.num_acqs += 1
        self.num_active -= 1
        promote = (self.num_acqs % self.promote_threshold == 0
                   and any(self.queues))
        if self.numa and self.num_acqs % self.socket_rotate_every == 0:
            self.preferred = (self.preferred + 1) % self.n_sockets
        self.inner.release(th)
        if not any(len(q) for q in self.queues):
            return
        # Promotion signal (topApproved): long-term fairness.
        if promote:
            self._admit_head()
            return
        # Work conservation: the head notices a drained active set only at
        # its (backed-off) sampling points.
        if self.sim.now >= self._next_check_at:
            if self.num_active <= self.join_threshold:
                self._admit_head()
                self._check_interval_us = 0.1
            else:
                self._check_interval_us = min(self._check_interval_us * 2,
                                              self._check_cap_us)
            self._next_check_at = self.sim.now + self._check_interval_us


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

SIM_LOCKS: Dict[str, Callable] = {
    "ttas": SimTTAS,
    "ticket": SimTicket,
    "mcs_spin": lambda sim, grant: SimMCS(sim, grant, "spin"),
    "mcs_stp": lambda sim, grant: SimMCS(sim, grant, "spin_then_park"),
    "pthread": SimMutexPark,
    "malthusian_spin": lambda sim, grant: SimMalthusian(sim, grant, "spin"),
    "malthusian_stp": lambda sim, grant: SimMalthusian(
        sim, grant, "spin_then_park"),
}


def make_sim_lock(name: str, sim: Simulation,
                  grant: Callable[[SimThread], None],
                  promote_threshold: int = 256,
                  socket_rotate_every: int = 128) -> SimLock:
    """``name`` may be a base lock, ``gcr(<base>)`` or ``gcr_numa(<base>)``."""
    if name.startswith("gcr(") or name.startswith("gcr_numa("):
        numa = name.startswith("gcr_numa(")
        inner = name[name.index("(") + 1:-1]
        return SimGCR(sim, grant, SIM_LOCKS[inner], numa=numa,
                      promote_threshold=promote_threshold,
                      socket_rotate_every=socket_rotate_every)
    return SIM_LOCKS[name](sim, grant)


def run_sim(lock_name: str, n_threads: int, machine: MachineSpec = X6_2,
            duration_us: float = 50_000.0, cs_us: float = 0.8,
            ncs_us: float = 2.5, seed: int = 1,
            promote_threshold: int = 2048,
            socket_rotate_every: int = 8192,
            jitter_sigma: float = 0.15) -> SimResult:
    """One benchmark point: ``n_threads`` looping NCS -> Lock -> CS -> Unlock.

    Thread starts are staggered (the paper's benchmark ramps up during an
    unmeasured warmup) and CS/NCS durations carry small lognormal jitter,
    so the model does not phase-lock into artifacts of exact determinism.
    """
    sim = Simulation(machine, n_threads, cs_us, ncs_us, seed)
    lock_box: List[SimLock] = []

    def jit() -> float:
        return sim.rng.lognormvariate(0.0, jitter_sigma) if jitter_sigma else 1.0

    def on_granted(th: SimThread) -> None:
        # Thread now holds the lock: run the critical section.
        sim.set_timed(th, True)
        # CS cost: base * locality(data written by previous holder) *
        # dilation * pressure.
        lock = lock_box[0]
        local = lock.last_holder_socket == th.socket
        base = sim.cs_us * (1.0 if local else 1.0 + 0.6)
        dur = base * sim.dilation() * sim.pressure() * jit()

        def end_cs() -> None:
            sim.set_timed(th, False)
            th.ops += 1
            sim.record_op(th)
            sim.last_release_at = sim.now
            lock.release(th)
            lock.last_holder_socket = th.socket
            start_ncs(th)

        sim.at(sim.now + dur, end_cs)

    def start_ncs(th: SimThread) -> None:
        sim.set_timed(th, True)
        dur = sim.ncs_us * sim.dilation() * sim.pressure() * jit()

        def end_ncs() -> None:
            sim.set_timed(th, False)
            lock_box[0].attempt(th)

        sim.at(sim.now + dur, end_ncs)

    lock = make_sim_lock(lock_name, sim, on_granted,
                         promote_threshold=promote_threshold,
                         socket_rotate_every=socket_rotate_every)
    lock_box.append(lock)

    # Staggered start (warmup ramp): one thread per ~us, plus jitter.
    for i, th in enumerate(sim.threads):
        t0 = i * 1.0 + sim.rng.random() * ncs_us
        sim.at(t0, (lambda t=th: lock.attempt(t)))

    sim.run(duration_us)
    return SimResult(
        lock=lock_name,
        machine=machine.name,
        n_threads=n_threads,
        duration_us=duration_us,
        total_ops=sum(t.ops for t in sim.threads),
        per_thread_ops=[t.ops for t in sim.threads],
        handoffs=sim.handoffs,
        handoff_sum_us=sim.handoff_sum,
    )


def sweep(lock_names: List[str], thread_counts: List[int],
          machine: MachineSpec = X6_2, **kw) -> Dict[str, List[SimResult]]:
    return {name: [run_sim(name, n, machine, **kw) for n in thread_counts]
            for name in lock_names}


if __name__ == "__main__":  # pragma: no cover - manual exploration
    counts = [1, 2, 4, 8, 16, 20, 30, 40, 60, 80]
    for name in ["ttas", "mcs_spin", "mcs_stp", "pthread",
                 "gcr(mcs_spin)", "gcr_numa(mcs_spin)", "malthusian_spin"]:
        res = [run_sim(name, n) for n in counts]
        row = " ".join(f"{r.throughput_mops:7.3f}" for r in res)
        print(f"{name:22s} {row}")
