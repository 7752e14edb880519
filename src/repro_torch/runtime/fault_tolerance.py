"""Fleet runtime: heartbeats, failure handling, straggler mitigation,
elastic re-meshing plans.

The port's own copy of ``repro.runtime.fault_tolerance``, unchanged in
behaviour: the port imports nothing of ``repro``.

On a real multi-pod fleet this logic runs in the job coordinator next to
the launcher; here it is implemented host-side (and driven by the tests
and the ``train_100m`` example) with injected clocks so every policy is
deterministic and unit-testable.

* ``HeartbeatMonitor`` - workers check in; silence beyond ``timeout_s``
  marks a worker dead and produces a recovery plan (restore latest
  checkpoint on the surviving topology).
* ``StragglerMitigator`` - per-step worker durations feed an EWMA; a worker
  slower than ``threshold x`` median for ``patience`` consecutive steps is
  flagged; the plan demotes it from the *active* worker set and promotes a
  hot spare - which is GCR's admission idea applied to fleet membership
  (slow participants are "passivated" instead of convoying every barrier,
  exactly like threads parked by GCR stop convoying the lock).
* ``ElasticPlan`` - maps a desired chip count to the nearest feasible
  (data, model) mesh, preserving the model axis; the checkpoint manager's
  elastic restore does the data movement.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class RecoveryPlan:
    dead_workers: List[int]
    restore_step: Optional[int]
    new_world: List[int]
    action: str  # "restart_from_checkpoint" | "continue"


class HeartbeatMonitor:
    def __init__(self, workers: List[int], timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_seen: Dict[int, float] = {w: clock() for w in workers}

    def beat(self, worker: int) -> None:
        self.last_seen[worker] = self.clock()

    def dead(self) -> List[int]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def plan(self, latest_ckpt_step: Optional[int]) -> RecoveryPlan:
        dead = self.dead()
        if not dead:
            return RecoveryPlan([], None, sorted(self.last_seen), "continue")
        survivors = [w for w in self.last_seen if w not in dead]
        for w in dead:
            self.last_seen.pop(w)
        return RecoveryPlan(dead, latest_ckpt_step, sorted(survivors),
                            "restart_from_checkpoint")


class StragglerMitigator:
    """Demote persistent stragglers; promote hot spares (GCR-style)."""

    def __init__(self, workers: List[int], spares: Optional[List[int]] = None,
                 threshold: float = 1.5, patience: int = 3,
                 ewma: float = 0.5) -> None:
        self.active = list(workers)
        self.spares = list(spares or [])
        self.threshold = threshold
        self.patience = patience
        self.ewma = ewma
        self.times: Dict[int, float] = {}
        self.strikes: Dict[int, int] = {}
        self.demoted: List[int] = []

    def observe(self, durations: Dict[int, float]) -> List[Tuple[int, int]]:
        """Feed per-worker step durations; returns [(demoted, promoted)]."""
        for w, d in durations.items():
            prev = self.times.get(w, d)
            self.times[w] = self.ewma * d + (1 - self.ewma) * prev
        observed = [self.times[w] for w in self.active if w in self.times]
        if not observed:
            return []
        med = sorted(observed)[len(observed) // 2]
        swaps: List[Tuple[int, int]] = []
        for w in list(self.active):
            if w not in self.times:
                continue
            if self.times[w] > self.threshold * med:
                self.strikes[w] = self.strikes.get(w, 0) + 1
                if self.strikes[w] >= self.patience and self.spares:
                    spare = self.spares.pop(0)
                    self.active[self.active.index(w)] = spare
                    self.demoted.append(w)
                    swaps.append((w, spare))
                    self.strikes.pop(w, None)
            else:
                self.strikes.pop(w, None)
        return swaps


@dataclass
class ElasticPlan:
    chips: int
    data: int
    model: int

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return (self.data, self.model)


def plan_elastic_mesh(available_chips: int, model_parallel: int = 16
                      ) -> ElasticPlan:
    """Largest (data, model) mesh fitting the surviving chips, preserving
    the model axis (param shards must stay intact for elastic restore)."""
    if available_chips < model_parallel:
        raise ValueError(
            f"cannot keep model axis {model_parallel} with only "
            f"{available_chips} chips")
    data = available_chips // model_parallel
    return ElasticPlan(chips=data * model_parallel, data=data,
                       model=model_parallel)
