"""Fleet demo: routing policy x admission under a traffic burst.

Runs the L2 cluster simulator at 2x the fleet's saturation point and shows
the paper's thesis one layer above the engine: restricting and steering
which streams circulate (GCR admission + occupancy-aware, pod-affine
routing) holds throughput and the latency tail where occupancy-blind
routing over unrestricted replicas collapses.  Finishes in seconds on CPU
- it is all virtual time.

Also demos the control plane: routing from a stale metrics bus, the
predictive SLO autoscaler scaling out for a diurnal ramp then scaling
back in (paying KV migration for each retired replica), and
session-affinity routing over prefix-cached replicas on a multi-turn
chat workload (warm turns skip prefix prefill).

The port of ``examples/cluster_demo.py``, on the port's H100 step costs
(``serving/engine.py``).  Run:

    PYTHONPATH=src python -m repro_torch.examples.cluster_demo

It touches no device.  Its settings are the reference's but for its
virtual times, which the card's step forces to differ, and the affinity
part's prefill charge.  The H100's decode step of a full active set at
the demo's ``LIMIT`` of 64 streams is 51.3 ms
(``StepCostModel().step_ms(64, 0, 0.0)``), 12.0 times the reference's
4.28 ms, so a request lives 12 times longer.  At the reference's times
the 4 s burst holds 399 requests, no replica's backlog passes the HBM
knee, and the blind fleet gives the most goodput (3,953 tok/s against
gcr_aware's 3,189): the thesis turns round for want of load, not of
collapse.  So every virtual time below (the offered windows, the run
budget, the signal staleness and jitter, the autoscaler's cooldown and
lead, the chat's think time) is the reference's counted in its decode
steps at ``LIMIT``, times the H100 step there: the reference's times
times ``STEPS``, that ratio rounded to a whole number (12).  That keeps
the reference's request counts (about 3,200 in the burst) and the load
in steps; ``LIMIT`` and the fleet sizes stay the reference's.  The chat's
prefill charge is the card's measured one
(``engine.PREFILL_MS_PER_TOK``), the port launcher's default, where the
reference takes its launcher's 0.05 ms a token.
"""

import dataclasses

from ..cluster import (FleetConfig, SLOAutoscaler, WorkloadSpec,
                       est_capacity_rps, knee_cost, make_router,
                       make_workload, run_fleet, sessions)
from ..serving.engine import PREFILL_MS_PER_TOK, StepCostModel

N_REPLICAS, LIMIT, N_PODS = 4, 64, 2
SPEC = WorkloadSpec(prompt_range=(256, 1024), gen_range=(64, 256),
                    n_pods=N_PODS)
# the reference's decode step of a full active set at LIMIT (its
# StepCostModel defaults, 3.0 + 0.02 a stream)
REF_STEP_MS = 3.0 + 0.02 * LIMIT
STEPS = round(StepCostModel().step_ms(LIMIT, 0, 0.0) / REF_STEP_MS)
WINDOW_MS = 4_000.0 * STEPS        # the burst's and the chat's window
MAX_MS = 120_000.0 * STEPS         # each run's virtual-time budget
STALENESS_MS = tuple(s * STEPS for s in (0.0, 120.0, 500.0))
JITTER_MS = 20.0 * STEPS
DIURNAL_MS = 16_000.0 * STEPS      # the diurnal day
COOLDOWN_IN_MS = 800.0 * STEPS     # the predictive autoscaler's
LEAD_MS = 4_000.0 * STEPS
THINK_MS = 1_500.0 * STEPS         # between a conversation's turns
PREFILL_MS = PREFILL_MS_PER_TOK    # the chat's prefill charge, a token


def main() -> None:
    # HBM knee at 2x a full active set, so NoAdmission replicas can thrash
    cost = knee_cost(SPEC, LIMIT, oversub=2.0)
    rps = 2.0 * est_capacity_rps(SPEC, LIMIT, N_REPLICAS, cost)
    reqs = make_workload("bursty", rps, WINDOW_MS, SPEC, seed=3)
    print(f"offered: {len(reqs)} requests over {WINDOW_MS / 1e3:g}s "
          f"(~{rps:,.0f} rps = 2x saturation), {N_REPLICAS} replicas, "
          f"active_limit={LIMIT}\n")
    print(f"{'router':<18} {'admission':<8} {'tok/s':>9} {'goodput':>9} "
          f"{'slo':>5} {'ttft_p99':>9}")
    for rname, adm in [("round_robin", "none"),
                       ("round_robin", "gcr"),
                       ("least_outstanding", "gcr"),
                       ("p2c", "gcr"),
                       ("gcr_aware", "gcr"),
                       ("gcr_aware", "gcr_pod")]:
        cfg = FleetConfig(n_replicas=N_REPLICAS, admission=adm,
                          active_limit=LIMIT, n_pods=N_PODS, cost=cost)
        res = run_fleet(reqs, make_router(rname, seed=1, n_pods=N_PODS),
                        cfg, max_ms=MAX_MS)
        print(f"{rname:<18} {adm:<8} {res.token_throughput:>9,.0f} "
              f"{res.goodput_tok_s:>9,.0f} {res.slo_attainment:>5.0%} "
              f"{res.ttft_p99_ms:>8,.0f}ms")

    # queue-depth autoscaler: start undersized, absorb the burst
    print("\nautoscaler (starts with 2 replicas, queue-depth scale-out):")
    cfg = FleetConfig(n_replicas=2, admission="gcr", active_limit=LIMIT,
                      n_pods=N_PODS, cost=cost)
    router = make_router("gcr_aware", n_pods=N_PODS)
    fixed = run_fleet(reqs, router, cfg, max_ms=MAX_MS)
    scaled = run_fleet(reqs, make_router("gcr_aware", n_pods=N_PODS),
                       cfg, autoscale=True, max_ms=MAX_MS)
    print(f"  fixed : {fixed.summary()}")
    print(f"  scaled: {scaled.summary()}")

    # stale signals: the router sees only the last published report
    print("\nsignal staleness (gcr_aware at 2x saturation, bursty):")
    for stale in STALENESS_MS:
        res = run_fleet(reqs, make_router("gcr_aware", n_pods=N_PODS),
                        FleetConfig(n_replicas=N_REPLICAS, admission="gcr",
                                    active_limit=LIMIT, n_pods=N_PODS,
                                    cost=cost),
                        max_ms=MAX_MS, staleness_ms=stale,
                        jitter_ms=(JITTER_MS if stale else 0.0))
        tag = "omniscient" if stale == 0 else f"{stale:,.0f}ms stale"
        print(f"  {tag:<12}: goodput={res.goodput_tok_s:,.0f} "
              f"ttft_p99={res.ttft_p99_ms:,.0f}ms")

    # predictive SLO controller on a diurnal day: out on the ramp, in on
    # the decline (each retirement migrates KV at a virtual-clock cost)
    print("\npredictive SLO autoscaler (diurnal ramp, 2 -> 6 -> min):")
    cap0 = est_capacity_rps(SPEC, LIMIT, 2, cost)
    day = make_workload("diurnal", 2.5 * cap0, DIURNAL_MS, SPEC, seed=3)
    qd = run_fleet(day, make_router("gcr_aware", n_pods=N_PODS), cfg,
                   autoscale="queue", max_replicas=6, max_ms=MAX_MS)
    sc = run_fleet(day, make_router("gcr_aware", n_pods=N_PODS), cfg,
                   autoscale=SLOAutoscaler(cfg, max_replicas=6,
                                           predictive=True,
                                           rps_per_replica=cap0 / 2,
                                           cooldown_in_ms=COOLDOWN_IN_MS,
                                           scale_in_util=0.8,
                                           lead_ms=LEAD_MS),
                   max_ms=MAX_MS)
    for name, res in (("queue-depth", qd), ("slo-predict", sc)):
        print(f"  {name}: slo={res.slo_attainment:.0%} "
              f"replica_s={res.stats['replica_ms'] / 1e3:,.1f} "
              f"out={res.stats['scale_events']:.0f} "
              f"in={res.stats['scale_in_events']:.0f} "
              f"migrated={res.stats['migrated']:.0f}")

    # session affinity: multi-turn chat, prefix-cached replicas - a warm
    # turn skips recomputing the conversation history (prefill), so
    # sticky routing beats occupancy-only placement past saturation
    print("\nsession affinity (multi-turn chat at ~1.7x saturation, "
          "prefix-cached replicas):")
    spec1 = WorkloadSpec(prompt_range=(256, 1024), gen_range=(64, 256),
                         n_pods=1)
    acost = dataclasses.replace(knee_cost(spec1, LIMIT, oversub=2.0),
                                t_prefill_ms_per_tok=PREFILL_MS)
    acap = est_capacity_rps(spec1, LIMIT, N_REPLICAS, acost)
    chat = sessions(3.0 * acap, WINDOW_MS, spec1, seed=3, think_ms=THINK_MS)
    acfg = FleetConfig(n_replicas=N_REPLICAS, admission="gcr",
                       active_limit=LIMIT, n_pods=1, cost=acost,
                       prefix_cache_tokens=400_000)
    print(f"  {len(chat)} turns, "
          f"{len({r.session_id for r in chat})} conversations")
    print(f"  {'router':<14} {'goodput':>9} {'ttft_p99':>9} {'hit':>5} "
          f"{'warm_p99':>9} {'cold_p99':>9}")
    for rname in ("gcr_aware", "affinity", "prefix_aware"):
        res = run_fleet(chat, rname, acfg, max_ms=MAX_MS, router_seed=1)
        print(f"  {rname:<14} {res.goodput_tok_s:>9,.0f} "
              f"{res.ttft_p99_ms:>8,.0f}ms "
              f"{res.stats['prefix_hit_rate']:>5.0%} "
              f"{res.stats['ttft_warm_p99_ms']:>8,.0f}ms "
              f"{res.stats['ttft_cold_p99_ms']:>8,.0f}ms")


if __name__ == "__main__":
    main()
