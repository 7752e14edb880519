"""Flight-recorder demo: watch a fleet collapse in time, then load the
trace in Perfetto.

Drives one small fleet past its saturation point twice - occupancy-blind
round-robin over unrestricted replicas vs GCR admission with GCR-aware
routing - with the full observability bundle attached: request spans,
the control-plane flight recorder, and windowed fleet metrics (250 ms
windows on the reference's step costs, ``WINDOW_MS`` here).
Prints the time-resolved goodput series with the detected collapse-onset
window (the blind fleet has one; the restricted fleet does not), then
writes every stream to --out:

    <out>/<tag>.spans.jsonl    structured span events (JSONL)
    <out>/<tag>.trace.json     Chrome trace-event JSON - open at
                               https://ui.perfetto.dev
    <out>/<tag>.flight.jsonl   control-plane decision log
    <out>/<tag>.windows.csv    per-window fleet time series

The port of ``examples/trace_demo.py``, on the port's H100 step costs
(``serving/engine.py``); it touches no device.  Run:

    PYTHONPATH=src python -m repro_torch.examples.trace_demo [--smoke] [--out DIR]

Its settings are the reference's but for its virtual times, which the
card's step forces to differ.  The H100's decode step of a full active
set at the demo's ``LIMIT`` of 32 streams is 44.7 ms
(``StepCostModel().step_ms(32, 0, 0.0)``), 12.3 times the reference's
3.64 ms, so a request lives 12 times longer.  At the reference's times
the 2 s offered window holds 73 requests, a replica's backlog never
passes the HBM knee and nothing collapses.  So every virtual time below
is the reference's counted in its decode steps at ``LIMIT``, times the
H100 step there: the reference's times times ``STEPS``, that ratio
rounded to a whole number (12).  That keeps the reference's request
count (about 900 in the smoke run), its window of 69 steps and its
drain budget; ``LIMIT`` and the fleet sizes stay the reference's.
"""

import argparse
import os

from ..cluster import (Blackout, Crash, FaultSchedule, FleetConfig,
                       HealthPolicy, HedgePolicy, Limplock, Observability,
                       WorkloadSpec, est_capacity_rps, knee_cost,
                       make_workload, run_fleet)
from ..serving.engine import StepCostModel

LIMIT = 32
# the reference's decode step of a full active set at LIMIT (its
# StepCostModel defaults, 3.0 + 0.02 a stream)
REF_STEP_MS = 3.0 + 0.02 * LIMIT
STEPS = round(StepCostModel().step_ms(LIMIT, 0, 0.0) / REF_STEP_MS)
WINDOW_MS = 250.0 * STEPS          # the metrics window
MAX_MS = 60_000.0 * STEPS          # each run's virtual-time budget
SMOKE = (2, LIMIT, 2_000.0 * STEPS)     # replicas, limit, offered window
FULL = (4, LIMIT, 4_000.0 * STEPS)
# the faulted run's signal staleness and jitter, health staleness and
# hedge delay
STALENESS_MS, JITTER_MS = 60.0 * STEPS, 5.0 * STEPS
HEALTH_STALE_MS, HEDGE_DELAY_MS = 150.0 * STEPS, 500.0 * STEPS


def run_traced(tag, router, admission, reqs, cfg, out_dir, **kw):
    obs = Observability(window_ms=WINDOW_MS)
    res = run_fleet(reqs, router, cfg, max_ms=MAX_MS, router_seed=1,
                    obs=obs, **kw)
    print(f"\n== {tag} ({router}/{admission}) ==")
    print(res.summary())

    bar_max = max((w["goodput_tok_s"] for w in obs.windows), default=1.0)
    onset = obs.onset()
    onset_win = None if onset is None else onset["window"]
    shown = 0
    for w in obs.windows:
        if w["arrivals"] == 0 and w["completed"] == 0:
            continue
        shown += 1
        if shown > 24:
            print("   ... (drain continues)")
            break
        bar = "#" * int(40 * w["goodput_tok_s"] / max(bar_max, 1e-9))
        mark = "  <- collapse onset" if w["window"] == onset_win else ""
        print(f"  [{w['t_start_ms']:>6,.0f}ms] arr={w['arrivals']:>4} "
              f"done={w['completed']:>4} goodput={w['goodput_tok_s']:>8,.0f} "
              f"{bar}{mark}")
    if onset is None:
        print("  onset: none - goodput held within 50% of its loaded peak")
    else:
        print(f"  onset: window {onset['window']} at "
              f"{onset['t_ms']:,.0f}ms - goodput "
              f"{onset['goodput_tok_s']:,.0f} tok/s, down from loaded peak "
              f"{onset['peak_tok_s']:,.0f} (window {onset['peak_window']})")

    paths = obs.export(os.path.join(out_dir, tag))
    for stream, path in sorted(paths.items()):
        print(f"  {stream:>7}: {path}")
    print(f"  open {paths['trace']} at https://ui.perfetto.dev")
    return onset


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="smaller fleet + shorter offered window (CI)")
    ap.add_argument("--out", default="traces",
                    help="output directory (default: ./traces)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    n_replicas, limit, duration_ms = SMOKE if args.smoke else FULL
    spec = WorkloadSpec(prompt_range=(128, 512), gen_range=(32, 128),
                        n_pods=2)
    cost = knee_cost(spec, limit, oversub=2.0)
    cap = est_capacity_rps(spec, limit, n_replicas, cost)
    reqs = make_workload("poisson", 2.0 * cap, duration_ms, spec, seed=7)
    print(f"{len(reqs)} requests at 2x saturation "
          f"(~{2.0 * cap:,.0f} rps) into {n_replicas} replicas, "
          f"active_limit={limit}, windows of {WINDOW_MS:g}ms")

    blind = run_traced(
        "blind", "round_robin", "none", reqs,
        FleetConfig(n_replicas=n_replicas, admission="none",
                    active_limit=limit, n_pods=2, cost=cost), args.out)
    aware = run_traced(
        "gcr_aware", "gcr_aware", "gcr", reqs,
        FleetConfig(n_replicas=n_replicas, admission="gcr",
                    active_limit=limit, n_pods=2, cost=cost), args.out)

    assert blind is not None, "blind fleet should collapse past saturation"
    assert aware is None, "restricted fleet should hold its goodput"
    print("\ncollapse onset found for the blind fleet only - restricting "
          "concurrency is what removes it.")

    # fault-injection run (DESIGN.md 11): replica 0 limps x16 behind a
    # signal blackout, replica 1 crashes and cold-restarts; health-aware
    # ejection + hedged requests respond.  The exported trace shows the
    # fault/eject/restore flight events and hedge/cancel spans.
    t0, t1 = 0.02 * duration_ms, 0.7 * duration_ms
    faults = FaultSchedule(
        limplocks=[Limplock(0, t0, t1, factor=16.0)],
        blackouts=[Blackout(0, t0, t1)],
        crashes=[Crash(1, 0.2 * duration_ms,
                       restart_ms=0.6 * duration_ms)])
    run_traced(
        "faulted", "gcr_aware", "gcr", reqs,
        FleetConfig(n_replicas=n_replicas, admission="gcr",
                    active_limit=limit, n_pods=2, cost=cost), args.out,
        staleness_ms=STALENESS_MS, jitter_ms=JITTER_MS, faults=faults,
        health=HealthPolicy(stale_ms=HEALTH_STALE_MS),
        hedge=HedgePolicy(delay_ms=HEDGE_DELAY_MS))
    print("\nfaulted run traced - eject/restore and hedge/cancel events "
          "are in the flight log and span stream.")


if __name__ == "__main__":
    main()
