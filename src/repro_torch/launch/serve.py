"""Serving launcher: ``python -m repro_torch.launch.serve [--device cuda]``.

The port of ``repro.launch.serve``, with its three modes and flags:

* default: the real-model engine with GCR admission over the reduced
  (smoke) model; weights are drawn from a seeded ``torch.Generator``.
  Without ``--device`` it runs on CUDA and raises where there is none.
* ``--fleet-sweep``: the virtual-time capacity sweep of one
  ``SimServeEngine`` at 256, 1,024 and 4,096 streams;
* ``--cluster``: the L2 fleet simulator, N replicas behind a router on one
  virtual clock.

The last two run in virtual time under the H100's constants
(``StepCostModel``'s, the prefill charge, the SLO and the KV migration)
and need no card, so they never resolve a device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..cluster import ROUTERS, WORKLOADS
from ..configs import ARCHS, PORT_ONLY, get_smoke_config
from ..models import init_params
from ..serving.engine import (PREFILL_MS_PER_TOK, Request, SimServeEngine,
                              TorchServeEngine, make_admission)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=ARCHS + list(PORT_ONLY))
    ap.add_argument("--admission", default="gcr",
                    choices=["none", "gcr", "gcr_pod"])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--fleet-sweep", action="store_true",
                    help="virtual-time capacity sweep instead of the "
                         "real-model engine")
    ap.add_argument("--active-limit", type=int, default=384)
    # -- cluster mode (multi-replica virtual-time fleet) --------------------
    ap.add_argument("--cluster", action="store_true",
                    help="run the L2 fleet simulator: N replicas behind a "
                         "router on one virtual clock")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--router", default="gcr_aware", choices=ROUTERS)
    ap.add_argument("--workload", default="poisson", choices=WORKLOADS)
    ap.add_argument("--sessions", action="store_true",
                    help="shorthand for --workload sessions (multi-turn "
                         "conversations with KV-shareable prefixes)")
    ap.add_argument("--prefix-cache-tokens", type=int, default=0,
                    help="per-replica prefix-cache budget in tokens "
                         "(0 = no cache); hits discount prefill")
    ap.add_argument("--prefill-ms-per-tok", type=float,
                    default=PREFILL_MS_PER_TOK,
                    help="prefill charge per uncached prompt token, "
                         "applied only when a prefix cache is enabled "
                         "(default: the H100's, measured by "
                         "serving.calibrate)")
    ap.add_argument("--rps", type=float, default=500.0)
    ap.add_argument("--duration-ms", type=float, default=5_000.0)
    ap.add_argument("--autoscale", nargs="?", const="queue", default=None,
                    choices=["queue", "slo", "predictive"],
                    help="autoscaler policy; bare --autoscale keeps the "
                         "legacy queue-depth scale-out hook, slo/predictive "
                         "run the SLO controller (with KV-migration "
                         "scale-in)")
    ap.add_argument("--max-replicas", type=int, default=8)
    ap.add_argument("--staleness-ms", type=float, default=0.0,
                    help="signal-bus publish period: routers/controllers "
                         "see occupancy up to this stale (0 = omniscient)")
    ap.add_argument("--signal-jitter-ms", type=float, default=0.0,
                    help="seeded uniform extra delay per metrics publish")
    ap.add_argument("--trace-out", metavar="PREFIX", default=None,
                    help="cluster mode: record request spans + control-"
                         "plane flight log and write PREFIX.spans.jsonl / "
                         "PREFIX.trace.json (Perfetto) / "
                         "PREFIX.flight.jsonl / PREFIX.windows.csv")
    ap.add_argument("--window-ms", type=float, default=0.0,
                    help="cluster mode: windowed fleet metrics every this "
                         "many virtual ms (with --trace-out they land in "
                         "PREFIX.windows.csv; alone they print the "
                         "collapse-onset report)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="real-model mode: cuda (default) or cpu; cuda "
                         "raises if absent")
    args = ap.parse_args(argv)

    if args.cluster:
        import dataclasses

        from ..cluster import (FleetConfig, Observability, WorkloadSpec,
                               est_capacity_rps, make_workload, run_fleet)
        from ..serving.engine import StepCostModel

        if args.sessions:
            args.workload = "sessions"
        spec = WorkloadSpec()
        cost = None
        if args.prefix_cache_tokens > 0:
            cost = dataclasses.replace(
                StepCostModel(), t_prefill_ms_per_tok=args.prefill_ms_per_tok)
        cfg = FleetConfig(n_replicas=args.replicas,
                          admission=args.admission,
                          active_limit=args.active_limit,
                          cost=cost,
                          prefix_cache_tokens=args.prefix_cache_tokens)
        reqs = make_workload(args.workload, args.rps, args.duration_ms,
                             spec, args.seed)
        rpr = est_capacity_rps(spec, args.active_limit, 1)
        obs = None
        if args.trace_out or args.window_ms > 0.0:
            obs = Observability(window_ms=args.window_ms,
                                spans=args.trace_out is not None,
                                flight=args.trace_out is not None)
        # router resolved by name inside run_fleet, seeded by router_seed:
        # the whole run is a pure function of --seed
        res = run_fleet(reqs, args.router,
                        cfg, autoscale=args.autoscale,
                        max_replicas=args.max_replicas,
                        staleness_ms=args.staleness_ms,
                        jitter_ms=args.signal_jitter_ms,
                        signal_seed=args.seed,
                        rps_per_replica=rpr,
                        router_seed=args.seed, obs=obs)
        print(f"router={args.router} admission={args.admission} "
              f"workload={args.workload} rps={args.rps:g} "
              f"staleness={args.staleness_ms:g}ms "
              f"autoscale={args.autoscale or 'off'}")
        print(res.summary())
        print(f"scale: out={res.stats['scale_events']:.0f} "
              f"in={res.stats['scale_in_events']:.0f} "
              f"migrated={res.stats['migrated']:.0f} "
              f"replica_s={res.stats['replica_ms'] / 1e3:,.1f}")
        if args.prefix_cache_tokens > 0:
            print(f"prefix: hit_rate={res.stats['prefix_hit_rate']:.0%} "
                  f"warm={res.stats['warm_completed']:.0f}@"
                  f"p99={res.stats['ttft_warm_p99_ms']:,.0f}ms "
                  f"cold={res.stats['cold_completed']:.0f}@"
                  f"p99={res.stats['ttft_cold_p99_ms']:,.0f}ms "
                  f"lost={res.stats['prefix_tokens_lost']:.0f}tok")
        hdr = (f"{'replica':>8} {'tokens':>10} {'done':>6} {'active':>7} "
               f"{'parked':>7} {'peak_a':>7} {'peak_p':>7} {'life_s':>7} "
               f"{'cache':>8}")
        print(hdr)
        for i, r in enumerate(res.per_replica):
            print(f"{i:>8} {r['tokens']:>10,} {r['completed']:>6} "
                  f"{r['active_end']:>7} {r['parked_end']:>7} "
                  f"{r['peak_active']:>7} {r['peak_parked']:>7} "
                  f"{r['life_ms'] / 1e3:>7.1f} "
                  f"{r['cache_tokens']:>8,}")
        if obs is not None:
            if args.window_ms > 0.0:
                onset = obs.onset()
                if onset is None:
                    print(f"onset: none in {len(obs.windows)} windows of "
                          f"{args.window_ms:g}ms (goodput held within 50% "
                          "of its loaded peak)")
                else:
                    print(f"onset: collapse at window {onset['window']} "
                          f"(t={onset['t_ms']:,.0f}ms): goodput "
                          f"{onset['goodput_tok_s']:,.0f} tok/s vs loaded "
                          f"peak {onset['peak_tok_s']:,.0f} (window "
                          f"{onset['peak_window']})")
            if args.trace_out:
                for stream, path in obs.export(args.trace_out).items():
                    print(f"trace: {stream} -> {path}")
        return

    if args.fleet_sweep:
        rng = np.random.default_rng(0)
        print(f"{'streams':>8} {'tok/s':>10} {'p50ms':>8} {'done':>6}")
        for n in [256, 1024, 4096]:
            adm = make_admission(args.admission, args.active_limit, n_pods=2)
            reqs = [Request(rid=i, prompt_len=int(rng.integers(256, 1024)),
                            gen_len=int(rng.integers(64, 256)), pod=i % 2,
                            arrive_ms=float(rng.uniform(0, 500)))
                    for i in range(n)]
            res = SimServeEngine(adm).run(reqs, max_ms=600_000)
            print(f"{n:>8} {res.token_throughput:>10,.0f} "
                  f"{res.p50_latency_ms:>8.0f} {res.completed:>6}")
        return

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    eng = TorchServeEngine(cfg, params, n_slots=args.slots,
                           max_len=args.prompt_len + args.gen_len + 4,
                           admission_kind=args.admission, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.streams, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts, gen_len=args.gen_len)
    print(f"arch={cfg.name} streams={args.streams} slots={args.slots} "
          f"admission={args.admission} device={device}")
    print(f"fast admits: {getattr(eng.admission, 'stat_fast', 0)}  "
          f"parked: {getattr(eng.admission, 'stat_parked', 0)}")
    for i in range(min(3, args.streams)):
        print(f"stream {i}: {out[i].tolist()}")


if __name__ == "__main__":
    main()
