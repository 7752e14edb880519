"""The port's cluster fleet (``repro_torch.cluster``) against the reference's.

The fleet is the reference's framework-free code, copied: under the
reference's cost constants (every bare ``StepCostModel()`` in the port
patched to build them) both packages must give equal results, bit for bit.
Held here:

* the golden routing digests of ``tests/golden/cluster_traces.json``, one
  a router, built as ``tests/test_golden.py`` builds them, and the
  explicit live ``SignalBus(period_ms=0)`` check;
* ``run_fleet`` under each autoscale policy with stale, jittered signals,
  a fault schedule with health ejection and hedging, on the fast and the
  general event loop, with ``Observability``'s exported spans, Perfetto
  trace, flight log and windows compared byte for byte;
* the stdout (and trace files) of ``launch/serve.py --cluster`` from both
  launchers.
"""

import dataclasses
import hashlib
import json
import pathlib

import pytest
from test_torch_sim_serving import ref_constants  # noqa: F401 (fixture)

import repro.cluster as ref_cluster
import repro.launch.serve as ref_serve
import repro.serving.engine as ref_engine
import repro_torch.cluster as port_cluster
import repro_torch.launch.serve as port_serve

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden" /
                     "cluster_traces.json").read_text())


# -- tests/test_golden.py's scenario, for either package ----------------------

SEED, LIMIT, N_REPLICAS = 7, 32, 4


def golden_cfg(c):
    spec = c.WorkloadSpec(prompt_range=(128, 512), gen_range=(32, 128),
                          n_pods=2)
    cost = dataclasses.replace(c.knee_cost(spec, LIMIT, oversub=2.0),
                               t_prefill_ms_per_tok=0.05)
    return spec, c.FleetConfig(n_replicas=N_REPLICAS, admission="gcr",
                               active_limit=LIMIT, n_pods=2, cost=cost,
                               prefix_cache_tokens=60_000)


def golden_workload(c):
    spec, cfg = golden_cfg(c)
    cap = c.est_capacity_rps(spec, LIMIT, N_REPLICAS, cfg.cost)
    return c.sessions(2.0 * cap, 1_500.0, spec, seed=SEED, think_ms=800.0)


def trace_rows(replicas):
    completed = sorted((r for eng in replicas for r in eng.completed),
                       key=lambda r: r.rid)
    return [f"{r.rid}:{r.replica}:{r.first_token_ms.hex()}:"
            f"{r.done_ms.hex()}:{r.prefix_hit_tokens}" for r in completed]


def digest(rows):
    return hashlib.sha256("\n".join(rows).encode()).hexdigest()


@pytest.mark.parametrize("policy", port_cluster.ROUTERS)
def test_golden_digest_per_router(policy, ref_constants):
    assert port_cluster.ROUTERS == ref_cluster.ROUTERS
    c = port_cluster
    _, cfg = golden_cfg(c)
    fleet = c.Fleet(cfg.make_engines(), c.make_router(policy, seed=1,
                                                      n_pods=2),
                    c.ClusterTelemetry(c.SLO()))
    res = fleet.run(golden_workload(c), max_ms=60_000.0)
    rows = trace_rows(fleet.replicas)
    assert {"offered": res.offered, "completed": res.completed,
            "n_rows": len(rows), "digest": digest(rows),
            "head": rows[:3]} == GOLDEN[policy]


def test_staleness_zero_is_bit_exact_with_live_bus(ref_constants):
    c = port_cluster
    _, cfg = golden_cfg(c)
    reqs = golden_workload(c)
    via_run_fleet = c.run_fleet(reqs, c.make_router("affinity", seed=1,
                                                    n_pods=2),
                                cfg, max_ms=60_000.0, staleness_ms=0.0)
    fleet = c.Fleet(golden_cfg(c)[1].make_engines(),
                    c.make_router("affinity", seed=1, n_pods=2),
                    c.ClusterTelemetry(c.SLO()),
                    bus=c.SignalBus(slo=c.SLO(), period_ms=0.0))
    res = fleet.run(reqs, max_ms=60_000.0)
    assert digest(trace_rows(fleet.replicas)) == GOLDEN["affinity"]["digest"]
    assert res.completed == GOLDEN["affinity"]["completed"]
    assert dataclasses.asdict(via_run_fleet) == dataclasses.asdict(res)


# -- the workload generators and the fleet topology, at their defaults ---------

WORKLOAD_CALLS = {
    "poisson": lambda c: c.poisson(40.0, 3_000.0),
    "bursty": lambda c: c.bursty(40.0, 3_000.0),
    "diurnal": lambda c: c.diurnal(40.0, 3_000.0),
    "pod_skewed_diurnal": lambda c: c.pod_skewed_diurnal(40.0, 3_000.0),
    "sessions": lambda c: c.sessions(40.0, 3_000.0),
    "uniform": lambda c: c.uniform(64),
    "replay": lambda c: c.replay(c.to_trace(c.bursty(40.0, 3_000.0)),
                                 start_rid=5),
    **{f"make_workload-{kind}": (lambda c, kind=kind: c.make_workload(
        kind, 40.0, 3_000.0)) for kind in port_cluster.WORKLOADS},
}


@pytest.mark.parametrize("kind", list(WORKLOAD_CALLS))
def test_workload_equals_reference_at_its_defaults(kind):
    """Each generator's defaults (the contract table's) give the
    reference's requests, field for field."""
    assert port_cluster.WORKLOADS == ref_cluster.WORKLOADS
    ref = WORKLOAD_CALLS[kind](ref_cluster)
    got = WORKLOAD_CALLS[kind](port_cluster)
    assert len(ref) > 0
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in ref]


def test_fleet_topology_equals_reference_at_its_defaults():
    for kw in ({}, {"n_pods": 2}, {"n_pods": 3, "assignment": {1: 5}}):
        ref, got = ref_cluster.FleetTopology(**kw), \
            port_cluster.FleetTopology(**kw)
        assert repr(got) == repr(ref)
        for top in (ref, got):
            top.assign(4, pod=7)
        assert [got.assign(i) for i in range(7)] == \
            [ref.assign(i) for i in range(7)]
        assert got.partition(range(7)) == ref.partition(range(7))
        for top in (ref, got):
            top.begin_run()
        assert repr(got) == repr(ref)


# -- run_fleet: autoscaling, stale signals, faults, observability -------------


def fleet_run(c, tmp, autoscale, faults, soa):
    spec, cfg = golden_cfg(c)
    cfg = dataclasses.replace(cfg, n_replicas=2)
    reqs = golden_workload(c)
    rpr = c.est_capacity_rps(spec, LIMIT, 1, cfg.cost)
    kw = {}
    if faults:
        kw = dict(faults=c.FaultSchedule(
                      limplocks=[c.Limplock(0, 200.0, 900.0, factor=6.0)],
                      crashes=[c.Crash(1, 400.0, restart_ms=1_100.0)],
                      blackouts=[c.Blackout(0, 300.0, 700.0)]),
                  health=c.HealthPolicy(),
                  hedge=c.HedgePolicy(delay_ms=300.0))
    obs = c.Observability(window_ms=250.0, spans=True, flight=True)
    res = c.run_fleet(reqs, "gcr_aware", cfg, autoscale=autoscale,
                      max_ms=60_000.0, staleness_ms=40.0, jitter_ms=10.0,
                      signal_seed=3, max_replicas=5, rps_per_replica=rpr,
                      router_seed=1, obs=obs, soa_fast_path=soa, **kw)
    files = {k: pathlib.Path(p).read_bytes()
             for k, p in obs.export(str(tmp / "run")).items()}
    return dataclasses.asdict(res), obs.onset(), files


@pytest.mark.parametrize("soa", [True, False], ids=["fast", "general"])
@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("autoscale", ["queue", "slo", "predictive"])
def test_run_fleet_equals_reference(autoscale, faults, soa, tmp_path,
                                    ref_constants):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = fleet_run(ref_cluster, tmp_path / "ref", autoscale, faults, soa)
    got = fleet_run(port_cluster, tmp_path / "port", autoscale, faults, soa)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert sorted(got[2]) == ["flight", "spans", "trace", "windows"]
    for stream in ref[2]:
        assert got[2][stream] == ref[2][stream], stream
    assert ref[0]["completed"] > 0
    if faults:
        assert ref[0]["stats"]["crashes"] == 1


# -- the launcher's --cluster mode ---------------------------------------------

CLUSTER_ARGS = [
    [],
    ["--replicas", "4", "--workload", "bursty", "--router", "gcr_aware"],
    ["--sessions", "--prefix-cache-tokens", "60000", "--router",
     "prefix_aware", "--autoscale", "slo", "--staleness-ms", "50",
     "--signal-jitter-ms", "10", "--window-ms", "500", "--rps", "300",
     "--duration-ms", "2000", "--trace-out", "TRACE"],
    ["--admission", "gcr_pod", "--router", "p2c", "--autoscale",
     "--max-replicas", "6", "--workload", "diurnal", "--rps", "800",
     "--duration-ms", "2000", "--seed", "3"],
    ["--autoscale", "predictive", "--replicas", "2", "--workload",
     "uniform", "--rps", "400", "--duration-ms", "2000",
     "--active-limit", "64", "--window-ms", "250"],
]


@pytest.mark.parametrize("args", CLUSTER_ARGS,
                         ids=["default", "bursty", "sessions_traced",
                              "gcr_pod_queue", "predictive"])
def test_cluster_stdout_equals_reference(args, tmp_path, capsys,
                                         monkeypatch, ref_constants):
    def run(main, tag):
        argv = ["--cluster"] + [str(tmp_path / tag) if a == "TRACE" else a
                                for a in args]
        if main is ref_serve.main:
            monkeypatch.setattr("sys.argv", ["serve"] + argv)
            main()
        else:
            main(argv)
        out = capsys.readouterr().out.replace(str(tmp_path / tag), "TRACE")
        files = {p.name.replace(tag, "TRACE"): p.read_bytes()
                 for p in sorted(tmp_path.glob(f"{tag}.*"))}
        return out, files

    ref = run(ref_serve.main, "ref")
    assert run(port_serve.main, "port") == ref
    assert ref[0].startswith("router=")
    if "TRACE" in args:
        assert len(ref[1]) == 4


# -- the port's own (H100) defaults ------------------------------------------


def cluster_lines(capsys, *args):
    """The summary and scale lines of the port's ``--cluster`` run, as
    dicts of their ``key=value`` fields."""
    port_serve.main(["--cluster", *args])
    out = capsys.readouterr().out.splitlines()
    summary = dict(f.split("=", 1) for f in out[1].split())
    scale = dict(f.split("=", 1) for f in out[2].split()[1:])
    return summary, scale


def test_h100_slo_and_migration_derive_from_the_step_cost():
    from repro_torch.config import H100
    from repro_torch.serving import engine

    slo = port_cluster.SLO()
    assert slo.per_token_ms == 2 * (engine.T_FIXED_MS
                                    + engine.T_TOK_MS * 384)
    # the reference's objective in its own steps of 384 streams, times the
    # H100's step there
    ref_steps = (ref_cluster.SLO().ttft_ms
                 / ref_engine.StepCostModel().step_ms(384, 0, 0.0))
    assert slo.ttft_ms == pytest.approx(
        ref_steps * engine.StepCostModel().step_ms(384, 0, 0.0), rel=1e-12)
    assert slo.ttft_ms == pytest.approx(21_827.0, abs=1.0)
    assert port_cluster.SLO(ttft_ms=2000.0).ttft_ms == 2000.0
    assert port_cluster.SLO(per_token_ms=40.0).per_token_ms == 40.0
    mig = port_cluster.MigrationCost()
    assert mig.base_ms == engine.T_FIXED_MS
    assert mig.bw_bytes_per_ms == H100.network_bw / 1e3
    assert port_serve.PREFILL_MS_PER_TOK == engine.PREFILL_MS_PER_TOK > 0


@pytest.mark.parametrize("autoscale", ["slo", "predictive"])
def test_h100_defaults_give_the_slo_controller_a_signal(autoscale, capsys):
    """Under the port's own defaults the SLO is met in full at light load;
    at the launcher's default 500 rps the fixed fleet misses it for part
    of its requests, and the SLO controller scales out and meets it for
    more of them.  The offered window is twice the launcher's 5 s: the
    queue that 5 s of arrivals leave drains within the H100's TTFT
    objective (``telemetry.TTFT_MS``, about 21.8 s), so only a longer
    window shows the fixed fleet falling behind."""
    window = ("--duration-ms", "10000")
    light, _ = cluster_lines(capsys, "--autoscale", autoscale, "--rps", "60",
                             *window)
    assert light["slo"] == "100%" and light["goodput"] == light["tok/s"]
    fixed, _ = cluster_lines(capsys, *window)
    scaled, scale = cluster_lines(capsys, "--autoscale", autoscale, *window)
    assert 0 < int(fixed["slo"].rstrip("%")) < 100
    assert int(scaled["slo"].rstrip("%")) > int(fixed["slo"].rstrip("%"))
    assert int(scale["out"]) > 0
