"""The legacy-default contract table (R3), the hot-path ``__slots__``
roster (R5), scan scope, allowlists, and rule rationales: the port's copy
of ``repro.lint.contract``, over ``src/repro_torch/``.

What differs from the reference's, and nothing else:

* the paths are the port's, and ``benchmarks/`` (not ported) is neither
  scanned nor in the table;
* each surface is pinned by the port test that holds it against the
  reference (``tests/test_torch_cluster.py``'s golden digests, run_fleet
  and ``--cluster`` equalities, ``tests/test_torch_sim_serving.py``'s
  engine equalities);
* the defaults that are the H100's and not the reference's:
  ``StepCostModel``'s six cost terms, ``MigrationCost``'s two and
  ``SLO``'s two objectives, each spelled as the port's source spells it
  and derived in that module's docstring;
* the wall-clock allowlist names the port's real-thread lock layer and
  ``serving/calibrate.py``, the card's timing harness.

R3 is the machine-checked form of DESIGN.md 3's "legacy-bit-identical
knob defaults" clause: every public config-surface knob must (a) carry
a default, (b) have that default registered here with the *source-level
spelling* (``ast.unparse`` form, so ``0.6 * H100.hbm_bytes`` stays
an expression, not a rounded float), and (c) name the bit-identity test
that pins it.  Changing a default then forces a same-PR edit to this
table, which is exactly the reviewable event the contract wants.

Entries map ``param -> (default_source, )`` or ``REQUIRED`` for
parameters that are intentionally positional/required.  ``pinned_by``
names the tier-1 test file whose goldens/equivalences would catch a
silent drift of that surface.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["REQUIRED", "CONTRACT", "SLOTS_REQUIRED", "SCAN_ROOTS",
           "TIEBREAK_PREFIXES", "WALLCLOCK_ALLOWLIST", "EXPLAIN",
           "BASELINE_PATH"]

# sentinel: parameter is required-by-design, must NOT grow a default
REQUIRED = None

# where the committed grandfather ledger lives, repo-relative
BASELINE_PATH = "src/repro_torch/lint/baseline.json"

# directories whose .py files the linter scans (repo-relative).  The
# model/kernel side of the port is out of scope: its numerics are pinned
# by their own test tiers and it never feeds the virtual-time traces.
SCAN_ROOTS = (
    "src/repro_torch/cluster",
    "src/repro_torch/serving",
    "src/repro_torch/core",
)

# R203 (float tie-break) only applies where the event-calendar contract
# does: the trace-producing simulation layers.
TIEBREAK_PREFIXES = ("src/repro_torch/cluster/", "src/repro_torch/serving/")

# files allowed to read wall clocks / real threads (R101): the L0
# real-thread lock layer (DESIGN.md 2) and the card's timing harness
# (``calibrate`` times the decode step that StepCostModel's H100 defaults
# are fitted to, the counterpart of the reference's benchmark harnesses),
# which measure the host or the card on purpose and never feed a
# virtual-time trace
WALLCLOCK_ALLOWLIST = frozenset({
    "src/repro_torch/core/locks.py",
    "src/repro_torch/core/waiting.py",
    "src/repro_torch/serving/calibrate.py",
})

# -- R3: the contract table -------------------------------------------------
# {path: {surface_name: {"pinned_by": test, "params": {name: default_src}}}}
Contract = Dict[str, Dict[str, Dict[str, object]]]

CONTRACT: Contract = {
    "src/repro_torch/cluster/fleet.py": {
        "FleetConfig": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "n_replicas": "4",
                "admission": "'gcr'",
                "active_limit": "128",
                "n_pods": "2",
                "promote_every": "64",
                "cost": "None",
                "active_limits": "None",
                "costs": "None",
                "prefix_cache_tokens": "0",
                "leap_stepping": "True",
            },
        },
        "run_fleet": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "requests": REQUIRED,
                "router": REQUIRED,
                "cfg": "None",
                "slo": "None",
                "autoscale": "False",
                "max_ms": "120000.0",
                "staleness_ms": "0.0",
                "jitter_ms": "0.0",
                "signal_seed": "0",
                "max_replicas": "8",
                "rps_per_replica": "None",
                "router_seed": "None",
                "victim": "'least_outstanding'",
                "pod_scoped": "False",
                "season_period_ms": "None",
                "obs": "None",
                "faults": "None",
                "health": "None",
                "hedge": "None",
                "soa_fast_path": "True",
                "fast_path_coverage": "'full'",
                "leap_fault_cap": "0",
            },
        },
        "knee_cost": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "spec": REQUIRED,
                "active_limit": REQUIRED,
                "oversub": "2.0",
            },
        },
    },
    "src/repro_torch/serving/engine.py": {
        "StepCostModel": {
            "pinned_by": "tests/test_torch_sim_serving.py",
            "params": {
                # H100: serving/engine.py's module docstring
                "t_fixed_ms": "T_FIXED_MS",
                "t_tok_ms": "T_TOK_MS",
                "kv_bytes_per_tok": "KV_BYTES_PER_TOK",
                "hbm_budget": "0.6 * H100.hbm_bytes",
                "thrash_coef": "THRASH_COEF",
                "t_xpod_ms": "T_XPOD_MS",
                "t_prefill_ms_per_tok": "0.0",
            },
        },
        "SimServeEngine": {
            "pinned_by": "tests/test_torch_sim_serving.py",
            "params": {
                "admission": REQUIRED,
                "cost": "None",
                "avg_prompt": "512",
                "prefix_cache": "None",
                "leap_stepping": "True",
            },
        },
        "PrefixCache": {
            "pinned_by": "tests/test_torch_sim_serving.py",
            "params": {"capacity_tokens": REQUIRED},
        },
        "make_admission": {
            "pinned_by": "tests/test_torch_sim_serving.py",
            "params": {
                "kind": REQUIRED,
                "active_limit": REQUIRED,
                "n_pods": "2",
                "promote_every": "64",
            },
        },
    },
    "src/repro_torch/cluster/telemetry.py": {
        "SLO": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                # H100: derived from the step cost (telemetry.py)
                "ttft_ms": "field(default_factory=lambda: TTFT_MS)",
                "per_token_ms": "field(default_factory=lambda: "
                                "PER_TOKEN_MS)",
            },
        },
    },
    "src/repro_torch/cluster/signals.py": {
        "SignalBus": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "slo": "None",
                "period_ms": "0.0",
                "jitter_ms": "0.0",
                "seed": "0",
            },
        },
    },
    "src/repro_torch/cluster/controller.py": {
        "MigrationCost": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                # H100: one step floor, the network link (controller.py)
                "base_ms": "T_FIXED_MS",
                "bw_bytes_per_ms": "H100.network_bw / 1000.0",
            },
        },
        "QueueDepthAutoscaler": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "cfg": REQUIRED,
                "max_replicas": "8",
                "parked_per_replica": "None",
                "cooldown_ms": "2000.0",
            },
        },
        "SLOAutoscaler": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "cfg": REQUIRED,
                "max_replicas": "8",
                "min_replicas": "1",
                "target_attainment": "0.95",
                "scale_in_util": "0.6",
                "cooldown_out_ms": "1000.0",
                "cooldown_in_ms": "2500.0",
                "predictive": "False",
                "lead_ms": "5000.0",
                "rps_per_replica": "None",
                "history": "8",
                "season_period_ms": "None",
                "victim": "'least_outstanding'",
                "pod_scoped": "False",
                "min_per_pod": "1",
            },
        },
        "make_autoscaler": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "kind": REQUIRED,
                "cfg": REQUIRED,
                "rps_per_replica": "None",
                "max_replicas": "8",
                "victim": "'least_outstanding'",
                "pod_scoped": "False",
                "season_period_ms": "None",
            },
        },
    },
    "src/repro_torch/cluster/router.py": {
        "RoundRobinRouter": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {},
        },
        "LeastOutstandingRouter": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {},
        },
        "PowerOfTwoRouter": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {"seed": "0"},
        },
        "GCRAwareRouter": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {"n_pods": "2", "topology": "None"},
        },
        "AffinityRouter": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "n_pods": "2",
                "min_headroom_frac": "0.0",
                "spill_slack": "0.25",
                "cache_slack": "0.0",
                "topology": "None",
            },
        },
        "PrefixAwareRouter": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "n_pods": "2",
                "min_headroom_frac": "0.0",
                "spill_slack": "0.25",
                "topology": "None",
            },
        },
        "make_router": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "name": REQUIRED,
                "seed": "0",
                "n_pods": "2",
                "topology": "None",
            },
        },
    },
    "src/repro_torch/cluster/faults.py": {
        "Limplock": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "replica": REQUIRED,
                "start_ms": REQUIRED,
                "end_ms": REQUIRED,
                "factor": "8.0",
            },
        },
        "Crash": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "replica": REQUIRED,
                "at_ms": REQUIRED,
                "restart_ms": "None",
                "policy": "'requeue'",
            },
        },
        "Blackout": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "replica": REQUIRED,
                "start_ms": REQUIRED,
                "end_ms": REQUIRED,
            },
        },
        "FaultSchedule": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "limplocks": "()",
                "crashes": "()",
                "blackouts": "()",
            },
        },
        "HedgePolicy": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "delay_ms": "400.0",
                "max_hedges": "1",
            },
        },
        "HealthPolicy": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "ewma_alpha": "0.3",
                "rate_frac": "0.5",
                "min_reports": "3",
                "stale_ms": "0.0",
                "max_eject_frac": "0.5",
            },
        },
    },
    "src/repro_torch/cluster/topology.py": {
        "FleetTopology": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {"n_pods": "1", "assignment": "None"},
        },
    },
    "src/repro_torch/cluster/obs.py": {
        "Observability": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "window_ms": "0.0",
                "spans": "True",
                "flight": "True",
                "slo": "None",
                "prealloc_windows": "256",
            },
        },
    },
    "src/repro_torch/cluster/workload.py": {
        "WorkloadSpec": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "prompt_range": "(256, 1024)",
                "gen_range": "(64, 256)",
                "n_pods": "2",
            },
        },
        "poisson": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "rps": REQUIRED,
                "duration_ms": REQUIRED,
                "spec": "DEFAULT_SPEC",
                "seed": "0",
                "start_rid": "0",
            },
        },
        "bursty": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "rps": REQUIRED,
                "duration_ms": REQUIRED,
                "spec": "DEFAULT_SPEC",
                "seed": "0",
                "burst_factor": "4.0",
                "dwell_ms": "(2000.0, 500.0)",
                "start_rid": "0",
            },
        },
        "diurnal": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "rps_peak": REQUIRED,
                "duration_ms": REQUIRED,
                "spec": "DEFAULT_SPEC",
                "seed": "0",
                "floor": "0.1",
                "start_rid": "0",
                "cycles": "1",
                "phase": "0.0",
            },
        },
        "pod_skewed_diurnal": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "rps_peak": REQUIRED,
                "duration_ms": REQUIRED,
                "spec": "DEFAULT_SPEC",
                "seed": "0",
                "floor": "0.1",
                "cycles": "1",
                "phases": "(0.0, 0.25)",
                "amp_scale": "None",
                "floors": "None",
            },
        },
        "sessions": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "rps": REQUIRED,
                "duration_ms": REQUIRED,
                "spec": "DEFAULT_SPEC",
                "seed": "0",
                "turns_range": "(2, 6)",
                "think_ms": "1500.0",
                "followup_range": "(16, 96)",
                "start_rid": "0",
                "prefix_groups": "0",
                "group_zipf": "1.2",
                "sys_prompt_range": "(128, 512)",
            },
        },
        "uniform": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "n": REQUIRED,
                "window_ms": "500.0",
                "spec": "DEFAULT_SPEC",
                "seed": "0",
                "start_rid": "0",
            },
        },
        "replay": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {"trace": REQUIRED, "start_rid": "0"},
        },
        "make_workload": {
            "pinned_by": "tests/test_torch_cluster.py",
            "params": {
                "kind": REQUIRED,
                "rps": REQUIRED,
                "duration_ms": REQUIRED,
                "spec": "DEFAULT_SPEC",
                "seed": "0",
            },
        },
    },
}

# -- R5: hot-path classes that must declare __slots__ -----------------------
# (path, class); satisfied by a `__slots__ = (...)` class attribute or a
# `@dataclass(slots=True)` decoration
SLOTS_REQUIRED: Tuple[Tuple[str, str], ...] = (
    ("src/repro_torch/serving/engine.py", "Request"),
    ("src/repro_torch/serving/engine.py", "SimServeEngine"),
    ("src/repro_torch/core/admission.py", "StreamState"),
    ("src/repro_torch/core/admission.py", "GCRAdmission"),
    ("src/repro_torch/core/admission.py", "NoAdmission"),
    ("src/repro_torch/core/pod_aware.py", "GCRPod"),
    ("src/repro_torch/cluster/signals.py", "ReplicaView"),
)

# -- --explain texts --------------------------------------------------------
# rule id -> (DESIGN.md section, rationale)
EXPLAIN: Dict[str, Tuple[str, str]] = {
    "R101": ("DESIGN.md 3", (
        "Wall-clock reads (time.time, perf_counter, datetime.now) make a "
        "trace depend on host speed. All simulation time must come from "
        "the virtual clock the event calendar advances; only the L0 "
        "real-thread lock layer (core/locks.py, core/waiting.py) and the "
        "card's timing harness (serving/calibrate.py, which times the "
        "decode step StepCostModel's H100 defaults are fitted to) are "
        "allowlisted because measuring the host or the card is their "
        "job.")),
    "R102": ("DESIGN.md 3", (
        "Module-level random.*, legacy np.random.*, torch.manual_seed / "
        "torch.seed, torch's sampling functions (rand, randn, randint, "
        "randperm, bernoulli, multinomial, normal and the _like forms) "
        "called without generator=, os.urandom, secrets and uuid1/uuid4 "
        "draw from process-global or OS entropy, so two runs with the "
        "same config diverge. The sanctioned idioms are a seeded "
        "random.Random(seed) instance, np.random.default_rng(seed) and "
        "a seeded torch.Generator passed as generator=.")),
    "R103": ("DESIGN.md 3", (
        "Builtin hash() of str/bytes is salted by PYTHONHASHSEED, so any "
        "ordering or key derived from it changes across interpreter "
        "launches. Derive keys from explicit integers (rid, seq) or "
        "hashlib digests instead.")),
    "R201": ("DESIGN.md 3", (
        "Iterating a set/frozenset yields PYTHONHASHSEED-dependent order. "
        "If that order reaches observable state (dispatch order, a trace "
        "row, a heap payload) the trace is no longer bit-stable. Wrap in "
        "sorted(...) or keep a dict/list, whose order is insertion "
        "history.")),
    "R202": ("DESIGN.md 3", (
        ".popitem() without last= documents nothing about which end is "
        "popped; on an OrderedDict the call site must say last=False "
        "(LRU evict) or last=True (stack pop) so the eviction order is "
        "part of the source contract.")),
    "R203": ("DESIGN.md 3", (
        "Virtual timestamps are floats and collide (simultaneous "
        "arrivals, equal deadlines). sorted/min/max/heappush on a bare "
        "float key resolves ties by input order or heap shape - state "
        "that is not part of the contract. Every ordering key in "
        "cluster/ and serving/ must be the (float, int_seq) tuple, e.g. "
        "(t, next(self._seq)) or (r.arrive_ms, r.rid).")),
    "R301": ("DESIGN.md 3, 10", (
        "Every public config-surface knob must carry a default so that "
        "zero-argument construction reproduces the legacy bit-identical "
        "behavior the goldens pin. A defaultless knob forces every "
        "caller to choose, and choices drift.")),
    "R302": ("DESIGN.md 3, 10", (
        "A knob's default no longer matches the contract table in "
        "lint/contract.py (or the table lists a knob the code dropped). "
        "Changing a default is allowed - but only together with the "
        "table edit and the golden regen/bit-identity argument the "
        "pinned_by test demands, in the same PR.")),
    "R303": ("DESIGN.md 10", (
        "A new knob appeared on a registered config surface but is not "
        "in the contract table, so nothing links it to the golden test "
        "that would catch its drift. Register it in lint/contract.py "
        "with its default's source spelling and a pinned_by test.")),
    "R304": ("DESIGN.md 10", (
        "The contract table names a pinned_by test file that does not "
        "exist - the default is 'pinned' by nothing. Point it at the "
        "golden/equivalence suite that actually exercises the surface.")),
    "R401": ("DESIGN.md 3", (
        "GridPoint/run_grid units cross a process boundary and must "
        "pickle. Lambdas, nested functions, generators and local classes "
        "fail at submission time on some platforms and silently "
        "serialize differently on others. Pass module-level callables "
        "and plain data.")),
    "R501": ("DESIGN.md 3", (
        "Hot-path classes (engine, admissions, Request, StreamState, "
        "replica views) are instantiated millions of times per sweep; "
        "__slots__ (or @dataclass(slots=True)) removes the per-instance "
        "dict, and also catches attribute-name typos that would "
        "otherwise create silent new state.")),
    "R6": ("DESIGN.md 3, 10", (
        "python -m repro_torch.lint --impact BASE..HEAD classifies a "
        "diff as trace-affecting or trace-neutral for the port's traces. "
        "Neutral: tests, benchmarks, examples, docs, CI, telemetry "
        "aggregation, the card's timing harness (serving/calibrate.py), "
        "the lint package itself, the reference package src/repro/, and "
        "any source edit whose docstring-stripped AST is unchanged "
        "(comments/formatting). Everything else under "
        "src/repro_torch/{cluster,serving,core} that feeds the "
        "fleet/engine path is conservatively trace-affecting "
        "and requires either a bit-identity argument in the PR or a "
        "golden regen per DESIGN.md 3.")),
}


def explain(rule: str) -> Optional[str]:
    """Human-readable rationale for ``--explain RULE``."""
    hit = EXPLAIN.get(rule.upper())
    if hit is None:
        return None
    section, text = hit
    return f"{rule.upper()}  (enforces {section})\n\n{text}"
