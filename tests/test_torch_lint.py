"""The port's determinism-contract linter (``repro_torch.lint``) against
the reference's (``repro.lint``).

* every fixture snippet of ``tests/test_lint.py``, read from that file,
  goes through both linters, the reference's at the snippet's path and the
  port's at its counterpart, and both give the same findings;
* R102's torch clause, which the reference's scanned modules never
  needed (their RNG is JAX's, with no global state);
* ``python -m repro_torch.lint --json`` over the live tree matches the
  committed, empty baseline;
* the contract table is the reference's but for the H100 defaults, each
  pinned by a named port test; the ``__slots__`` roster, ``--explain``
  and the R6 impact map at the port's paths;
* the two properties the linter guards, exercised for real: the port's
  fleet digest under two ``PYTHONHASHSEED`` values, and the linter run
  with ``torch``, ``numpy``, ``jax`` and ``repro`` blocked.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.lint as ref_lint
import repro.lint.contract as ref_contract
import repro.lint.surface as ref_surface
import repro_torch.lint as port_lint
import repro_torch.lint.surface as port_surface
from repro_torch.lint import classify_change, lint_snippet, run_lint
from repro_torch.lint.contract import (BASELINE_PATH, CONTRACT, EXPLAIN,
                                       SLOTS_REQUIRED)
from repro_torch.lint.findings import load_baseline
from repro_torch.lint.impact import AFFECTING, NEUTRAL, classify_path
from repro_torch.lint.surface import check_contract, check_slots

REPO = Path(__file__).resolve().parent.parent
REF_TESTS = REPO / "tests" / "test_lint.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def port_path(path: str) -> str:
    """The port's counterpart of a path a reference fixture lints at."""
    if path.startswith("src/repro/"):
        return "src/repro_torch/" + path[len("src/repro/"):]
    # benchmarks/ is not ported: its allowlisted timing harness maps to the
    # port's (calibrate.py), any other benchmark file to a scanned path
    # outside the tie-break scope and the allowlist, as it was
    return {"benchmarks/perf_guard.py": "src/repro_torch/serving/calibrate.py",
            "benchmarks/x.py": "src/repro_torch/core/x.py"}[path]


# -- the reference's fixture snippets -----------------------------------------

def _string(node, names):
    """A snippet argument's text: a literal, ``textwrap.dedent`` of one,
    or a local name bound to one."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return names.get(node.id)
    if isinstance(node, ast.Call) and ast.unparse(node.func) in (
            "textwrap.dedent", "dedent") and node.args:
        return _string(node.args[0], names)
    return None


def _reference_snippets():
    """(test name, helper, snippet, reference path) for every snippet the
    reference's fixture tests lint, read from ``tests/test_lint.py``."""
    tree = ast.parse(REF_TESTS.read_text())
    consts = {t.id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign)
              and isinstance(n.value, ast.Constant)
              for t in n.targets if isinstance(t, ast.Name)}
    default = {"rules_of": consts["CLUSTER_PATH"],
               "lint_snippet": consts["CLUSTER_PATH"],
               "_topo_findings": consts["TOPO"],
               "_slots_findings": consts["ADMISSION"]}
    cases = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        names = {n.targets[0].id: n.value.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign) and len(n.targets) == 1
                 and isinstance(n.targets[0], ast.Name)
                 and isinstance(n.value, ast.Constant)
                 and isinstance(n.value.value, str)}
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id in default]
        for call in sorted(calls, key=lambda c: (c.lineno, c.col_offset)):
            src = _string(call.args[0], names)
            if src is None:
                continue
            path = default[call.func.id]
            for arg in call.args[1:2] + [k.value for k in call.keywords
                                         if k.arg == "path"]:
                path = arg.value
            cases.append((fn.name, call.func.id, textwrap.dedent(src), path))
    return cases


SNIPPETS = _reference_snippets()


def _findings(mod_lint, mod_surface, helper, src, path):
    if helper in ("rules_of", "lint_snippet"):
        found = mod_lint.lint_snippet(src, path)
    elif helper == "_topo_findings":
        found = mod_surface.check_contract({path: src}, REPO)
    else:
        found = mod_surface.check_slots({path: src})
    return [(f.rule, f.line, f.scope, f.suppressed) for f in found
            if f.path == path]


def test_every_reference_fixture_snippet_was_found():
    helpers = {h for _, h, _, _ in SNIPPETS}
    assert helpers == {"rules_of", "lint_snippet", "_topo_findings",
                       "_slots_findings"}
    # each helper call with a snippet in tests/test_lint.py: 26 through
    # rules_of, 2 lint_snippet, 6 contract and 3 slots fixtures
    assert len(SNIPPETS) >= 37
    assert not [c for c in SNIPPETS if not c[2].strip()]


@pytest.mark.parametrize(
    "test,helper,src,path", SNIPPETS,
    ids=[f"{t}-{i}" for i, (t, _, _, _) in enumerate(SNIPPETS)])
def test_fixture_snippet_gives_the_reference_findings(test, helper, src,
                                                      path):
    want = _findings(ref_lint, ref_surface, helper, src, path)
    got = _findings(port_lint, port_surface, helper, src, port_path(path))
    assert got == want


# -- R102: torch's process-global RNG -----------------------------------------

TORCH_GLOBAL_RNG = [
    "torch.manual_seed(0)",
    "torch.seed()",
    "torch.random.manual_seed(0)",
    "torch.rand(3)",
    "torch.randn(2, 3)",
    "torch.randint(0, 5, (3,))",
    "torch.randperm(4)",
    "torch.bernoulli(p)",
    "torch.multinomial(p, 2)",
    "torch.normal(0.0, 1.0, (3,))",
    "torch.rand_like(p)",
    "torch.randn_like(p)",
    "torch.randint_like(p, 5)",
]


@pytest.mark.parametrize("call", TORCH_GLOBAL_RNG)
def test_r102_flags_torch_global_rng_and_passes_a_generator(call):
    src = f"import torch\ndef draw(p):\n    return {call}\n"
    assert [f.rule for f in lint_snippet(src)] == ["R102"]
    # the reference's scanned modules drew only from JAX's keys
    assert ref_lint.lint_snippet(src) == []
    if "seed" not in call:
        seeded = call[:-1] + (", " if call[-2] != "(" else "") \
            + "generator=g)"
        ok = ("import torch\ndef draw(p, seed):\n"
              "    g = torch.Generator().manual_seed(seed)\n"
              f"    return {seeded}\n")
        assert lint_snippet(ok) == []


def test_r102_resolves_torch_import_aliases():
    assert [f.rule for f in lint_snippet(
        "from torch import randn\ndef draw():\n    return randn(3)\n")] \
        == ["R102"]
    assert [f.rule for f in lint_snippet(
        "import torch as T\ndef draw():\n    return T.rand(3)\n")] \
        == ["R102"]
    assert lint_snippet(
        "import torch\ndef make(seed):\n"
        "    return torch.Generator(device='cpu').manual_seed(seed)\n") == []


# -- the live tree ------------------------------------------------------------

def test_live_tree_is_clean_against_the_empty_baseline():
    result = run_lint(REPO)
    assert result.ok, "\n" + result.render_text()
    committed = load_baseline(REPO / BASELINE_PATH)
    assert committed == []
    active = sorted(f.key for f in result.findings if not f.suppressed)
    assert active == committed
    # the reference's two suppressions, carried over, and nothing else
    assert sorted((f.path, f.rule) for f in result.findings) == [
        ("src/repro_torch/cluster/fleet.py", "R203"),
        ("src/repro_torch/cluster/obs.py", "R203")]
    scanned = {f.split("/")[2] for f in port_lint.collect_sources(REPO)}
    assert scanned == {"cluster", "serving", "core"}


def test_cli_json_over_live_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "--json"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] is True
    assert payload["new"] == [] and payload["stale_baseline"] == []
    assert payload["counts"]["suppressed"] == payload["counts"]["total"] == 2


# -- R3: the contract, R5: the slots roster -----------------------------------

# the defaults that are the H100's, not the reference's, and the port test
# holding each surface's derivation
H100_DEFAULTS = {
    ("src/repro_torch/serving/engine.py", "StepCostModel"): (
        {"t_fixed_ms", "t_tok_ms", "kv_bytes_per_tok", "hbm_budget",
         "thrash_coef", "t_xpod_ms"},
        "tests/test_torch_sim_serving.py",
        "test_cost_defaults_derive_from_the_h100_spec"),
    ("src/repro_torch/cluster/controller.py", "MigrationCost"): (
        {"base_ms", "bw_bytes_per_ms"}, "tests/test_torch_cluster.py",
        "test_h100_slo_and_migration_derive_from_the_step_cost"),
    ("src/repro_torch/cluster/telemetry.py", "SLO"): (
        {"ttft_ms", "per_token_ms"}, "tests/test_torch_cluster.py",
        "test_h100_slo_and_migration_derive_from_the_step_cost"),
}


def test_contract_is_the_references_but_for_the_h100_defaults():
    ref_table = {p: s for p, s in ref_contract.CONTRACT.items()
                 if not p.startswith("benchmarks/")}
    assert sorted(port_path(p) for p in ref_table) == sorted(CONTRACT)
    drift = {}
    for ref_p, surfaces in ref_table.items():
        port = CONTRACT[port_path(ref_p)]
        assert list(port) == list(surfaces), ref_p
        for name, entry in surfaces.items():
            got = port[name]["params"]
            assert list(got) == list(entry["params"]), (ref_p, name)
            differs = {k for k, v in entry["params"].items() if got[k] != v}
            if differs:
                drift[(port_path(ref_p), name)] = differs
            pinned = REPO / port[name]["pinned_by"]
            assert pinned.name.startswith("test_torch_") and pinned.exists()
    assert drift == {k: v[0] for k, v in H100_DEFAULTS.items()}
    for (path, name), (_, test_file, test) in H100_DEFAULTS.items():
        assert CONTRACT[path][name]["pinned_by"] == test_file
        assert f"def {test}(" in (REPO / test_file).read_text()


def test_contract_holds_the_live_tree_and_catches_a_default_edit():
    sources = port_lint.collect_sources(REPO)
    assert check_contract(sources, REPO) == []
    path = "src/repro_torch/serving/engine.py"
    edited = sources[path].replace("t_fixed_ms: float = T_FIXED_MS",
                                   "t_fixed_ms: float = 40.0")
    assert edited != sources[path]
    found = [f for f in check_contract({path: edited}, REPO)
             if f.path == path]
    assert [(f.rule, f.scope) for f in found] == [("R302", "StepCostModel")]
    assert "t_fixed_ms=40.0" in found[0].message


def test_slots_roster_is_the_references_at_the_port_paths():
    assert list(SLOTS_REQUIRED) == [(port_path(p), c) for p, c in
                                    ref_contract.SLOTS_REQUIRED]
    assert check_slots(port_lint.collect_sources(REPO)) == []


# -- --explain ------------------------------------------------------------------

def test_cli_explain_prints_each_rule():
    assert sorted(EXPLAIN) == sorted(ref_contract.EXPLAIN)
    for rule in EXPLAIN:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.lint", "--explain", rule],
            cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=60)
        assert proc.returncode == 0
        assert "DESIGN.md" in proc.stdout
    assert "calibrate.py" in EXPLAIN["R101"][1]
    assert "torch.Generator" in EXPLAIN["R102"][1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "--explain", "R999"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2


# -- R6: the golden-impact analyzer ---------------------------------------------

def test_impact_telemetry_wording_change_is_neutral():
    path = "src/repro_torch/cluster/telemetry.py"
    old = (REPO / path).read_text()
    new = old.replace('f"tok/s={', 'f"tokens/s={', 1)
    assert old != new
    assert classify_change(path, old, new).verdict == NEUTRAL


def test_impact_engine_tiebreak_change_is_affecting():
    path = "src/repro_torch/serving/engine.py"
    old = (REPO / path).read_text()
    new = old.replace("key=lambda r: (r.arrive_ms, r.rid)",
                      "key=lambda r: r.arrive_ms")
    assert old != new
    assert classify_change(path, old, new).verdict == AFFECTING


def test_impact_comment_only_engine_change_is_neutral():
    path = "src/repro_torch/serving/engine.py"
    old = (REPO / path).read_text()
    new = old + "\n# a trailing comment changes no AST node\n"
    got = classify_change(path, old, new)
    assert got.verdict == NEUTRAL
    assert "AST is unchanged" in got.reason


@pytest.mark.parametrize("path", [
    "src/repro/serving/engine.py", "src/repro/cluster/fleet.py",
    "src/repro_torch/serving/calibrate.py",
    "src/repro_torch/cluster/invariants.py",
    "src/repro_torch/lint/rules.py", "src/repro_torch/examples/trace_demo.py",
    "src/repro_torch/models/transformer.py", "tests/test_torch_cluster.py",
    "examples/cluster_demo.py", "chip_smoke.py", "PERF.md"])
def test_impact_outside_the_port_trace_graph_is_neutral(path):
    assert classify_change(path, "a = 1\n", "a = 2\n").verdict == NEUTRAL


@pytest.mark.parametrize("path", [
    "src/repro_torch/cluster/fleet.py", "src/repro_torch/cluster/router.py",
    "src/repro_torch/serving/engine.py", "src/repro_torch/core/admission.py"])
def test_impact_inside_the_port_trace_graph_is_affecting(path):
    assert classify_path(path).verdict == AFFECTING
    assert classify_change(path, "a = 1\n", "a = 2\n").verdict == AFFECTING


def test_impact_cli_runs_against_git():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "--impact", "HEAD",
         "--json"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    if proc.returncode == 2:        # not a git checkout (an archive)
        pytest.skip("no git history available")
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["verdict"] in (NEUTRAL, AFFECTING)


# -- the contract, exercised for real -------------------------------------------

_HASHSEED_SCRIPT = textwrap.dedent("""
    import hashlib
    from repro_torch.cluster import (SLO, ClusterTelemetry, Fleet,
                                     FleetConfig, WorkloadSpec, make_router,
                                     sessions)

    spec = WorkloadSpec(prompt_range=(64, 128), gen_range=(16, 32),
                        n_pods=2)
    reqs = sessions(6.0, 1_200.0, spec, seed=3, think_ms=300.0)
    cfg = FleetConfig(n_replicas=2, admission="gcr", active_limit=16,
                      n_pods=2)
    fleet = Fleet(cfg.make_engines(), make_router("gcr_aware", n_pods=2),
                  ClusterTelemetry(SLO()))
    fleet.run(reqs, max_ms=300_000.0)
    rows = sorted((r for eng in fleet.replicas for r in eng.completed),
                  key=lambda r: r.rid)
    assert len(rows) == len(reqs) > 0
    blob = "\\n".join(
        f"{r.rid}:{r.replica}:{r.first_token_ms.hex()}:{r.done_ms.hex()}"
        for r in rows)
    print(hashlib.sha256(blob.encode()).hexdigest())
""")


def test_port_trace_digest_is_hash_seed_independent():
    digests = []
    for seed in ("0", "1"):
        env = _env()
        env["PYTHONHASHSEED"] = seed
        proc = subprocess.run([sys.executable, "-c", _HASHSEED_SCRIPT],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        digests.append(proc.stdout.strip())
    assert digests[0] == digests[1]
    assert len(digests[0]) == 64


_BLOCKED_SCRIPT = textwrap.dedent("""
    import runpy
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("torch", "numpy", "jax", "jaxlib",
                                      "repro"):
                raise ImportError(f"{name} blocked for the lint-only test")
            return None

    sys.meta_path.insert(0, _Block())

    import repro_torch.lint
    from repro_torch.lint.cli import main

    assert main(["--explain", "R101"]) == 0
    sys.argv = ["repro_torch.lint", "--json"]
    try:
        runpy.run_module("repro_torch.lint", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        assert e.code == 0, e.code
    bad = sorted(m for m in sys.modules if m.split(".")[0] in (
        "torch", "numpy", "jax", "jaxlib", "repro"))
    assert not bad, bad
    print("ok")
""")


def test_lint_imports_and_runs_with_torch_numpy_jax_and_repro_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SCRIPT],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert '"ok": true' in proc.stdout
