"""The benchmark stands apart: no module under ``bench/`` imports
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (top-level
names compared whole: ``repro_torch`` is not ``repro``), and nothing
under ``bench/reference/`` imports the port ``repro_torch`` either; shown
on the sources and by importing every module with those names
blocked.  Outside ``bench/reference/`` no module imports a reference by
name: a configuration's ``reference`` key names it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_nor_repro():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) >= 15
    for path in files:
        banned = set(BANNED)
        if "reference" in path.relative_to(BENCH).parts:
            banned.add("repro_torch")
        assert not _imports(path) & banned, path


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            names |= {base} | {f"{base}.{a.name}".replace("..", ".")
                               for a in node.names}
    return names


def test_only_a_configuration_names_its_reference():
    for path in sorted(BENCH.rglob("*.py")):
        if "reference" in path.relative_to(BENCH).parts:
            continue
        named = {n for n in _imported_modules(path)
                 if n.split(".")[-1] == "reference"
                 or ".reference." in f".{n}."}
        assert not named, (path, named)


_BLOCKED = r"""
import importlib, pkgutil, sys
blocked = set(sys.argv[2].split(","))

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError(f"{name} blocked")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import bench
names = [m.name for m in pkgutil.walk_packages(bench.__path__, "bench.")
         if m.name.startswith(sys.argv[3])
         and ".tests" not in m.name]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in blocked]
print(" ".join(names))
"""


def _import_all(blocked, prefix):
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, str(ROOT),
                           ",".join(sorted(blocked)), prefix], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_every_module_imports_with_jax_and_repro_blocked():
    names = _import_all(BANNED, "bench")
    assert "bench.harness" in names and "bench.reference.decoder" in names


def test_reference_imports_with_the_port_blocked_too():
    names = _import_all(BANNED | {"repro_torch"}, "bench.reference")
    assert set(names) == {"bench.reference", "bench.reference.decoder"}
