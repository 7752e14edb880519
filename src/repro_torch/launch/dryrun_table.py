"""Print the dry run's records as one markdown table.

Usage:  python -m repro_torch.launch.dryrun_table [DIR]

DIR (default ``experiments/dryrun_torch``) holds one folder a mesh
(``16x16``, ``2x16x16``) of ``<arch>__<shape>.json`` records, as
``python -m repro_torch.launch.dryrun --all [--multi-pod]`` writes them.
One row a cell, both meshes side by side: per-device peak GB ("(no)"
where it does not fit 80 GB), TFLOP, GB moved through HBM, collective GB
by mesh dim, the three roofline terms in ms and the dominant one, and the
seconds the cell took to trace.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from .dryrun import OUT_DIR

MESHES = ("16x16", "2x16x16")


def _cells(recs: dict, fmt) -> str:
    return " / ".join(fmt(recs[m]) if m in recs else "-" for m in MESHES)


def _coll(rec: dict) -> str:
    return " ".join(
        f"{dim[0]} {sum(k['bytes'] for k in kinds.values()) / 1e9:.3f}"
        for dim, kinds in sorted(rec["collectives_by_dim"].items())
        if dim != "world")


def _terms(rec: dict) -> str:
    t = rec["roofline"]
    return ", ".join(f"{t[k] * 1e3:.1f}" for k in
                     ("compute_s", "memory_s", "collective_s"))


def _row(arch: str, shape: str, recs: dict) -> str:
    cols = [
        _cells(recs, lambda r: f"{r['memory']['peak_bytes'] / 1e9:.2f}"
               + ("" if r["fits"] else " (no)")),
        _cells(recs, lambda r: f"{r['flops'] / 1e12:.3f}"),
        _cells(recs, lambda r: f"{r['bytes'] / 1e9:.1f}"),
        _cells(recs, _coll),
        _cells(recs, _terms),
        _cells(recs, lambda r: r["dominant"].split("_")[0]),
        _cells(recs, lambda r: f"{r['trace_s']}"),
    ]
    return f"| {arch} | {shape} | " + " | ".join(cols) + " |"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    base = Path(argv[0]) if argv else OUT_DIR
    cells: dict = {}
    for mesh in MESHES:
        for path in sorted((base / mesh).glob("*.json")):
            rec = json.loads(path.read_text())
            cells.setdefault((rec["arch"], rec["shape"]), {})[mesh] = rec
    print("Each cell: (16, 16) / (2, 16, 16).  Collective GB by mesh dim "
          "(d data, m model, p pod); roofline terms compute, memory, "
          "collective in ms.\n")
    print("| Arch | Shape | Peak GB | TFLOP | HBM GB | Collective GB | "
          "Terms ms | Dominant | Trace s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for (arch, shape), recs in sorted(cells.items()):
        print(_row(arch, shape, recs))
    n = sum(len(r) for r in cells.values())
    print(f"\n{n} records")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
