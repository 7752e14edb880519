"""Run one cell of the port's benchmark once:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, also the last lines of standard error).  Exits non-zero, printing
no result, without a CUDA card, without the port, or when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# any kernel cache the program keeps (its own nvcc builds go to build/
# already; a Triton or torch extension build would go here) stays inside
# the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# one process, few threads: the host's share of a step is one Python
# thread launching kernels, and idle pools only contend for the cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, smoke=False) -> int:
    """``device`` and ``smoke`` are for the CPU rehearsal, which skips the
    look for a card; the command line always asks for one."""
    import json

    import torch

    from bench import harness, spec

    ns = parse(argv)
    if device is None:
        chips = spec.workload(spec.benchmark(), ns.workload)["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"bench: the cell needs {chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    result = harness.run_cell(ns, device=torch.device(device),
                              t_start=T_START, smoke=smoke)
    bad = harness.banned_modules()
    if bad:
        print(f"bench: the run loaded {bad}; the port must not",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
