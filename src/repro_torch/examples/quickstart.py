"""Quickstart: GCR in 60 seconds.

1. Wrap any lock with GCR and survive oversubscription (simulator demo).
2. Serve with GCR admission and avoid the serving-level collapse.

The port of ``examples/quickstart.py``, with the reference's settings, on
the port's H100 step costs (``serving/engine.py``); it touches no device.
Run:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

import numpy as np

from ..core import gcr_wrap, make_lock
from ..core.simulator import run_sim
from ..serving.engine import Request, SimServeEngine, make_admission


def lock_demo() -> None:
    print("== locks: throughput (Mops/s) on the modeled 40-CPU box ==")
    print(f"{'threads':>8} {'mcs_spin':>10} {'gcr(mcs_spin)':>14} "
          f"{'gcr_numa(mcs_spin)':>19}")
    for n in [8, 40, 80]:
        row = [run_sim(name, n).throughput_mops
               for name in ["mcs_spin", "gcr(mcs_spin)",
                            "gcr_numa(mcs_spin)"]]
        print(f"{n:>8} {row[0]:>10.3f} {row[1]:>14.3f} {row[2]:>19.3f}")

    # the real-thread wrapper: drop-in for threading.Lock
    lock = gcr_wrap(make_lock("pthread"))
    with lock:
        print("GCR-wrapped pthread lock acquired and released: OK")


def serving_demo() -> None:
    print("\n== serving: 2048 streams against a 384-slot engine ==")
    def fresh_requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt_len=int(rng.integers(256, 1024)),
                        gen_len=int(rng.integers(64, 256)), pod=i % 2,
                        arrive_ms=float(rng.uniform(0, 500)))
                for i in range(2048)]

    for kind in ["none", "gcr", "gcr_pod"]:
        adm = make_admission(kind, active_limit=384, n_pods=2)
        res = SimServeEngine(adm).run(fresh_requests(), max_ms=600_000)
        print(f"  admission={kind:8s} {res.summary()}")


def main() -> None:
    lock_demo()
    serving_demo()


if __name__ == "__main__":
    main()
