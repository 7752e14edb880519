"""Paper microbenchmark analogue over REAL host threads.

Reproduces the paper's evaluation shape with actual Python threads (the
GIL caveat from DESIGN.md applies: relative effects, not absolute Mops).

The port of ``examples/lock_bench.py``, over the port's lock layer
(``core/``); it touches no device, and its numbers are the host's.  Run:

    PYTHONPATH=src python -m repro_torch.examples.lock_bench [--threads 16]
"""

import argparse
import threading
import time

from ..core import Topology, gcr_numa_wrap, gcr_wrap, make_lock


def bench(lock, n_threads: int, duration_s: float = 1.0):
    stop = time.perf_counter() + duration_s
    store = {i: i for i in range(4096)}
    per_thread = [0] * n_threads

    def work(tid: int) -> None:
        import random
        rnd = random.Random(tid)
        while time.perf_counter() < stop:
            k = rnd.randrange(4096)
            lock.acquire()
            try:
                if k % 5 == 0:
                    store[k] = store.get(k, 0) + 1
                else:
                    _ = store.get(k)
                per_thread[tid] += 1
            finally:
                lock.release()

    ts = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    dt = time.perf_counter() - t0
    ops = sorted(per_thread)
    total = sum(ops)
    unfair = sum(ops[len(ops) // 2:]) / max(total, 1)
    return total / dt / 1e3, unfair


def rows():
    """(name, lock) for each lock the bench runs, freshly built."""
    topo = Topology(n_sockets=2)
    return [
        ("pthread", make_lock("pthread")),
        ("ttas", make_lock("ttas")),
        ("mcs_spin", make_lock("mcs_spin")),
        ("gcr(pthread)", gcr_wrap(make_lock("pthread"),
                                  promote_threshold=512)),
        ("gcr(ttas)", gcr_wrap(make_lock("ttas"), promote_threshold=512)),
        ("gcr_numa(pthread)", gcr_numa_wrap(make_lock("pthread"),
                                            topology=topo,
                                            promote_threshold=512)),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)

    print(f"{'lock':>20} {'kops/s':>10} {'unfairness':>11}")
    for name, lock in rows():
        kops, unfair = bench(lock, args.threads)
        print(f"{name:>20} {kops:>10.1f} {unfair:>11.2f}")


if __name__ == "__main__":
    main()
