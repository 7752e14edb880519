"""The port's lock layer beyond plain GCR: the seeded lock-contention
simulator behind the paper's figures (``core.simulator``), GCR-NUMA
(``core.gcr_numa``) and its thread-to-socket map (``core.topology``),
each held against the reference's copy.

The simulator is pure, seeded Python: the same inputs must give equal
``SimResult``s in both packages.  GCR-NUMA runs real threads: it must
keep mutual exclusion (as ``tests/test_locks.py`` holds the reference's)
and admit a waiter of the preferred socket before an earlier waiter of
another socket, in both packages alike.
"""

import dataclasses
import threading
import time

import pytest

import repro.core as ref_core
import repro.core.simulator as ref_sim
import repro_torch.core as port_core
import repro_torch.core.simulator as port_sim

NAMES = sorted(port_sim.SIM_LOCKS) + [
    f"{wrap}({inner})" for wrap in ("gcr", "gcr_numa")
    for inner in ("ttas", "mcs_spin", "mcs_stp", "pthread", "ticket")]


@pytest.mark.parametrize("name", NAMES)
def test_simulator_equals_reference(name):
    assert sorted(port_sim.SIM_LOCKS) == sorted(ref_sim.SIM_LOCKS)
    for machine in ("X6_2", "X5_4", "T7_2"):
        for n in (4, 40, 80):
            kw = dict(duration_us=4_000.0, seed=n)
            got = port_sim.run_sim(name, n, getattr(port_sim, machine), **kw)
            want = ref_sim.run_sim(name, n, getattr(ref_sim, machine), **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.throughput_mops == want.throughput_mops
            assert got.unfairness == want.unfairness
            assert got.total_ops > 0


def test_simulator_shows_collapse_and_gcr_numa_avoids_it():
    """The paper's Figure 1 shape on the port's simulator: a spin lock
    collapses past the core count; GCR-NUMA keeps its throughput."""
    sweep = port_sim.sweep(["mcs_spin", "gcr_numa(mcs_spin)"], [20, 80],
                           duration_us=20_000.0)
    ref = ref_sim.sweep(["mcs_spin", "gcr_numa(mcs_spin)"], [20, 80],
                        duration_us=20_000.0)
    assert {k: [dataclasses.asdict(r) for r in v] for k, v in sweep.items()} \
        == {k: [dataclasses.asdict(r) for r in v] for k, v in ref.items()}
    mcs, numa = (sweep[k] for k in ("mcs_spin", "gcr_numa(mcs_spin)"))
    assert mcs[1].throughput_mops < 0.1 * mcs[0].throughput_mops
    assert numa[1].throughput_mops > 0.5 * numa[0].throughput_mops


def hammer(lock, n_threads=6, iters=200):
    counter, in_cs, max_in = [0], [0], [0]

    def work():
        for _ in range(iters):
            lock.acquire()
            try:
                in_cs[0] += 1
                max_in[0] = max(max_in[0], in_cs[0])
                counter[0] += 1
                in_cs[0] -= 1
            finally:
                lock.release()

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    return counter[0], max_in[0]


@pytest.mark.parametrize("name", ["ttas", "mcs_spin", "pthread"])
def test_gcr_numa_mutual_exclusion(name):
    topo = port_core.Topology(n_sockets=2)
    lock = port_core.gcr_numa_wrap(port_core.make_lock(name), topology=topo,
                                   promote_threshold=64,
                                   socket_rotate_every=50)
    assert hammer(lock) == (6 * 200, 1)
    assert lock.stat_rotations > 0


@pytest.mark.parametrize("core", [ref_core, port_core],
                         ids=["reference", "port"])
def test_gcr_numa_admits_the_preferred_socket_first(core):
    """The main thread holds the lock; a socket-1 waiter queues, then a
    socket-0 waiter.  On release the preferred socket (0) goes first,
    though it came second; then socket 1, once queue 0 is empty."""
    topo = core.Topology(n_sockets=2)
    lock = core.GCRNuma(core.make_lock("pthread"), topology=topo,
                        enter_threshold=0, join_threshold=0,
                        promote_threshold=10**9, socket_rotate_every=10**9)
    order = []

    def waiter(socket):
        topo.register_current_thread(socket)
        lock.acquire()
        order.append(socket)
        lock.release()

    topo.register_current_thread(0)
    lock.acquire()
    threads = []
    for socket in (1, 0):
        t = threading.Thread(target=waiter, args=(socket,))
        t.start()
        threads.append(t)
        deadline = time.time() + 30
        while lock.queues[socket].empty():
            assert time.time() < deadline, "waiter never queued"
            time.sleep(0.001)
    lock.release()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert order == [0, 1]
    assert (lock.stat_fast_path, lock.stat_slow_path) == (1, 2)


def test_gcr_numa_rotation_and_topology_equal_reference():
    def drive(core):
        topo = core.Topology(n_sockets=3)
        lock = core.GCRNuma(core.make_lock("ttas"), topology=topo,
                            socket_rotate_every=3)
        seen = []
        for _ in range(10):
            lock.acquire()
            lock.release()
            seen.append((lock.preferred.load(), lock._eligible(1),
                         lock.num_active()))
        rr = core.Topology(n_sockets=3)
        sockets = []
        for _ in range(5):
            out = []
            t = threading.Thread(
                target=lambda: out.append(rr.socket_of_current_thread()))
            t.start()
            t.join(timeout=10)
            sockets.append(out[0])
        with pytest.raises(ValueError):
            topo.register_current_thread(3)
        with pytest.raises(ValueError):
            core.Topology(n_sockets=0)
        return seen, lock.stat_rotations, lock.stat_fast_path, sockets, \
            lock.name

    got = drive(port_core)
    assert got == drive(ref_core)
    assert got[1] == 3 and got[3] == [0, 1, 2, 0, 1]
