"""Thread-to-socket (NUMA node) mapping used by GCR-NUMA.

The port's own copy of ``repro.core.topology``, unchanged in behaviour:
the port imports nothing of ``repro``.

On the paper's machines the socket of a running thread comes from the OS
(``sched_getcpu`` + topology tables).  On a host with few cores and in unit
tests we need a controllable stand-in, so the mapping is a process-global
registry: worker threads are assigned a socket either explicitly
(``register_current_thread``) or round-robin on first use - emulating an OS
spreading threads across sockets.

The same abstraction serves GCR-POD (``pod_aware.py``), where "socket"
becomes a pod of GPUs and the assignment comes from the serving deployment.
"""

from __future__ import annotations

import itertools
import threading


class Topology:
    """Maps threads (or any actor id) to sockets/pods."""

    def __init__(self, n_sockets: int = 2) -> None:
        if n_sockets < 1:
            raise ValueError("need at least one socket")
        self.n_sockets = n_sockets
        self._tls = threading.local()
        self._rr = itertools.count()

    def register_current_thread(self, socket: int) -> None:
        if not (0 <= socket < self.n_sockets):
            raise ValueError(f"socket {socket} out of range")
        self._tls.socket = socket

    def socket_of_current_thread(self) -> int:
        s = getattr(self._tls, "socket", None)
        if s is None:
            s = next(self._rr) % self.n_sockets
            self._tls.socket = s
        return s


DEFAULT_TOPOLOGY = Topology(n_sockets=2)
