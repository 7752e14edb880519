"""The benchmark's one timing module: the host clock between
synchronises, and the device's kernels from ``torch.profiler``.

A host-clock time is only read after ``torch.cuda.synchronize()``: the
card runs behind the host, so a time read without one measures the
launches.  The profiler's events are read raw (name, device, start,
duration) and never exported: no multi-GB trace is written.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synced_now(device) -> float:
    sync(device)
    return now()


class Spans:
    """Host-clock spans of calls, each between synchronises: the
    engine's prefill and decode calls in the window."""

    def __init__(self, device) -> None:
        self.device = device
        self.items = []           # (kind, seconds, info)

    def wrap(self, kind: str, fn, info):
        """``fn`` timed; ``info(*args)``, read before the call, describes
        it (a call may update its arguments in place)."""
        def timed(*args):
            about = info(*args)
            t = synced_now(self.device)
            out = fn(*args)
            self.items.append((kind, synced_now(self.device) - t, about))
            return out
        return timed


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


class DeviceTrace:
    """One profiled region: every device operation (kernels, copies,
    sets) as (name, start_ns, dur_ns), and the host's operations as
    (start_ns, end_ns, name), both on the profiler's clock, and the
    region's own span (``label``; without it, the span of the device
    operations)."""

    def __init__(self, label: str = "bench.job") -> None:
        self.label = label
        self.device_ops = []
        self.host_ops = []
        self.start_ns = self.end_ns = 0

    def profile(self, device, host: bool = True):
        """A profiler of the card's operations and, with ``host`` (or
        without a card), of the host's."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        if host or not acts:
            acts.append(ProfilerActivity.CPU)
        return profile(activities=acts)

    def read(self, prof) -> None:
        results = getattr(prof.profiler, "kineto_results", None)
        events = results.events() if results is not None else []
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            start, dur = _ns(e, "start"), _ns(e, "duration")
            name = e.name()
            if name == self.label:       # also mirrored on the device's
                if e.device_type() != cuda:  # timeline: not an operation
                    self.start_ns, self.end_ns = start, start + dur
            elif e.device_type() == cuda:
                self.device_ops.append((name, start, dur))
            else:
                self.host_ops.append((start, start + dur, name))
        self.device_ops.sort(key=lambda op: op[1])
        self.host_ops.sort()
        if not self.end_ns and self.device_ops:   # no label: the whole
            self.start_ns = self.device_ops[0][1]  # profile is the region
            self.end_ns = max(s + d for _, s, d in self.device_ops)

    @property
    def wall_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the
        region, merged, as [start_ns, end_ns] lists."""
        merged = []
        for _, s, d in self.device_ops:
            s, e = max(s, self.start_ns), min(s + d, self.end_ns)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        total = defaultdict(int)
        for name, _, d in self.device_ops:
            total[name] += d
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def _host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``: of those that
        contain it, the one that started last."""
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), ""))
        for j in range(i - 1, max(-1, i - 400), -1):
            s, e, name = self.host_ops[j]
            if e >= t:
                return name
        return "host outside any recorded op"

    def idle_gaps(self, n: int = 10) -> list:
        """The region's idle time with no device operation, summed by
        what the host was doing at the middle of each gap."""
        total = defaultdict(int)
        edge = self.start_ns
        for s, e in self.busy_intervals() + [[self.end_ns, self.end_ns]]:
            if s > edge:
                total[self._host_at((edge + s) // 2)] += s - edge
            edge = max(edge, e)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]
