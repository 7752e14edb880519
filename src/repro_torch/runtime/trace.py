"""Spans and counters on the profiler's clock, recorded only while a
``torch.profiler`` is recording.

``span(name)`` is a host range that the profiler files as a host
operation (a ``cpu_op``, on the same clock as the kernels it launched);
``instant(name)`` is a zero-length one, for a moment.  ``count(name,
value)`` adds an int or a device tensor (summed when the counters are
read, so counting adds no synchronise and no kernel) to a counter.  With
no profiler recording, each call is one test of the profiler's flag and
nothing more: no range opens and no counter moves.

The profiler is the recorder: run a job under ``torch.profiler.profile``
and ``prof.export_chrome_trace(path)`` shows the spans beside the
kernels; ``counters()`` after it gives the job's counts (``reset`` clears
them; ``TorchServeEngine.generate`` resets them at each entry it traces).
Names are ``repro_torch.<layer>.<what>``.

``device_span(name, device)`` is a span that, on a CUDA device, also
records a pair of CUDA events on the current stream at its edges:
``device_times()`` gives the stream's seconds between each pair, the
card's time for the work launched inside (a host range times only the
launches, which run ahead of the card).

A range is opened with ``_RecordFunctionFast``, not
``torch.profiler.record_function``: the profiler files the latter as a
user annotation, which it mirrors onto the card's timeline, where a span
of the whole job would read as device work.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Union

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

__all__ = ["count", "counters", "device_span", "device_times", "instant",
           "recording", "reset", "span"]

_OFF = contextlib.nullcontext()
_counts: Dict[str, List[Union[int, torch.Tensor]]] = {}
_events: Dict[str, list] = {}


def recording() -> bool:
    """True while a profiler is recording."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context that records the host range ``name`` while a profiler is
    recording, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


class _DeviceSpan:
    """The host range ``name`` and CUDA events at its edges."""

    __slots__ = ("name", "range", "start")

    def __init__(self, name: str) -> None:
        self.name = name
        self.range = _RecordFunctionFast(name)

    def __enter__(self):
        self.range.__enter__()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _events.setdefault(self.name, []).append((self.start, end))
        return self.range.__exit__(*exc)


def device_span(name: str, device: torch.device):
    """``span(name)``, with CUDA events at its edges where ``device`` is a
    CUDA device (``device_times``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if device.type != "cuda":
        return _RecordFunctionFast(name)
    return _DeviceSpan(name)


def device_times() -> Dict[str, List[float]]:
    """Each device span's seconds on its stream, by name, since the last
    ``reset``; synchronises with the card."""
    out = {}
    for name, pairs in _events.items():
        if pairs:
            pairs[-1][1].synchronize()
        out[name] = [s.elapsed_time(e) / 1e3 for s, e in pairs]
    return out


def instant(name: str) -> None:
    """A zero-length span ``name``."""
    if _profiler._is_profiler_enabled:
        with _RecordFunctionFast(name):
            pass


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Adds ``value`` (an int, or a tensor whose sum is added) to the
    counter ``name`` while a profiler is recording."""
    if _profiler._is_profiler_enabled:
        _counts.setdefault(name, []).append(value)


def reset() -> None:
    _counts.clear()
    _events.clear()


def counters() -> Dict[str, int]:
    """Each counter's total since the last ``reset``; synchronises with
    the device that holds a counted tensor."""
    out = {}
    for name, values in _counts.items():
        ints = sum(v for v in values if not isinstance(v, torch.Tensor))
        sums = [v.sum() for v in values if isinstance(v, torch.Tensor)]
        out[name] = int(ints) + (int(torch.stack(sums).sum()) if sums
                                 else 0)
    return out
