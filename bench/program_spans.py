"""The program's own spans in a traced job: the host ranges named
``repro_torch.<layer>.<what>`` that the port records while a profiler
runs, read from ``DeviceTrace.host_ops`` on the profiler's clock.  A
program without them (an older port) gives none, and the metrics that
read them stay silent."""

from __future__ import annotations

import bisect

GENERATE = "repro_torch.engine.generate"
PREFILL = "repro_torch.engine.prefill"
DECODE = "repro_torch.engine.decode"
ADMIT = "repro_torch.admission.admit"


def spans(trace, *names) -> list:
    """(start_ns, end_ns) of each host range named one of ``names``, in
    order of start."""
    return [(s, e) for s, e, name in trace.host_ops if name in names]


def inside(t: int, ranges: list) -> bool:
    """Whether ``t`` lies in one of ``ranges``, which do not overlap and
    are in order of start."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def idle_split(trace):
    """The traced job's device-idle time, each gap filed by its middle
    as ``DeviceTrace.idle_gaps`` files it: (ns inside a prefill or decode
    span, ns inside ``generate`` but outside those), or None without a
    ``generate`` span.  With no device operation the whole wall is one
    gap."""
    generate = spans(trace, GENERATE)
    if not generate:
        return None
    steps = spans(trace, PREFILL, DECODE)
    model = engine = 0
    edge = trace.start_ns
    for s, e in trace.busy_intervals() + [[trace.end_ns, trace.end_ns]]:
        if s > edge:
            mid = (edge + s) // 2
            if inside(mid, steps):
                model += s - edge
            elif inside(mid, generate):
                engine += s - edge
        edge = max(edge, e)
    return model, engine
