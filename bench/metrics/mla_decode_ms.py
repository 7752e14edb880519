"""mla_decode_ms: the latent attention's decode time a decode step, in
ms: the card's seconds inside the traced job's
``repro_torch.model.mla.decode`` spans (the stream's time between the
CUDA events the port records at each span's edges,
``repro_torch.runtime.trace.device_times``; a host range there times only
the launches, which run ahead of the card) over the number of
``repro_torch.engine.decode`` spans.  Silent where the program records
no such span (a model without latent attention, or a program without
them)."""

from bench import program_spans as P

SPAN = "repro_torch.model.mla.decode"


def device_seconds():
    """The card's seconds of each ``mla.decode`` span of the traced job,
    or None where the program records none."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    times = getattr(trace, "device_times", None)
    return (times() if times else {}).get(SPAN) or None


def read(run):
    seconds = device_seconds()
    steps = len(P.spans(run.trace, P.DECODE))
    if not seconds or not steps:
        return None
    return 1e3 * sum(seconds) / steps
