"""admission_wait_ms: the mean over the traced job's streams of the time
from the job's start (the ``repro_torch.engine.generate`` span) to the
stream's admission (its ``repro_torch.admission.admit`` instant), in ms.
The loop is closed, so every stream arrives at the job's start; a stream
admitted at once waits 0.  Silent without the program's spans."""

from bench import program_spans as P


def read(run):
    generate = P.spans(run.trace, P.GENERATE)
    admits = P.spans(run.trace, P.ADMIT)
    if not generate or not admits:
        return None
    waits = []
    for t, _ in admits:
        start = max((s for s, e in generate if s <= t <= e), default=None)
        if start is not None:
            waits.append((t - start) / 1e6)
    return sum(waits) / len(waits) if waits else None
