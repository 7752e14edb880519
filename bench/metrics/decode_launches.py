"""decode_launches: the kernel launches a decode step, the runtime's
launch calls that start inside the traced job's
``repro_torch.engine.decode`` spans over the number of those spans.
Reads 0 where nothing launches (the CPU); silent without the spans."""

import bisect

from bench import program_spans as P

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def read(run):
    steps = P.spans(run.trace, P.DECODE)
    if not steps:
        return None
    starts = sorted(s for s, _, name in run.trace.host_ops
                    if name in LAUNCHES)
    n = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
            for s, e in steps)
    return n / len(steps)
