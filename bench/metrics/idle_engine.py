"""idle_engine: the traced job's device-idle time whose gap's middle lies
inside the ``repro_torch.engine.generate`` span but outside every
prefill and decode span (the engine's own host work), over the job's
wall, in %.  Silent without the program's spans."""

from bench import program_spans as P


def read(run):
    split = P.idle_split(run.trace)
    wall = run.trace.end_ns - run.trace.start_ns
    if split is None or wall <= 0:
        return None
    return 100.0 * split[1] / wall
