"""device_idle: the share of the traced job's wall time in which no
operation ran on the card, in %."""


def read(run):
    wall = run.trace.wall_s
    if wall <= 0 or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / wall)
