"""tokens_per_s: the output tokens of every stream of every job in the
window over the window's wall (host clock after a synchronise), as the
end-to-end metric of that name; read per layer in a cell whose rate
follows the host too widely to hold a bound (``tokens_per_s.chat``)."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
