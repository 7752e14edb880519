"""decode_step_ms: the mean host wall of the engine's decode calls in the
window (``TorchServeEngine._decode``), each between synchronises."""


def read(run):
    ms = [s * 1e3 for kind, s, _ in run.spans if kind == "decode"]
    return sum(ms) / len(ms) if ms else None
