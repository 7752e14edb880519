"""prefill_wave_ms: the mean host wall of the engine's prefill calls in
the window (``TorchServeEngine._prefill``), each between synchronises."""


def read(run):
    ms = [s * 1e3 for kind, s, _ in run.spans if kind == "prefill"]
    return sum(ms) / len(ms) if ms else None
