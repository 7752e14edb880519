"""peak_mem_gb: the card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start,
weights included), in GB."""


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes else None
