"""moe_pad_share: of the rows the traced job handed to the expert
products, the share that held no token, 100 x (1 - the counter
``moe.rows_with_token`` / ``moe.rows``), in %.  The counters are the
port's (``repro_torch.runtime.trace``), reset when the traced job
starts; silent where the program has none or the model no experts."""


def read(run):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.counters()
    rows = counts.get("moe.rows", 0)
    if not rows:
        return None
    return 100.0 * (1.0 - counts.get("moe.rows_with_token", 0) / rows)
