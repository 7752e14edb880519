"""mfu: the useful model FLOPs of the window's prefill waves and decode
steps (the configuration's reference module's ``model_flops``, which the
run's record carries; ``decoder``'s counts dense products, active
experts only, no capacity padding, causal attention over the visible
keys, the LM head on each row's last position) over the window's wall
time and the card's bf16 peak, in %."""

from bench import work


def read(run):
    flops = 0
    for kind, _, about in run.spans:
        if kind == "prefill":
            B, S = about
            flops += run.model_flops(run.spec, B, S, 0)
        else:
            B, pos = about
            flops += run.model_flops(run.spec, B, 1, pos)
    if not flops:
        return None
    return 100.0 * flops / run.window_s / work.PEAK_FLOPS
