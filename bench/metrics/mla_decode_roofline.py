"""mla_decode_roofline: of the traced job's decode attention over the
latent cache, the least time the card could take over the card's time
inside the ``repro_torch.model.mla.decode`` spans (``mla_decode_ms``'s
seconds), in %.  The least time is ``bench.work.bound_s`` of the work
that the counter ``mla.latent_rows`` (the latent positions the decode
attention read, B x the written length, summed over layers and steps)
implies: each row's latent and rope key read once, (kv_lora_rank +
qk_rope_head_dim) x 2 bytes, and for each of the n_heads the scores
over them and the probabilities times the latent, 2 x (kv_lora_rank +
qk_rope_head_dim + kv_lora_rank) FLOP.  Silent without the spans or the
counter."""

from pathlib import Path

from bench import spec, work

device_seconds = spec.load_module(
    Path(__file__).with_name("mla_decode_ms.py")).device_seconds


def read(run):
    seconds = device_seconds()
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    rows = trace.counters().get("mla.latent_rows", 0)
    if not seconds or not rows:
        return None
    s = run.spec
    r, rope, H = s["kv_lora_rank"], s["qk_rope_head_dim"], s["n_heads"]
    bound = work.bound_s(rows * H * 2 * (2 * r + rope), rows * (r + rope) * 2)
    return 100.0 * bound / sum(seconds)
