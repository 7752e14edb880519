"""FLOPs and bytes, worked out by the benchmark from widths and shapes.

The yardstick of ``mfu``, ``flash_roofline`` and ``gmm_roofline``.  It
reads no counter of the program: a later change to the program cannot
move it.  A multiply-add is 2 FLOP.  Each input is read once and each
output written once, whatever a kernel reads again.
"""

from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate
# and HBM3 bandwidth, at the full 700 W.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def visible_keys(q_pos: int, window: int) -> int:
    """Keys a causal query at position ``q_pos`` sees (keys 0..q_pos, the
    last ``window`` of them where the window is set)."""
    return min(q_pos + 1, window) if window else q_pos + 1


def visible_pairs(S: int, window: int, start: int = 0) -> int:
    """Causal (query, key) pairs of S queries at positions start ..
    start + S - 1 over keys from position 0."""
    if not window:
        first, last = start + 1, start + S
        return (first + last) * S // 2
    return sum(visible_keys(start + i, window) for i in range(S))


def flash_work(B: int, S: int, T: int, Hq: int, Hkv: int, D: int,
               window: int, causal: bool = True, itemsize: int = 2,
               Dv: int | None = None) -> tuple[int, int]:
    """(FLOPs, bytes) of one attention call of S queries over T keys in
    B rows (causal: the queries are the last S of the T positions), q and
    k of head dim D, v and the output of ``Dv`` (D where not given): QK^T
    at D and PV at Dv for every visible pair; q, k, v and both int32
    position vectors read, the output written."""
    Dv = D if Dv is None else Dv
    pairs = visible_pairs(S, window, T - S) if causal else S * T
    flops = 2 * B * Hq * (D + Dv) * pairs
    nbytes = (B * S * Hq * (D + Dv) + B * T * Hkv * (D + Dv)) * itemsize \
        + 4 * (S + T)
    return flops, nbytes


def gmm_work(rows: int, held: int, D: int, F: int,
             itemsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one expert product counting only the ``rows``
    that hold a token (no capacity padding) and the weights of the
    ``held`` experts that hold at least one, each read once."""
    flops = 2 * rows * D * F
    nbytes = (rows * D + held * D * F + rows * F) * itemsize
    return flops, nbytes


def bound_s(flops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def layer_token_flops(spec: dict) -> int:
    """A layer's projection FLOPs for one token: q, k, v and o, then the
    dense SwiGLU MLP, or the router and ``top_k`` experts' SwiGLU."""
    d, hd = spec["d_model"], spec["head_dim"]
    qo = 2 * 2 * d * spec["n_heads"] * hd
    kv = 2 * 2 * d * spec["n_kv_heads"] * hd
    if spec.get("n_experts"):
        mlp = 2 * d * spec["n_experts"] \
            + spec["top_k"] * 3 * 2 * d * spec["expert_d_ff"]
    else:
        mlp = 3 * 2 * d * spec["d_ff"]
    return qo + kv + mlp


def model_flops(spec: dict, B: int, S: int, start: int) -> int:
    """``decoder``'s ``model_flops``: useful FLOPs of one call over B rows of S new tokens at positions
    start .. start + S - 1 (a prefill: start 0; a decode step: S 1):
    every layer's projections and experts (active ones only), causal
    attention over the visible keys, and the LM head on the last position
    of each row."""
    per_row = S * layer_token_flops(spec) * spec["n_layers"]
    per_row += (4 * spec["n_heads"] * spec["head_dim"]
                * visible_pairs(S, spec["window"], start) * spec["n_layers"])
    per_row += 2 * spec["d_model"] * spec["vocab_size"]
    return B * per_row
