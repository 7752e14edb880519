"""Plain PyTorch chunked WKV: the wkv kernel's reference and its path on
the CPU.

It is the math of the reference model's ``repro.models.rwkv6.wkv_chunked``
with its initial state, computed in f64 from the inputs as given (the
reference computes in f32), the (P, P) state carried from chunk to chunk
in f64; y and the final state are rounded once to f32, and y then to r's
dtype (f64 inputs, which the gradient checks use, keep f64).  Per chunk
of 16 rows, with cum = cumsum(log max(w, 1e-8)):

    r~ = r * exp(cum - log w)          k~ = k / max(exp(cum), 1e-37)
    y  = tril_-1(r~ k~^T) v + diag(sum_p r u k) v + r~ state
    state' = (state + k~^T v) * exp(cum_last)

Why f64: in a bf16 model y is rounded to bf16 before the group norm.  Two
f32 computations of y that sum in another order now and then land on
neighbouring bf16 values, and rwkv6-7b carries those flips through
its 32 layers to several percent of the largest logit.  Two f64
computations of y round to the same f32 value all but never, so the
kernel (``csrc/wkv.cu``, also f64) and this version give the same bf16
activations.  Against the reference's f32 the difference is the
reference's own rounding.

A second departure: a sequence that is not a multiple of the chunk is
padded with rows of ``w = 1`` and ``r = k = v = 0`` and the padding
sliced off, where the reference falls back to one chunk of the whole
sequence.  A padding row changes neither the real rows (it comes
after them) nor the state (its k is 0 and its decay 1).  The fallback's
factors 1/prod(w) over a long chunk leave f32's range (at S = 1000 and a
mean decay rate of 0.2 its output is all error and its state NaN); the
padded form keeps every chunk at 16 rows, where |log prod w| <= 80.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# the reference model's chunk: |log prod w| <= CHUNK * MAX_DECAY_RATE = 80
# stays inside f32's range (log f32_max ~ 88)
CHUNK = 16
# per-step decay exponent cap: w = exp(-rate) with rate <= 5
MAX_DECAY_RATE = 5.0


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B,S,H,P); w: (B,S,H,P) per-channel decay in (0,1); u:
    (H,P); init_state: (B,H,P,P) ``state[b, h, k_dim, v_dim]``, or None
    for zeros.  Returns (y (B,S,H,P) in r's
    dtype, final_state (B,H,P,P) f32)."""
    B, S, H, P = r.shape
    nc = -(-S // CHUNK)
    pad = nc * CHUNK - S
    f64 = torch.float64
    rf, kf, vf, wf = (t.to(f64) for t in (r, k, v, w))
    if pad:
        rows = (0, 0, 0, 0, 0, pad)
        rf, kf, vf = (F.pad(t, rows) for t in (rf, kf, vf))
        wf = F.pad(wf, rows, value=1.0)

    rc, kc, vc, wc = (t.reshape(B, nc, CHUNK, H, P)
                      for t in (rf, kf, vf, wf))
    logw = torch.log(torch.clamp(wc, min=1e-8))
    cum = torch.cumsum(logw, dim=2)                  # inclusive
    b_incl = torch.exp(cum)                          # prod_{s<=t} w_s
    b_excl = torch.exp(cum - logw)                   # prod_{s<t} w_s
    b_last = torch.exp(cum[:, :, -1])                # (B,nc,H,P)

    # intra-chunk: score(i,j) = (r_i b_excl_i) . (k_j / b_incl_j), j < i
    r_t = rc * b_excl
    k_t = kc / torch.clamp(b_incl, min=1e-37)
    scores = torch.einsum("bcihp,bcjhp->bchij", r_t, k_t)
    mask = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                      device=r.device).tril(-1)
    scores = torch.where(mask, scores, 0.0)
    # bonus diagonal (the current token)
    diag = torch.einsum("bcihp,bcihp->bcih", rc * u.to(f64), kc)
    y = torch.einsum("bchij,bcjhp->bcihp", scores, vc) + diag[..., None] * vc

    # inter-chunk: y_i += r~_i state_in; the state carried in f64
    per_chunk_state = torch.einsum("bcjhp,bcjhq->bchpq", k_t, vc)
    state = (torch.zeros((B, H, P, P), dtype=f64, device=r.device)
             if init_state is None else init_state.to(f64))
    states_in = []
    # unbind: the backward of indexing chunk c would write a zeroed copy of
    # the whole (B,nc,H,P,P) tensor for each chunk
    for st, bl in zip(per_chunk_state.unbind(1), b_last.unbind(1)):
        states_in.append(state)
        state = (state + st) * bl[..., None]
    states_in = torch.stack(states_in, dim=1)        # (B,nc,H,P,P)
    y = y + torch.einsum("bcihp,bchpq->bcihq", r_t, states_in)

    out = torch.promote_types(r.dtype, torch.float32)
    y = y.reshape(B, nc * CHUNK, H, P)[:, :S]
    return y.to(out).to(r.dtype), state.to(out)
