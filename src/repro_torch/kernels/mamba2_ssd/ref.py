"""Plain PyTorch chunked SSD scan: the ssd kernel's reference and its path
on the CPU.

It is the math of the reference model's ``repro.models.mamba2.ssd_chunked``
with an initial state: everything in f32 from the inputs as given (in
f64 for f64 inputs, which the gradient checks use), the state carried
from chunk to chunk in f32, y rounded once to xdt's dtype.

One difference in form, none in value: a sequence that is not a multiple
of the chunk is padded with rows of ``a = 0`` and ``x = B = C = 0`` and
the padding sliced off, where the reference falls back to one chunk of
the whole sequence.  A padding row changes neither the real rows (it
comes after them) nor the state (its B is 0 and its decay exp(0) = 1),
and a (B,H,1,S,S) decay matrix would not fit at a serving prompt's S.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

CHUNK = 256     # the reference model's chunk (mamba2.py::CHUNK)


def ssd_ref(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None,
            chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt: (B,S,H,P) inputs premultiplied by dt; a: (B,S,H) log decays;
    Bm, Cm: (B,S,N) shared across heads; init_state: (B,H,P,N) or None.
    Returns (y (B,S,H,P) in xdt's dtype, final_state (B,H,P,N) f32)."""
    Bb, S, H, P = xdt.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    acc = torch.promote_types(xdt.dtype, torch.float32)
    x, a32, Bf, Cf = (t.to(acc) for t in (xdt, a, Bm, Cm))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a32 = F.pad(a32, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))

    xc = x.reshape(Bb, nc, chunk, H, P)
    ac = a32.reshape(Bb, nc, chunk, H).permute(0, 3, 1, 2)      # (B,H,c,q)
    Bc = Bf.reshape(Bb, nc, chunk, N)
    Cc = Cf.reshape(Bb, nc, chunk, N)

    a_cum = torch.cumsum(ac, dim=-1)                           # (B,H,c,q)
    # L[i,j] = exp(sum_{k=j+1..i} a_k) for i >= j, else 0
    tril = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()
    seg = a_cum[..., :, None] - a_cum[..., None, :]
    L = torch.exp(torch.where(tril, seg, float("-inf")))       # (B,H,c,q,q)

    # intra-chunk (diagonal blocks)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", L * scores[:, None], xc)

    # per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (B,H,c,q)
    states = torch.einsum("bckn,bckhp->bchpn", Bc,
                          xc * decay_states.permute(0, 2, 3, 1)[..., None])

    # inter-chunk recurrence, the state carried in f32
    state = (torch.zeros((Bb, H, P, N), dtype=acc, device=x.device)
             if init_state is None else init_state.to(acc))
    chunk_decay = torch.exp(a_cum[..., -1])                    # (B,H,c)
    states_in = []
    # unbind: the backward of indexing chunk c would write a zeroed copy of
    # the whole tensor for each chunk
    for st, dec in zip(states.unbind(1), chunk_decay.unbind(2)):
        states_in.append(state)
        state = state * dec[..., None, None] + st
    states_in = torch.stack(states_in, dim=1)                  # (B,c,H,P,N)

    # inter-chunk contribution
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, states_in) \
        * torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(Bb, nc * chunk, H, P)[:, :S]
    return y.to(xdt.dtype), state
