"""Real-model serving engine: GCR admission in front of fixed batch slots.

The port of ``repro.serving.engine.make_admission`` and
``JaxServeEngine``.  ``TorchServeEngine`` keeps the reference's protocol
step for step, quirks included, so that both give the same tokens:

* each wave re-prefills the whole active batch from the prompts;
* a wave runs ``gen_len`` decode steps and drops the last step's output;
* the ids that ``release()`` admits are not used; the next wave offers
  those streams again, so GCR counts them as fast admits twice (8 streams
  on 3 slots report 8 fast admits and 2 parked);
* tokens are greedy ``argmax`` over the last position.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..core.admission import GCRAdmission, NoAdmission
from ..core.pod_aware import GCRPod
from ..models import decode_step, prefill


def make_admission(kind: str, active_limit: int, n_pods: int = 2,
                   promote_every: int = 64):
    if kind == "none":
        return NoAdmission()
    if kind == "gcr":
        return GCRAdmission(active_limit, promote_every)
    if kind == "gcr_pod":
        return GCRPod(active_limit, n_pods, promote_every)
    raise ValueError(f"unknown admission kind {kind!r}")


class TorchServeEngine:
    """Batched decode over a real model with fixed slots + GCR admission.

    The batch has ``n_slots`` lanes; admitted streams occupy lanes, parked
    streams wait in the GCR queue.  ``params`` must live on ``device``
    (default ``cuda``)."""

    def __init__(self, cfg, params, n_slots: int, max_len: int,
                 admission_kind: str = "gcr", promote_every: int = 16,
                 device=None) -> None:
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.admission = make_admission(admission_kind, n_slots,
                                        promote_every=promote_every)
        self._decode = lambda p, c, t: decode_step(cfg, p, c, t)
        self._prefill = lambda p, b: prefill(cfg, p, b, max_len=max_len)

    @staticmethod
    def _greedy(logits: torch.Tensor) -> torch.Tensor:
        return logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        """prompts: (n_streams, prompt_len) int32.  Greedy decode; streams
        beyond the active limit are parked and admitted as slots free."""
        n = prompts.shape[0]
        out = np.zeros((n, gen_len), np.int32)
        waiting = list(range(n))
        active: List[int] = []
        progress = {i: 0 for i in range(n)}

        while waiting or active:
            # admission
            newly = []
            while waiting:
                sid = waiting[0]
                if self.admission.offer(sid):
                    newly.append(sid)
                    waiting.pop(0)
                else:
                    break  # queue is FIFO; head parked => all parked
            active.extend(newly)
            if not active:
                break
            # (re)prefill the active batch
            batch = {"tokens": torch.as_tensor(prompts[active],
                                               device=self.device)}
            logits, cache = self._prefill(self.params, batch)
            tok = self._greedy(logits)
            for _ in range(gen_len):
                tok_host = tok.cpu().numpy()
                for j, sid in enumerate(active):
                    if progress[sid] < gen_len:
                        out[sid, progress[sid]] = tok_host[j, 0]
                        progress[sid] += 1
                logits, cache = self._decode(self.params, cache, tok)
                tok = self._greedy(logits)
            done = [sid for sid in active if progress[sid] >= gen_len]
            for sid in done:
                self.admission.release(sid)
            active = [sid for sid in active if progress[sid] < gen_len]
        return out
