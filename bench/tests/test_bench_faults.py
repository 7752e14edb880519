"""The check catches a broken timed path.  Each case rehearses a cell on
the CPU at its smoke sizes (as ``test_bench_run``), with one fault
planted in the port underneath the engine, and the run must come out
``correct`` false:

- ``stale``: a decode step that returns its state unchanged (the KV
  cache neither written nor advanced);
- ``half``: half of the batch left out of a decode step, its rows given
  the other half's logits;
- ``altered``: a token altered where it is produced (every third greedy
  pick, for every stream of that step, is the next id).

One chip holds the whole cell, so there is no exchange between chips to
leave out."""

import pytest

from bench.tests.test_bench_run import CELLS, rehearse

PLANTS = {
    "stale": r"""
import repro_torch.serving.engine as E
_decode = E.decode_step
def stale(cfg, p, caches, tok):
    snap = {"pos": caches["pos"],
            "layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in caches["layers"]]}
    return _decode(cfg, p, snap, tok)[0], caches
E.decode_step = stale
""",
    "half": r"""
import torch
import repro_torch.serving.engine as E
_decode = E.decode_step
def half(cfg, p, caches, tok):
    h = max(1, tok.shape[0] // 2)
    sub = {"pos": caches["pos"],
           "layers": [{k: v[:h] for k, v in layer.items()}
                      for layer in caches["layers"]]}
    logits, _ = _decode(cfg, p, sub, tok[:h])
    caches["pos"] += tok.shape[1]
    return logits[torch.arange(tok.shape[0]) % h], caches
E.decode_step = half
""",
    "altered": r"""
import repro_torch.serving.engine as E
_greedy = E.TorchServeEngine._greedy
calls = [0]
def altered(logits):
    tok = _greedy(logits)
    calls[0] += 1
    return (tok + 1) % logits.shape[-1] if calls[0] % 3 == 0 else tok
E.TorchServeEngine._greedy = staticmethod(altered)
""",
}


@pytest.mark.parametrize("fault", sorted(PLANTS))
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_comes_out_not_correct(workload, fault):
    rc, last, err = rehearse(workload, seed=2**31 + 11, plant=PLANTS[fault])
    assert rc == 0, err
    assert last["correct"] is False, last["checks"]
