"""Each configuration's reference (the module its ``reference`` key
names: the plain float32 decoder for both) against the port, on the CPU
at the configurations' smoke sizes: both in float32 on the same weights,
the port serving prompts through ``TorchServeEngine`` (prefill, then
decode through the KV cache), the reference computing each prompt and
its served tokens at once.  Every logit the engine produced agrees with
the reference's at the same position to 1e-4 of the largest (the order
of float32 sums only).  The mixtral cases pass the window, so the
engine's ring buffer wraps, and one drops tokens at the experts'
capacity."""

import dataclasses

import numpy as np
import pytest
import torch

from bench import spec as S
from bench import traffic, weights
from bench.harness import program_config

TOL = 1e-4


def _setup(config_name, prompt_len, gen_len, streams, slots, **change):
    bench = S.benchmark()
    cfg_file = S.sized(S.config_file(bench, config_name), smoke=True)
    ref = S.reference(cfg_file)
    cfg = program_config(ref, cfg_file, ref.spec(cfg_file), smoke=True)
    cfg_file.update(change)
    spec = ref.spec(cfg_file)
    cfg = dataclasses.replace(cfg, dtype="float32",
                              moe_capacity_factor=spec["capacity_factor"]
                              or cfg.moe_capacity_factor)
    W = weights.make(cfg, 11, torch.device("cpu"))
    mix = {"slots": slots, "streams": streams, "prompt_len": prompt_len,
           "gen_len": gen_len}
    return ref, spec, cfg, W, mix


def _served(cfg, W, mix):
    """The engine's tokens and every logit row it produced, by stream:
    {stream: (gen_len, V)}."""
    from repro_torch.serving.engine import TorchServeEngine

    params = weights.to_program(cfg, W)
    eng = TorchServeEngine(cfg, params, n_slots=mix["slots"],
                           max_len=mix["prompt_len"] + mix["gen_len"],
                           admission_kind="gcr", device="cpu")
    rows, wave = {}, []
    prefill, decode = eng._prefill, eng._decode

    def rec_prefill(p, batch):
        logits, cache = prefill(p, batch)
        wave[:] = [r.numpy().tobytes() for r in batch["tokens"]]
        for j, key in enumerate(wave):
            rows[key] = [logits[j, 0]]
        return logits, cache

    def rec_decode(p, cache, tok):
        logits, cache = decode(p, cache, tok)
        for j, key in enumerate(wave):
            rows[key].append(logits[j, 0])
        return logits, cache

    eng._prefill, eng._decode = rec_prefill, rec_decode
    prompts = traffic.job_prompts(mix, cfg.vocab_size, 5, 0)
    out = eng.generate(prompts, mix["gen_len"])
    logits = [torch.stack(rows[p.tobytes()][:mix["gen_len"]])
              for p in prompts]
    return prompts, out, torch.stack(logits)


@pytest.mark.parametrize("config_name,prompt_len,gen_len,change", [
    ("internlm2-20b", 40, 6, {}),
    ("mixtral-8x7b-16L", 40, 6, {}),                      # window 32 wraps
    ("mixtral-8x7b-16L", 48, 4, {"moe_capacity_factor": 0.5}),  # drops
])
def test_reference_matches_port_in_f32(config_name, prompt_len, gen_len,
                                       change):
    ref, spec, cfg, W, mix = _setup(config_name, prompt_len, gen_len, 4, 2,
                                    **change)
    prompts, out, got = _served(cfg, W, mix)
    seqs = np.concatenate([prompts, out[:, :-1]], axis=1).astype(np.int64)
    want = ref.logits(spec, ref.Weights(W), torch.as_tensor(seqs),
                          [prompt_len] + [1] * (gen_len - 1),
                          list(range(prompt_len - 1,
                                     prompt_len + gen_len - 1)))
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=TOL, rtol=0)


def test_capacity_drops_happen_in_the_dropping_case():
    ref, spec, cfg, W, mix = _setup("mixtral-8x7b-16L", 48, 4, 4, 2,
                                    moe_capacity_factor=0.5)
    x = torch.randn(48, 2, generator=torch.Generator().manual_seed(0))
    experts = torch.topk(x, 2, dim=-1).indices % spec["n_experts"]
    keep = ref.admitted(experts, [48], spec)
    cap = ref.capacity(48, 2, 0.5, spec["n_experts"])
    assert cap == 16 and not keep.all()
    for e in range(spec["n_experts"]):
        assert int(((experts == e) & keep).sum()) == min(
            cap, int((experts == e).sum()))
