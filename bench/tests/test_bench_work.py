"""The benchmark's FLOP and byte counts at hand-worked shapes, and the
visible (query, key) pairs against a brute-force count of the mask."""

import pytest
import torch

from bench import work


def test_flash_work_hand_worked():
    # B 1, S = T = 4, Hq 2, Hkv 1, D 8, causal: 1 + 2 + 3 + 4 = 10 pairs
    flops, nbytes = work.flash_work(1, 4, 4, 2, 1, 8, window=0)
    assert flops == 4 * 1 * 2 * 8 * 10 == 640
    # q and out 4 x 2 x 8, k and v 4 x 1 x 8, bf16; two int32 positions
    assert nbytes == (2 * 64 + 2 * 32) * 2 + 4 * 8 == 416
    # a window of 2: 1 + 2 + 2 + 2 = 7 pairs
    assert work.flash_work(1, 4, 4, 2, 1, 8, window=2)[0] == 4 * 2 * 8 * 7


@pytest.mark.parametrize("S,window,start", [(1, 0, 0), (7, 0, 0),
                                            (7, 3, 0), (5, 4, 6),
                                            (1, 4096, 4100), (64, 16, 9)])
def test_visible_pairs_counts_the_mask(S, window, start):
    q = torch.arange(start, start + S)[:, None]
    k = torch.arange(start + S)[None, :]
    mask = k <= q
    if window:
        mask &= (q - k) < window
    assert work.visible_pairs(S, window, start) == int(mask.sum())


def test_gmm_work_counts_rows_that_hold_a_token():
    # 3 rows hold a token, 2 experts hold one, D 4, F 5, bf16
    flops, nbytes = work.gmm_work(3, 2, 4, 5)
    assert flops == 2 * 3 * 4 * 5 == 120
    assert nbytes == (3 * 4 + 2 * 4 * 5 + 3 * 5) * 2 == 134


def test_model_flops_hand_worked():
    spec = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
            "head_dim": 2, "d_ff": 8, "n_experts": 0, "vocab_size": 10,
            "window": 0}
    # a token: q and o 2 * 2 * 4 * 4 = 64, k and v 2 * 2 * 4 * 2 = 32,
    # SwiGLU 3 * 2 * 4 * 8 = 192: 288; two tokens 576; attention over 3
    # pairs 4 * 2 * 2 * 3 = 48; the LM head on the last 2 * 4 * 10 = 80
    assert work.model_flops(spec, 1, 2, 0) == 576 + 48 + 80
    # a decode step at position 2 sees 3 keys: 288 + 4 * 2 * 2 * 3 + 80
    assert work.model_flops(spec, 3, 1, 2) == 3 * (288 + 48 + 80)
    moe = dict(spec, n_experts=4, top_k=2, expert_d_ff=8)
    # router 2 * 4 * 4 = 32 and two experts 2 * 3 * 2 * 4 * 8 = 384
    assert work.layer_token_flops(moe) == 64 + 32 + 32 + 384


def test_bound_takes_the_larger_term():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_recorders_count_rows_that_hold_a_token():
    """The traced job's expert products: rows that hold a token are the
    admitted (token, expert) pairs, whatever the capacity buffer's size;
    every flash call is recorded with its shapes."""
    from bench import spec as S
    from bench import weights
    from bench.harness import Recorders, program_config
    from bench.reference import decoder
    from repro_torch.models import prefill

    cfg_file = S.sized(S.config_file(S.benchmark(), "mixtral-8x7b-16L"),
                       smoke=True)
    spec = S.model_spec(cfg_file)
    cfg = program_config(cfg_file["program_arch"], spec, smoke=True)
    params = weights.to_program(cfg, weights.make(cfg, 3, "cpu"))
    tokens = torch.randint(0, spec["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(1))
    with Recorders() as rec:
        prefill(cfg, params, {"tokens": tokens}, max_len=32)
    calls = rec.gmm_calls()
    assert len(calls) == 3 * spec["n_layers"]
    for i, (rows, held, D, F, size) in enumerate(calls):
        # the pairs within capacity (16 of a row's 48 claims an expert)
        experts = rec.dispatches[i // 3][0]
        want = sum(int(decoder.admitted(experts[b], [24], spec).sum())
                   for b in range(2))
        assert rows == want <= 2 * 24 * 2
        assert held == len(set(experts.flatten().tolist()))
        assert {D, F} == {spec["d_model"], spec["expert_d_ff"]}
        assert size == 2
    assert [c[:6] for c in rec.flash] == [
        (2, 24, 24, spec["n_heads"], spec["n_kv_heads"],
         spec["head_dim"])] * spec["n_layers"]
