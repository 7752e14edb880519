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


def test_flash_work_with_unequal_head_dims_hand_worked():
    # B 2, S 3 queries, the last 3 of T = 5 keys, Hq 4, Hkv 2, D 192 for
    # q and k, Dv 128 for v and the output, causal: 3 + 4 + 5 = 12 pairs
    flops, nbytes = work.flash_work(2, 3, 5, 4, 2, 192, window=0, Dv=128)
    # QK^T 2 * 192 and PV 2 * 128 FLOP a pair a head a row
    assert flops == 2 * 4 * 12 * (2 * 192 + 2 * 128) == 61_440
    # q 2x3x4x192, out 2x3x4x128, k 2x5x2x192, v 2x5x2x128, bf16; two
    # int32 position vectors of 3 and 5
    assert nbytes == (4608 + 3072 + 3840 + 2560) * 2 + 4 * 8 == 28_192
    # Dv = D is the count of equal head dims
    assert work.flash_work(2, 3, 5, 4, 2, 192, window=0, Dv=192) == \
        work.flash_work(2, 3, 5, 4, 2, 192, window=0)


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
    from repro_torch.models import prefill

    cfg_file = S.sized(S.config_file(S.benchmark(), "mixtral-8x7b-16L"),
                       smoke=True)
    decoder = S.reference(cfg_file)
    spec = decoder.spec(cfg_file)
    cfg = program_config(decoder, cfg_file, spec, smoke=True)
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
    assert [c[:7] for c in rec.flash] == [
        (2, 24, 24, spec["n_heads"], spec["n_kv_heads"], spec["head_dim"],
         spec["head_dim"])] * spec["n_layers"]


def test_recorders_find_a_kernel_bound_in_any_model_module(monkeypatch):
    """A flash call made through another ``repro_torch.models`` module's
    binding of the name is recorded, here a latent attention's with v's
    head dim apart from q's; the binding is restored after."""
    import sys
    import types

    from bench.harness import Recorders

    mod = types.ModuleType("repro_torch.models._latent_probe")
    exec("import torch\n"
         "def flash_attention_fwd(q, k, v, q_pos, k_pos, *, window=0,\n"
         "                        causal=True, impl='auto'):\n"
         "    return q.new_zeros(q.shape[:3] + v.shape[-1:])\n"
         "def attend(q, k, v, pos):\n"
         "    return flash_attention_fwd(q, k, v, pos, pos)\n",
         mod.__dict__)
    kernel = mod.flash_attention_fwd
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    q, k = torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24)
    v = torch.zeros(1, 8, 2, 16, dtype=torch.float32)
    with Recorders() as rec:
        out = mod.attend(q, k, v, torch.arange(8, dtype=torch.int32))
    assert rec.flash == [(1, 8, 8, 4, 2, 24, 16, 0, True, 4)]
    assert out.shape == (1, 8, 4, 16)
    assert mod.flash_attention_fwd is kernel
