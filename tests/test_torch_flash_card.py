"""The port's CUDA flash kernel against its plain PyTorch version, on the
card.  These tests need a CUDA device and skip without one; they import
no JAX, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_card.py

Tolerances (atol = rtol): f32 5e-5, summation order only; bf16 2e-2, the
kernel carries P to the tensor-core P.V product as a bf16 hi + lo pair
and both round the output once (as in tests/test_kernels.py).  The
log-sum-exp output (what the backward reads): f32 5e-5; bf16 2e-4, the
same exact products of bf16 inputs summed in f32 in both, the kernel's max
in log2 units and its exp2 the SFU's (about 2 ulp).  The autograd op's
dq, dk, dv with the kernel forward against those with the plain forward
(the same plain backward), normalised by max |want|: f32 1e-4, the
forwards' summation order; bf16 2e-2, an ulp or two where the two outputs
round apart.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
LSE_TOL = {"float32": 5e-5, "bfloat16": 2e-4}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_cuda_kernel_matches_plain_on_card(dtype, D):
    gen = _card()
    dt = getattr(torch, dtype)
    B, S, Hq, Hkv = 2, 200, 8, 4
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda", dtype=dt)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda",
                        dtype=dt) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    before = ops.launches
    got = ops.flash_attention_fwd(q, k, v, pos, pos, window=64)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ops.flash_attention_fwd(q, k, v, pos, pos, window=64, impl="ref")
    assert ops.launches == before + 1       # the plain version never counts
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [0, 1])
def test_cuda_kernel_takes_strided_views(pad):
    """q, k, v as head slices of one fused projection.  With pad=0 the
    kernel's TMA reads them in place; with pad=1 the row starts are not
    16-byte aligned, which TMA cannot read, so the wrapper hands the kernel
    contiguous copies (never the plain version); the result is the same."""
    gen = _card()
    S, H, D = 100, 4, 64
    fused = torch.randn((1, S, 3 * H * D + pad), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
    qkv = fused[..., pad:].reshape(1, S, 3 * H, D)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    got = ops.flash_attention_fwd(q, k, v, pos, pos)
    want = ops.flash_attention_fwd(q, k, v, pos, pos, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,Hq,Hkv,D", [
    ("granite-moe-1b-a400m", 16, 8, 64),
    ("zamba2-2.7b", 32, 32, 80),
    ("qwen3-0.6b", 16, 8, 128),
    ("deepseek-7b", 32, 32, 128),
    ("internlm2-20b", 48, 8, 128),
    ("qwen3-8b", 32, 8, 128),
])
def test_served_prefill_shapes(arch, Hq, Hkv, D):
    """The served models' prefill attention: 3 slots of 1024 tokens,
    causal, bf16."""
    gen = _card()
    B, S = 3, 1024
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    got = ops.flash_attention_fwd(q, k, v, pos, pos)
    want = ops.flash_attention_fwd(q, k, v, pos, pos, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 128])
def test_window_cuts_inside_a_tile(D):
    """A sliding window of 50 keys, which ends inside the kernel's 128-key
    tiles, over ragged S and T (T != S, neither a tile multiple) with
    shuffled positions and unwritten (-1) ring slots."""
    gen = _card()
    B, S, T, Hq, Hkv = 2, 300, 333, 8, 4
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, T, Hkv, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    k_pos = torch.randperm(T, generator=gen, device="cuda").to(torch.int32)
    k_pos[torch.randperm(T, generator=gen, device="cuda")[:40]] = -1
    q_pos = torch.arange(T - S, T, dtype=torch.int32, device="cuda")
    for kp in (torch.arange(T, dtype=torch.int32, device="cuda"), k_pos):
        got = ops.flash_attention_fwd(q, k, v, q_pos, kp, window=50)
        want = ops.flash_attention_fwd(q, k, v, q_pos, kp, window=50,
                                       impl="ref")
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def _gqa_inputs(gen, dtype, D, groups, B=2, S=300, Hkv=2):
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, Hkv * groups, D), generator=gen, device="cuda",
                    dtype=dt)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda",
                        dtype=dt) for _ in range(2))
    return q, k, v, torch.arange(S, dtype=torch.int32, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 2, 4, 6])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_matches_plain_on_card(dtype, D, groups):
    """The kernel's (B,Hq,S) f32 log-sum-exp at ragged S (300: the last
    128-row tile part full) against the plain version's; asking for it
    leaves the output as it is without it, bit for bit."""
    gen = _card()
    q, k, v, pos = _gqa_inputs(gen, dtype, D, groups)
    before = ops.launches
    out, lse = ops.flash_attention_fwd(q, k, v, pos, pos, window=64,
                                       return_lse=True)
    bare = ops.flash_attention_fwd(q, k, v, pos, pos, window=64)
    torch.cuda.synchronize()
    assert ops.launches == before + 2
    _, want = ops.flash_attention_fwd(q, k, v, pos, pos, window=64,
                                      impl="ref", return_lse=True)
    assert lse.shape == want.shape == (2, 2 * groups, 300)
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=LSE_TOL[dtype],
                               rtol=LSE_TOL[dtype])
    assert torch.equal(out, bare)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 2, 4, 6])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_with_kernel_forward_matches_plain(dtype, D, groups):
    """dq, dk, dv through the autograd op: the kernel's forward (one
    launch, with its lse) and the plain backward, against the plain
    forward and the same backward; dk and dv summed over each group."""
    gen = _card()
    q, k, v, pos = _gqa_inputs(gen, dtype, D, groups)
    dout = torch.randn(q.shape, generator=gen, device="cuda", dtype=q.dtype)
    grads = {}
    for impl in ("auto", "ref"):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        before = ops.launches
        out = ops.flash_attention_fwd(*leaves, pos, pos, impl=impl)
        assert ops.launches == before + (impl == "auto")
        grads[impl] = torch.autograd.grad(out, leaves, dout)
    for got, want, t in zip(grads["auto"], grads["ref"], (q, k, v)):
        assert got.shape == t.shape and got.dtype == t.dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,Hq,Hkv", [
    ("deepseek-7b", 32, 32),
    ("internlm2-20b", 48, 8),
    ("qwen3-8b", 32, 8),
])
def test_dense_train_layouts_lse_and_autograd(arch, Hq, Hkv, dtype):
    """The three dense configs' attention at head dim 128 (MHA 32/32, a
    query-head group of 6, 32/8), one row of S = T = 1024, causal: the
    output, the lse and the autograd op's dq, dk, dv with the kernel
    forward against the plain forward."""
    gen = _card()
    dt = getattr(torch, dtype)
    S, D = 1024, 128
    q = torch.randn((1, S, Hq, D), generator=gen, device="cuda", dtype=dt)
    k, v = (torch.randn((1, S, Hkv, D), generator=gen, device="cuda",
                        dtype=dt) for _ in range(2))
    dout = torch.randn(q.shape, generator=gen, device="cuda", dtype=dt)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    outs, lses, grads = {}, {}, {}
    for impl in ("auto", "ref"):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        before = ops.launches
        outs[impl], lses[impl] = ops.flash_attention_fwd(
            *leaves, pos, pos, impl=impl, return_lse=True)
        assert ops.launches == before + (impl == "auto")
        grads[impl] = torch.autograd.grad(outs[impl], leaves, dout)
    torch.testing.assert_close(outs["auto"].float(), outs["ref"].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lses["auto"], lses["ref"],
                               atol=LSE_TOL[dtype], rtol=LSE_TOL[dtype])
    for got, want in zip(grads["auto"], grads["ref"]):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,causal", [(512, 512, False),
                                        (1024, 512, False),
                                        (1024, 1024, True)],
                         ids=["encoder", "cross", "decoder"])
def test_whisper_layouts_lse_and_autograd(S, T, causal, dtype):
    """whisper-base's three attentions, MHA 8/8 at head dim 64, one row:
    the encoder's self-attention (S = T = 512, non-causal), the decoder's
    cross-attention over it (S = 1024 queries, T = 512 keys, non-causal:
    more queries than keys) and the decoder's self-attention (S = T =
    1024, causal).  The output, the lse and the autograd op's dq, dk, dv
    with the kernel forward against the plain forward; every non-causal
    row sees every key, so none is fully masked."""
    gen = _card()
    dt = getattr(torch, dtype)
    H, D = 8, 64
    q = torch.randn((1, S, H, D), generator=gen, device="cuda", dtype=dt)
    k, v = (torch.randn((1, T, H, D), generator=gen, device="cuda",
                        dtype=dt) for _ in range(2))
    dout = torch.randn(q.shape, generator=gen, device="cuda", dtype=dt)
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    k_pos = torch.arange(T, dtype=torch.int32, device="cuda")
    outs, lses, grads = {}, {}, {}
    for impl in ("auto", "ref"):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        before = ops.launches
        outs[impl], lses[impl] = ops.flash_attention_fwd(
            *leaves, q_pos, k_pos, causal=causal, impl=impl,
            return_lse=True)
        assert ops.launches == before + (impl == "auto")
        grads[impl] = torch.autograd.grad(outs[impl], leaves, dout)
    assert bool((lses["auto"] > -1e29).all())
    torch.testing.assert_close(outs["auto"].float(), outs["ref"].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lses["auto"], lses["ref"],
                               atol=LSE_TOL[dtype], rtol=LSE_TOL[dtype])
    for got, want in zip(grads["auto"], grads["ref"]):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_frontend_prefill_kernel_matches_plain(arch):
    """One prefill of each arch's smoke config in f32 on the card (frames
    or patches in the model's dtype), the kernel against ``impl="ref"``:
    flash launches once an attention (whisper: each encoder layer's, and
    each decoder layer's self and cross), logits and every cache within 1e-4 (the kernel's
    summation order, carried through the layers)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, prefill

    gen = _card()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, gen, "cuda")
    B, S = 2, 64
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda")}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.frontend_dim),
                                       generator=gen, device="cuda")
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.randn((B, S // 2, cfg.frontend_dim),
                                      generator=gen, device="cuda")
    max_len = S + cfg.n_patches + 8
    before = ops.launches
    got, got_cache = prefill(cfg, params, batch, max_len)
    n = cfg.n_layers * (2 if cfg.is_encdec else 1) + cfg.n_enc_layers
    assert ops.launches == before + n
    want, want_cache = prefill(cfg, params, batch, max_len, impl="ref")
    assert ops.launches == before + n
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert got_cache["pos"] == want_cache["pos"] == S + (
        cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    for part in ("layers", "cross"):
        for g, w in zip(got_cache.get(part, []), want_cache.get(part, [])):
            for name in ("k", "v"):
                torch.testing.assert_close(g[name], w[name], atol=1e-4,
                                           rtol=1e-4)
