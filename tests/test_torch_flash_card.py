"""The port's CUDA flash kernel against its plain PyTorch version, on the
card.  These tests need a CUDA device and skip without one; they import
no JAX, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_card.py

Tolerances (atol = rtol): f32 5e-5, summation order only; bf16 2e-2, the
kernel carries P to the tensor-core P.V product as a bf16 hi + lo pair
and both round the output once (as in tests/test_kernels.py).
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops

TOL = {"float32": 5e-5, "bfloat16": 2e-2}


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
