"""The port's CUDA flash kernel against its plain PyTorch version, on the
card.  These tests need a CUDA device and skip without one; they import
no JAX, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_card.py

Tolerances (atol = rtol): f32 5e-5, summation order only; bf16 2e-2, the
kernel rounds P to bf16 for the tensor-core P.V product and both round
the output once (as in tests/test_kernels.py).
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
    """q, k, v as head slices of one fused projection.  With pad=1 the row
    starts are not 16-byte aligned, so the kernel takes its element loads
    instead of its vector loads; the result is the same."""
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
