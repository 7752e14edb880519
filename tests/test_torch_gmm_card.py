"""The port's CUDA grouped expert matmul against its plain PyTorch
version, on the card.  These tests need a CUDA device and skip without
one; they import no JAX, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gmm_card.py

Tolerances, normalised by max |want| (tests/test_kernels.py): f32 1e-5,
summation order only (the kernel keeps f32 off the tf32 tensor cores);
bf16 2e-2, one rounding of the f32 sum to bf16 in both.
"""

import pytest
import torch

from repro_torch.kernels.moe_gmm import ops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, want, dtype):
    scale = want.float().abs().max()
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               atol=TOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [(4, 128, 256, 128), (2, 256, 512, 256),
                                     (3, 8, 64, 64), (2, 24, 1024, 512),
                                     (1, 320, 72, 40)])
def test_cuda_kernel_matches_plain_on_card(dtype, E, C, D, F):
    """The reference sweep, ragged C (8, 24, 320), D not a multiple of the
    k-tile and F not a multiple of the column tile."""
    gen = _card()
    dt = getattr(torch, dtype)
    x = torch.randn((E, C, D), generator=gen, device="cuda", dtype=dt)
    w = torch.randn((E, D, F), generator=gen, device="cuda", dtype=dt) * 0.05
    before = ops.launches
    got = ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ops.grouped_matmul(x, w, impl="ref")
    assert ops.launches == before + 1       # the plain version never counts
    assert got.shape == (E, C, F) and got.dtype == dt
    _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_strided_expert_buffers(dtype):
    """x (B,E,C,D) as a slice of a larger buffer: strides on B, E and C
    that are not those of a contiguous tensor, read in place."""
    gen = _card()
    dt = getattr(torch, dtype)
    B, E, C, D, F = 3, 4, 40, 128, 96
    big = torch.randn((B, E + 1, C + 8, D + 16), generator=gen,
                      device="cuda", dtype=dt)
    x = big[:, 1:, 3:3 + C, 8:8 + D]
    w = torch.randn((E, D, F), generator=gen, device="cuda", dtype=dt) * 0.05
    got = ops.grouped_matmul(x, w)
    want = ops.grouped_matmul(x, w, impl="ref")
    assert got.shape == (B, E, C, F) and got.is_contiguous()
    _assert_close(got, want, dtype)
