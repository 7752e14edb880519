"""The port's CUDA grouped expert matmul against its plain PyTorch
version, on the card: the f32 kernel and both bf16 kernels (wide for
many rows an expert, narrow for few), each case also checking which
kernel ran and that it counted one launch.  These tests need a CUDA
device and skip without one; they import no JAX, so they run on the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gmm_card.py

Tolerances, normalised by max |want| (tests/test_kernels.py): f32 1e-5,
summation order only (the kernel keeps f32 off the tf32 tensor cores);
bf16 2e-2, one rounding of the f32 sum to bf16 in both.  The autograd
op's backward is plain and reads only x, w and dy, so its gradients with
the kernel forward equal those with the plain forward.
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


def _run(B, E, C, D, F, w_scale, want_kernel, dtype="bfloat16"):
    gen = _card()
    dt = getattr(torch, dtype)
    x = torch.randn((B, E, C, D), generator=gen, device="cuda", dtype=dt)
    w = torch.randn((E, D, F), generator=gen, device="cuda",
                    dtype=dt) * w_scale
    before = ops.launches
    got = ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert ops.launches == before + 1 and ops.last_kernel == want_kernel
    want = ops.grouped_matmul(x, w, impl="ref")
    assert got.shape == (B, E, C, F) and got.dtype == dt
    _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("C,kernel", [(40, "wide"), (8, "narrow")])
def test_bf16_kernels_read_strided_expert_buffers(C, kernel):
    """The strided (B,E,C,D) buffer in each bf16 kernel: 120 rows an
    expert go to the wide one, 24 to the narrow one."""
    gen = _card()
    B, E, D, F = 3, 4, 128, 96
    big = torch.randn((B, E + 1, C + 8, D + 16), generator=gen,
                      device="cuda", dtype=torch.bfloat16)
    x = big[:, 1:, 3:3 + C, 8:8 + D]
    w = torch.randn((E, D, F), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.05
    before = ops.launches
    got = ops.grouped_matmul(x, w)
    assert ops.launches == before + 1 and ops.last_kernel == kernel
    want = ops.grouped_matmul(x, w, impl="ref")
    assert got.shape == (B, E, C, F) and got.is_contiguous()
    _assert_close(got, want, "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("B,E,C,D,F,kernel", [
    (3, 32, 320, 1024, 512, "wide"),     # prefill, wi (gate and up)
    (3, 32, 320, 512, 1024, "wide"),     # prefill, wo
    (3, 32, 8, 1024, 512, "narrow"),     # decode, wi
    (3, 32, 8, 512, 1024, "narrow"),     # decode, wo
])
def test_bf16_kernels_at_granites_serving_shapes(B, E, C, D, F, kernel):
    _run(B, E, C, D, F, D ** -0.5, kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,kernel", [
    (1, 64, "narrow"), (1, 72, "wide"), (8, 8, "narrow"), (3, 24, "wide")])
def test_bf16_rows_on_each_side_of_the_narrow_limit(B, C, kernel):
    """64 rows an expert (the narrow kernel's N at its limit) and 72."""
    _run(B, 8, C, 1024, 512, 1024 ** -0.5, kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [40, 200, 328])
def test_bf16_wide_half_tiles_ending_inside_a_batch_row(C):
    """The wide kernel's 64-row half-tiles never cross a batch row; with C
    not a multiple of 64 the last one of each row is partly past C."""
    _run(3, 4, C, 256, 384, 0.05, "wide")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 3, 8])
def test_bf16_narrow_n(B):
    """The narrow kernel's N (an expert's rows) at 8, 16, 24 and 64."""
    _run(B, 8, 8, 1024, 512, 1024 ** -0.5, "narrow")


# granite-moe-1b-a400m's expert products when training B4 x S1024: C =
# _capacity(1024 tokens) = 320, (B, E, C, D, F) of wi and of wo
TRAIN_PRODUCTS = {"wi": (4, 32, 320, 1024, 512), "wo": (4, 32, 320, 512, 1024)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("product", ["wi", "wo"])
def test_autograd_with_kernel_forward_matches_plain(dtype, product):
    """The ``GroupedMatmul`` op at granite's train shapes: the output with
    the kernel forward (one launch) against the plain forward, and dx, dw
    equal."""
    gen = _card()
    B, E, C, D, F = TRAIN_PRODUCTS[product]
    dt = getattr(torch, dtype)
    x = torch.randn((B, E, C, D), generator=gen, device="cuda").to(dt)
    w = (torch.randn((E, D, F), generator=gen, device="cuda")
         * D ** -0.5).to(dt)
    dy = torch.randn((B, E, C, F), generator=gen, device="cuda").to(dt)
    outs, grads = {}, {}
    for impl in ("auto", "ref"):
        leaves = [t.detach().requires_grad_(True) for t in (x, w)]
        before = ops.launches
        outs[impl] = ops.grouped_matmul(*leaves, impl=impl)
        assert ops.launches == before + (impl == "auto")
        assert type(outs[impl].grad_fn).__name__ == "GroupedMatmulBackward"
        grads[impl] = torch.autograd.grad(outs[impl], leaves, dy)
    _assert_close(outs["auto"], outs["ref"], dtype)
    for got, want, t in zip(grads["auto"], grads["ref"], (x, w)):
        assert got.shape == t.shape and got.dtype == t.dtype
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("C,kernel", [(320, "wide"), (8, "narrow")])
def test_kernel_reads_weights_updated_in_place(C, kernel):
    """AdamW updates the weights in place, so their address stays and the
    cached tensor map is reused: a call after an in-place update reads the
    new values."""
    gen = _card()
    x = torch.randn((2, 4, C, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((4, 256, 128), generator=gen, device="cuda")
         * 256 ** -0.5).to(torch.bfloat16)
    for _ in range(2):
        got = ops.grouped_matmul(x, w)
        assert ops.last_kernel == kernel
        _assert_close(got, ops.grouped_matmul(x, w, impl="ref"), "bfloat16")
        with torch.no_grad():
            w.mul_(-0.5).add_(0.01)
