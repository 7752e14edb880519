"""The port's CUDA SSD scan against its plain PyTorch version, on the card.
These tests need a CUDA device and skip without one; they import no JAX,
so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_card.py

Tolerances: f32 1e-3 atol = rtol (tests/test_kernels.py; the kernel's
chunk of 64 against the plain version's 256 moves y by about 4e-5); bf16
2e-2 normalised by max |want|, one rounding of y to bf16 in both.  The
autograd op's backward replays the plain version on the saved inputs, so
its gradients with the kernel forward equal those with the plain forward.
"""

import pytest
import torch

from repro_torch.kernels.mamba2_ssd import ops

TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, B, S, H, P, N, dtype):
    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    a = -rnd((B, S, H), 0.1).abs()
    return (rnd((B, S, H, P), 0.5).to(dtype), a, rnd((B, S, N), 0.5).to(dtype),
            rnd((B, S, N), 0.5).to(dtype))


def _assert_close(got, want, dtype):
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    else:
        scale = want.float().abs().max()
        torch.testing.assert_close(got.float() / scale, want.float() / scale,
                                   atol=TOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N", [
    (2, 256, 4, 64, 64), (1, 512, 2, 64, 32), (2, 128, 8, 32, 64),
    (1, 1000, 2, 64, 64), (3, 12, 4, 16, 16), (1, 200, 3, 48, 128)])
@pytest.mark.parametrize("with_init", [False, True])
def test_cuda_kernel_matches_plain_on_card(dtype, B, S, H, P, N, with_init):
    """The reference sweep, ragged S (1000, 12, 200), P = 16 and 48 (the
    16-column tile) and N = 16 and 128, from a zero and a given state."""
    gen = _card()
    dt = getattr(torch, dtype)
    xdt, a, Bm, Cm = _inputs(gen, B, S, H, P, N, dt)
    init = (torch.randn((B, H, P, N), generator=gen, device="cuda")
            if with_init else None)
    before = ops.launches
    y, state = ops.ssd(xdt, a, Bm, Cm, init)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want_y, want_state = ops.ssd(xdt, a, Bm, Cm, init, impl="ref")
    assert ops.launches == before + 1       # the plain version never counts
    assert y.shape == xdt.shape and y.dtype == dt
    assert state.shape == (B, H, P, N) and state.dtype == torch.float32
    _assert_close(y, want_y, dtype)
    _assert_close(state, want_state, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_strided_views(dtype):
    """xdt, B and C as slices of one wider projection (the layout a fused
    in-projection gives), read in place."""
    gen = _card()
    dt = getattr(torch, dtype)
    B, S, H, P, N = 2, 300, 4, 32, 64
    proj = torch.randn((B, S, H * P + 2 * N + 8), generator=gen,
                       device="cuda").to(dt) * 0.5
    xdt = proj[..., 8:8 + H * P].view(B, S, H, P)
    Bm, Cm = proj[..., 8 + H * P:8 + H * P + N], proj[..., 8 + H * P + N:]
    a = -(torch.randn((B, S, H), generator=gen, device="cuda") * 0.1).abs()
    assert not xdt.is_contiguous() and not Bm.is_contiguous()
    y, state = ops.ssd(xdt, a, Bm, Cm)
    want_y, want_state = ops.ssd(xdt, a, Bm, Cm, impl="ref")
    _assert_close(y, want_y, dtype)
    _assert_close(state, want_state, dtype)


def _check_case(gen, B, S, H, P, N, dtype, with_init, a=None):
    dt = getattr(torch, dtype)
    xdt, a0, Bm, Cm = _inputs(gen, B, S, H, P, N, dt)
    a = a0 if a is None else a
    init = (torch.randn((B, H, P, N), generator=gen, device="cuda")
            if with_init else None)
    before = ops.launches
    y, state = ops.ssd(xdt, a, Bm, Cm, init)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want_y, want_state = ops.ssd(xdt, a, Bm, Cm, init, impl="ref")
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    _assert_close(y, want_y, dtype)
    _assert_close(state, want_state, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N", [
    (3, 1024, 80, 64, 64), (2, 100, 3, 64, 64), (2, 128, 3, 64, 64),
    (2, 192, 3, 64, 32), (1, 384, 5, 64, 64)])
@pytest.mark.parametrize("with_init", [False, True])
def test_cuda_kernel_served_shape_and_ring_edges(dtype, B, S, H, P, N,
                                                 with_init):
    """zamba2-2.7b's prefill shape (B3 S1024 H80 P64 N64), and S at the
    edges of the bf16 kernel's rings of two state slots (128 rows) and
    three input slots (192 rows): ending inside the first state turn (100),
    at its end (128), at the end of an input turn (192) and of both (384).
    A block takes one head, so every H is whole."""
    _check_case(_card(), B, S, H, P, N, dtype, with_init)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-4, 10.0])
def test_cuda_kernel_decays_near_zero_and_strongly_negative(dtype, scale):
    """Log decays a = -|N(0, scale^2)|: near 0 (no decay over a chunk) and
    down to about -10 a row and below (the state forgets within a row;
    exp of the chunk's cumulative sums underflows to 0), with an initial
    state, against the plain version."""
    gen = _card()
    B, S, H, P, N = 2, 300, 4, 64, 64
    a = -(torch.randn((B, S, H), generator=gen, device="cuda")
          * scale).abs()
    if scale > 1:
        a = a.clamp(min=-40.0)
        a[:, ::7] = -10.0
    _check_case(gen, B, S, H, P, N, dtype, True, a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_with_kernel_forward_matches_plain(dtype):
    """The ``SSD`` op at zamba2's train shape (B4 S1024 H80 P64 N64, zero
    initial state, the final state dropped as training drops it): y with
    the kernel forward (one launch) against the plain forward, and the
    gradients of xdt, a, B and C equal."""
    gen = _card()
    dt = getattr(torch, dtype)
    inputs = _inputs(gen, 4, 1024, 80, 64, 64, dt)
    dy = torch.randn(inputs[0].shape, generator=gen, device="cuda").to(dt)
    ys, grads = {}, {}
    for impl in ("auto", "ref"):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        before = ops.launches
        ys[impl], _ = ops.ssd(*leaves, impl=impl)
        assert ops.launches == before + (impl == "auto")
        grads[impl] = torch.autograd.grad(ys[impl], leaves, dy)
    _assert_close(ys["auto"], ys["ref"], dtype)
    for got, want, t in zip(grads["auto"], grads["ref"], inputs):
        assert got.shape == t.shape and got.dtype == t.dtype
        assert torch.equal(got, want)
