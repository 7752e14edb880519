"""The port's CUDA WKV recurrence against its plain PyTorch version, on the
card.  These tests need a CUDA device and skip without one; they import
no JAX, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wkv_card.py

Tolerance: 5e-3 atol = rtol, as in tests/test_kernels.py, for y and the
final state, against the plain version's f32 result on the same inputs;
a bf16 y adds its one rounding, at most half a bf16 ulp (2^-8 relative).
Both sum in f64 and round once, so y also equals the plain version's y
in its own dtype, bit for bit, in all but a vanishing share of places
(where two f64 sums straddle an f32 rounding boundary).  The autograd
op's backward replays the plain version (f64) on the saved inputs, so
its gradients with the kernel forward equal those with the plain forward.
"""

import pytest
import torch

from repro_torch.kernels.rwkv6_wkv import ops

TOL = 5e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, B, S, H, P, dtype, u_scale=0.1):
    """The reference tests' laws: r, k, v N(0, 1), w = exp(-exp(N(0, .25)
    - 2)), u N(0, u_scale^2)."""
    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (rnd((B, S, H, P)).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rnd((B, S, H, P)) * 0.5 - 2))
    return r, k, v, w, rnd((H, P)) * u_scale


def _compare(r, k, v, w, u, init=None):
    before = ops.launches
    y, state = ops.wkv(r, k, v, w, u, init)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want_y, want_state = ops.wkv(r.float(), k.float(), v.float(), w, u,
                                 init, impl="ref")
    assert ops.launches == before + 1       # the plain version never counts
    B, S, H, P = r.shape
    assert y.shape == (B, S, H, P) and y.dtype == r.dtype
    assert state.shape == (B, H, P, P) and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(state, want_state, atol=TOL, rtol=TOL)
    assert (y == want_y.to(y.dtype)).float().mean().item() >= 0.9999


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P", [
    (2, 64, 2, 32), (1, 128, 4, 64), (2, 32, 2, 16), (1, 1000, 2, 64),
    (3, 12, 4, 16), (1, 200, 2, 128)])
@pytest.mark.parametrize("with_init", [False, True])
def test_cuda_kernel_matches_plain_on_card(dtype, B, S, H, P, with_init):
    """The reference sweep, ragged S (1000, 12, 200), P = 16 to 128, a
    bonus u of N(0, .25) and a zero or a given initial state."""
    gen = _card()
    r, k, v, w, u = _inputs(gen, B, S, H, P, getattr(torch, dtype), 0.5)
    init = (torch.randn((B, H, P, P), generator=gen, device="cuda")
            if with_init else None)
    _compare(r, k, v, w, u, init)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_strided_views(dtype):
    """r, k and v as slices of one wider projection and w as a slice of a
    wider f32 tensor, read in place."""
    gen = _card()
    dt = getattr(torch, dtype)
    B, S, H, P = 2, 300, 4, 32
    proj = torch.randn((B, S, 3 * H * P + 8), generator=gen,
                       device="cuda").to(dt)
    r, k, v = (proj[..., 8 + i * H * P:8 + (i + 1) * H * P].view(B, S, H, P)
               for i in range(3))
    wide = torch.exp(-torch.exp(torch.randn((B, S, H, P + 16), generator=gen,
                                            device="cuda") * 0.5 - 2))
    w = wide[..., 16:]
    u = torch.randn((H, P), generator=gen, device="cuda") * 0.5
    assert not r.is_contiguous() and not w.is_contiguous()
    _compare(r, k, v, w, u,
             torch.randn((B, H, P, P), generator=gen, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [40, 48, 64, 96])
@pytest.mark.parametrize("P", [16, 64, 128])
def test_cuda_kernel_sequence_ends_inside_and_at_a_step(dtype, S, P):
    """The kernel's producer warps fill a ring of two chunks of 16 rows
    ahead of its chain warps (a step of the ring is two chunks): S 40
    ends inside a chunk and 48 at a chunk's end, both inside a step; 64
    and 96 end exactly at a step's end.  P 16, 64 (one block a head) and
    128 (two), an initial state."""
    gen = _card()
    B, H = 2, 3
    r, k, v, w, u = _inputs(gen, B, S, H, P, getattr(torch, dtype), 0.5)
    _compare(r, k, v, w, u,
             torch.randn((B, H, P, P), generator=gen, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_at_rwkv6_7b_prefill_shape(dtype):
    """rwkv6-7b's prefill WKV serving 3 slots, B3 S1024 H64 P64, with the
    cache's initial state."""
    gen = _card()
    B, S, H, P = 3, 1024, 64, 64
    r, k, v, w, u = _inputs(gen, B, S, H, P, getattr(torch, dtype), 0.5)
    _compare(r, k, v, w, u,
             torch.randn((B, H, P, P), generator=gen, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [16, 64, 128])
@pytest.mark.parametrize("all_at_cap", [False, True])
def test_cuda_kernel_decays_at_the_rate_cap(dtype, P, all_at_cap):
    """Decay rates log-normal around 4.5 and capped at 5, as the model caps
    them (about half at the cap), or every one at the cap: k~ reaches
    e^80 |k| at a chunk's last row."""
    gen = _card()
    B, S, H = 2, 200, 2
    r, k, v, _, u = _inputs(gen, B, S, H, P, getattr(torch, dtype), 0.5)
    rate = torch.exp(torch.randn((B, S, H, P), generator=gen, device="cuda")
                     * 0.5 + 1.5)
    if all_at_cap:
        rate = torch.full_like(rate, 5.0)
    w = torch.exp(-torch.clamp(rate, max=5.0))
    _compare(r, k, v, w, u,
             torch.randn((B, H, P, P), generator=gen, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_with_kernel_forward_matches_plain(dtype):
    """The ``WKV`` op at rwkv6-7b's train shape (B4 S1024 H64 P64, no
    initial state, the final state dropped as training drops it): y with
    the kernel forward (one launch) against the plain forward, and the
    gradients of r, k, v, w and u equal."""
    gen = _card()
    dt = getattr(torch, dtype)
    inputs = _inputs(gen, 4, 1024, 64, 64, dt, 0.5)
    dy = torch.randn(inputs[0].shape, generator=gen, device="cuda").to(dt)
    ys, grads = {}, {}
    for impl in ("auto", "ref"):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        before = ops.launches
        ys[impl], _ = ops.wkv(*leaves, impl=impl)
        assert ops.launches == before + (impl == "auto")
        grads[impl] = torch.autograd.grad(ys[impl], leaves, dy)
    torch.testing.assert_close(ys["auto"].float(), ys["ref"].float(),
                               atol=TOL, rtol=TOL)
    assert (ys["auto"] == ys["ref"]).float().mean().item() >= 0.9999
    for got, want, t in zip(grads["auto"], grads["ref"], inputs):
        assert got.shape == t.shape and got.dtype == t.dtype
        assert torch.equal(got, want)
