"""The port's SSD scan against the JAX reference, on the CPU.

On the CPU the wrapper runs the plain version; it is held against the
reference model's ``repro.models.mamba2.ssd_chunked`` and against the
Pallas ``ssd_fwd`` in interpret mode, over the reference kernel tests'
sweep (tests/test_kernels.py), with and without an initial state and at
a ragged S.  The Pallas kernel starts from a zero state and takes S as a
multiple of its chunk, so the initial-state and ragged cases are held
against ``ssd_chunked`` alone.  The bf16 CUDA kernel's own arithmetic
(chunk, order, hi + lo splits) is modelled here and held against both.
The CUDA kernel is compared with the plain version on the card by
tests/test_torch_ssd_card.py and by chip_smoke.py.

Tolerance: 1e-3 atol = rtol, as in tests/test_kernels.py (f32; the chunk
size moves the sums by about 4e-5).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.mamba2_ssd.ops import ssd as jax_ssd  # noqa: E402
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref  # noqa: E402

SWEEP = [(2, 256, 4, 64, 64, 128), (1, 512, 2, 64, 32, 128),
         (2, 128, 8, 32, 64, 64)]


def _inputs(seed, B, S, H, P, N):
    """The reference tests' laws: x N(0, .25), a = -|N(0, .01)|, B and C
    N(0, .25); an initial state N(0, 1)."""
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    init = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (xdt, a, Bm, Cm), init


def _close(got, want, tol=1e-3):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _port(arrays, init=None):
    before = ops.launches
    y, state = ops.ssd(*map(torch.from_numpy, arrays),
                       None if init is None else torch.from_numpy(init))
    assert ops.launches == before   # a CPU tensor never launches
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    return y.numpy(), state.numpy()


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_ssd_sweep_matches_jax_ssd_chunked_and_pallas(B, S, H, P, N, chunk):
    arrays, _ = _inputs(0, B, S, H, P, N)
    y, state = _port(arrays)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    jarrays = [jnp.asarray(t) for t in arrays]
    want_y, want_state = jax_ssd_chunked(*jarrays)
    _close(y, want_y)
    _close(state, want_state)
    pallas_y, pallas_state = jax_ssd(*jarrays, chunk=chunk,
                                     impl="interpret")
    _close(y, pallas_y)
    _close(state, pallas_state)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_ssd_with_init_state_matches_jax(B, S, H, P, N, chunk):
    arrays, init = _inputs(1, B, S, H, P, N)
    y, state = _port(arrays, init)
    want_y, want_state = jax_ssd_chunked(
        *[jnp.asarray(t) for t in arrays], init_state=jnp.asarray(init))
    _close(y, want_y)
    _close(state, want_state)


@pytest.mark.parametrize("S", [12, 300, 1000])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_ragged_length_matches_jax(S, with_init):
    """S not a multiple of the chunk: the port pads to whole chunks where
    the reference takes one chunk of S; the values agree."""
    arrays, init = _inputs(2, 2, S, 3, 32, 16)
    init = init if with_init else None
    y, state = _port(arrays, init)
    want_y, want_state = jax_ssd_chunked(
        *[jnp.asarray(t) for t in arrays],
        init_state=None if init is None else jnp.asarray(init))
    _close(y, want_y)
    _close(state, want_state)


def test_ssd_keeps_bf16_inputs_dtype():
    """bf16 in: y comes back in bf16, the state in f32, as the reference's
    ``ssd_chunked`` gives them."""
    arrays, init = _inputs(3, 1, 100, 2, 16, 16)
    xdt, a, Bm, Cm = map(torch.from_numpy, arrays)
    xdt, Bm, Cm = (t.to(torch.bfloat16) for t in (xdt, Bm, Cm))
    y, state = ops.ssd(xdt, a, Bm, Cm, torch.from_numpy(init))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want_y, want_state = jax_ssd_chunked(
        *[jnp.asarray(np.asarray(t.float()), dtype) for t, dtype in
          ((xdt, jnp.bfloat16), (a, jnp.float32), (Bm, jnp.bfloat16),
           (Cm, jnp.bfloat16))], init_state=jnp.asarray(init))
    assert want_y.dtype == jnp.bfloat16
    scale = float(np.abs(np.asarray(want_y, np.float32)).max())
    np.testing.assert_allclose(y.float().numpy() / scale,
                               np.asarray(want_y, np.float32) / scale,
                               atol=2e-2)
    _close(state, want_state)


def test_impl_ref_and_unknown_impl():
    arrays, init = _inputs(4, 1, 40, 2, 16, 16)
    t = [torch.from_numpy(x) for x in arrays]
    got = ops.ssd(*t, torch.from_numpy(init), impl="ref")
    want = ssd_ref(*t, torch.from_numpy(init))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd(*t, impl="pallas")


@pytest.mark.parametrize("case,match", [
    ("rank", "need xdt"),
    ("a shape", "do not agree"),
    ("init shape", "init_state"),
    ("P not multiple of 16", "multiple of 16"),
    ("N unsupported", "multiple of 16"),
    ("dtype", "dtypes"),
    ("a dtype", "float32"),
    ("P strided", "contiguous"),
    ("odd row stride", "strides must be multiples of 8"),
    ("cpu", "CUDA"),
])
def test_kernel_checks_raise_on_what_it_does_not_take(case, match):
    """What the wrapper refuses before any launch (the checks run on CPU
    tensors here; the last one is the device check)."""
    B, S, H, P, N = 2, 10, 3, 16, 16
    xdt, a = torch.zeros(B, S, H, P), torch.zeros(B, S, H)
    Bm, Cm = torch.zeros(B, S, N), torch.zeros(B, S, N)
    init = None
    if case == "rank":
        a = torch.zeros(B, S)
    elif case == "a shape":
        a = torch.zeros(B, S, H + 1)
    elif case == "init shape":
        init = torch.zeros(B, H, P, N + 1)
    elif case == "P not multiple of 16":
        xdt = torch.zeros(B, S, H, 24)
    elif case == "N unsupported":
        Bm, Cm = torch.zeros(B, S, 48), torch.zeros(B, S, 48)
    elif case == "dtype":
        xdt = xdt.to(torch.bfloat16)
    elif case == "a dtype":
        a = a.to(torch.bfloat16)
    elif case == "P strided":
        xdt = torch.zeros(B, S, P, H).transpose(2, 3)
    elif case == "odd row stride":
        xdt = torch.zeros(B, S, H, P + 4)[..., :P]
    with pytest.raises(ValueError, match=match):
        ops._check(xdt, a, Bm, Cm, init)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """An f32 tensor as the kernel feeds it to the tensor cores: the
    nearest bf16 value plus the nearest bf16 value to what that left."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _kernel_order(xdt, a, Bm, Cm, init=None):
    """y (rounded to bf16) and the final state of the bf16 CUDA kernel's
    arithmetic (csrc/ssd.cu), in f32 from bf16-valued x, B, C and f32 a.
    First the state-free parts of every chunk of 64 rows, which the
    kernel's output warps compute apart from the chain: the decays (cum,
    its last value, w = exp(cum_last - cum), exp(cum)), the scores C B^T
    and M = L o C B^T as a bf16 hi + lo pair, and X o w as a pair.  Then
    the state chain, one chunk a step: the state as a pair into
    exp(cum) o (C state^T), plus M X (both pairs summed); then state =
    exp(cum_last) state + (X o w)^T B.  Rows past S act as a = 0 and
    x = B = C = 0."""
    x, a, Bm, Cm = (torch.from_numpy(np.asarray(t, np.float32))
                    for t in (xdt, a, Bm, Cm))
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = 64
    nc = -(-S // Q)
    pad = nc * Q - S
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
    tril = torch.ones(Q, Q, dtype=torch.bool).tril()
    parts = []
    for c in range(nc):
        rows = slice(c * Q, (c + 1) * Q)
        xc, bc, cc = x[:, rows], Bm[:, rows], Cm[:, rows]
        cum = torch.cumsum(a[:, rows], dim=1)                  # (B,Q,H)
        last = cum[:, -1:]
        scores = torch.einsum("bin,bjn->bij", cc, bc)
        L = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,i,j,H)
        M = torch.where(tril[None, :, :, None], L * scores[..., None], 0.0)
        xw = xc * torch.exp(last - cum)[..., None]
        parts.append((xc, bc, cc, torch.exp(cum), torch.exp(last[:, 0]),
                      _split(M), _split(xw)))
    state = (torch.zeros(Bb, H, P, N) if init is None
             else torch.from_numpy(np.asarray(init, np.float32)).clone())
    y = torch.zeros(Bb, nc * Q, H, P)
    for c, (xc, bc, cc, e, dec, (mh, ml), (wh, wl)) in enumerate(parts):
        sh, sl = _split(state)
        off = torch.einsum("bin,bhpn->bihp", cc, sh) \
            + torch.einsum("bin,bhpn->bihp", cc, sl)
        diag = torch.einsum("bijh,bjhp->bihp", mh, xc) \
            + torch.einsum("bijh,bjhp->bihp", ml, xc)
        y[:, c * Q:(c + 1) * Q] = off * e[..., None] + diag
        state = state * dec[:, :, None, None] \
            + torch.einsum("bjhp,bjn->bhpn", wh, bc) \
            + torch.einsum("bjhp,bjn->bhpn", wl, bc)
    return _bf16(y[:, :S]).numpy(), state.numpy()


@pytest.mark.parametrize("S,with_init", [
    (40, True), (100, False), (200, True), (256, True), (384, False),
    (1000, True)])
def test_kernel_order_matches_plain_and_jax(S, with_init):
    """The bf16 CUDA kernel's chunk (64 rows) and order, with each f32
    operand (M, the state, X o w) rounded to a bf16 hi + lo pair, held
    against ``ssd_ref`` and the JAX package's ``ssd_chunked`` on the same
    bf16-valued inputs, by chip_smoke.py's bf16 rule (2e-2 of max |want|).
    S ends inside a chunk (40, 100, 200, 1000), inside a turn of the
    kernel's ring of two state slots (40, 200) or of three input slots
    (100), or at the end of a turn of one (256) or of both (384); with
    and without an initial state.  Decays as in the reference tests,
    a few strongly negative (down to -10)."""
    arrays, init = _inputs(6, 2, S, 3, 64, 32)
    xdt, a, Bm, Cm = arrays
    xdt, Bm, Cm = (_bf16(torch.from_numpy(t)).numpy() for t in (xdt, Bm, Cm))
    a = a.copy()
    a[:, ::37] = -10.0
    init = init if with_init else None
    y, state = _kernel_order(xdt, a, Bm, Cm, init)
    assert np.isfinite(y).all() and np.isfinite(state).all()
    want = ssd_ref(*map(torch.from_numpy, (xdt, a, Bm, Cm)),
                   None if init is None else torch.from_numpy(init))
    jwant = jax_ssd_chunked(*map(jnp.asarray, (xdt, a, Bm, Cm)),
                            init_state=None if init is None
                            else jnp.asarray(init))
    for got, ref in ((y, want[0]), (state, want[1]), (y, jwant[0]),
                     (state, jwant[1])):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, err
