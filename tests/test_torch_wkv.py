"""The port's WKV recurrence against the JAX reference, on the CPU.

On the CPU the wrapper runs the plain version; it is held against the
reference model's ``repro.models.rwkv6.wkv_chunked`` and against the
Pallas ``wkv_fwd`` in interpret mode, over the reference kernel tests'
sweep (tests/test_kernels.py), and against ``wkv_chunked`` with an
initial state (the Pallas kernel starts from zeros).  At a ragged S the
reference falls back to one chunk of the whole sequence, whose decay
factors leave f32's range for long S; the port pads to whole chunks, so
ragged cases are held against a token-by-token recurrence in f64.  The
CUDA kernel is compared with the plain version on the card by
tests/test_torch_wkv_card.py and by chip_smoke.py.

Tolerance: 5e-3 atol = rtol, as in tests/test_kernels.py.  (The plain
version sums in f64 where the reference sums in f32; the difference is
the reference's rounding, far inside the tolerance.)
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.rwkv6_wkv.ops import wkv as jax_wkv  # noqa: E402
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref  # noqa: E402

TOL = 5e-3
# (B, S, H, P, chunk) of the reference kernel tests' wkv sweep
SWEEP = [(2, 64, 2, 32, 16), (1, 128, 4, 64, 16), (2, 32, 2, 16, 8)]


def _inputs(seed, B, S, H, P, rate=None, u_scale=0.1):
    """The reference tests' laws: r, k, v N(0, 1), w = exp(-exp(N(0, .25)
    - 2)), u N(0, .01); or, with ``rate``, per-step decay rates
    log-normal around that mean; an initial state N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    z = rng.standard_normal((B, S, H, P))
    if rate is None:
        w = np.exp(-np.exp(z * 0.5 - 2))
    else:
        w = np.exp(-np.minimum(rate * np.exp(0.5 * z - 0.125), 5.0))
    u = rng.standard_normal((H, P)) * u_scale
    init = rng.standard_normal((B, H, P, P)).astype(np.float32)
    return (r, k, v, w.astype(np.float32), u.astype(np.float32)), init


def _recurrence(r, k, v, w, u, init=None):
    """S_t = diag(w_t) S_{t-1} + k_t^T v_t, y_t = r_t (diag(u) k_t^T v_t
    + S_{t-1}), token by token in f64."""
    r, k, v, w, u = (np.asarray(t, np.float64) for t in (r, k, v, w, u))
    B, S, H, P = r.shape
    state = (np.zeros((B, H, P, P)) if init is None
             else np.asarray(init, np.float64))
    y = np.zeros((B, S, H, P))
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = np.einsum("bhp,bhpq->bhq", r[:, t] * u, kv) \
            + np.einsum("bhp,bhpq->bhq", r[:, t], state)
        state = state * w[:, t, :, :, None] + kv
    return y, state


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _port(arrays, init=None):
    before = ops.launches
    y, state = ops.wkv(*map(torch.from_numpy, arrays),
                       None if init is None else torch.from_numpy(init))
    assert ops.launches == before   # a CPU tensor never launches
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    return y.numpy(), state.numpy()


@pytest.mark.parametrize("B,S,H,P,chunk", SWEEP)
def test_wkv_sweep_matches_jax_wkv_chunked_and_pallas(B, S, H, P, chunk):
    arrays, _ = _inputs(0, B, S, H, P)
    y, state = _port(arrays)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, P)
    jarrays = [jnp.asarray(t) for t in arrays]
    want_y, want_state = jax_wkv_chunked(*jarrays)
    _close(y, want_y)
    _close(state, want_state)
    pallas_y, pallas_state = jax_wkv(*jarrays, chunk=chunk,
                                     impl="interpret")
    _close(y, pallas_y)
    _close(state, pallas_state)


@pytest.mark.parametrize("B,S,H,P,chunk", SWEEP)
def test_wkv_with_init_state_and_bonus_matches_jax(B, S, H, P, chunk):
    """An initial state (read as [k_dim, v_dim]: a transposed read would
    move y) and a bonus u of N(0, .25)."""
    arrays, init = _inputs(1, B, S, H, P, u_scale=0.5)
    y, state = _port(arrays, init)
    want_y, want_state = jax_wkv_chunked(
        *[jnp.asarray(t) for t in arrays], init_state=jnp.asarray(init))
    _close(y, want_y)
    _close(state, want_state)
    # the state's layout matters: the transposed state gives another y
    y_t, _ = _port(arrays, np.ascontiguousarray(init.transpose(0, 1, 3, 2)))
    assert np.abs(y_t - y).max() > 1.0


@pytest.mark.parametrize("S,rate", [(12, 0.2), (100, 0.2), (1000, 0.05),
                                    (1000, 0.2), (1008, 0.2)])
@pytest.mark.parametrize("with_init", [False, True])
def test_wkv_ragged_and_long_match_token_recurrence(S, rate, with_init):
    """B1 H2 P16, per-step decay rates log-normal around ``rate``: the
    padded chunks agree with the f64 recurrence wherever the reference's
    one-chunk fallback holds and where it does not (S = 1000, rate 0.2)."""
    arrays, init = _inputs(2, 1, S, 2, 16, rate=rate)
    init = init if with_init else None
    y, state = _port(arrays, init)
    want_y, want_state = _recurrence(*arrays, init)
    assert np.isfinite(y).all() and np.isfinite(state).all()
    _close(y, want_y)
    _close(state, want_state)


@pytest.mark.parametrize("S,rate,breaks", [
    (1008, 0.05, False), (1008, 0.2, False), (1000, 0.05, False),
    (1000, 0.2, True), (100, 0.2, False)])
def test_reference_fallback_breaks_only_at_long_ragged_s(S, rate, breaks):
    """Why the port pads a ragged S: the reference's ``wkv_chunked`` takes
    one chunk of the whole sequence there, and at S = 1000 with a mean
    decay rate of 0.2 its 1/prod(w) factors leave f32's range: y is all
    error and the final state NaN.  In chunks of 16, or with milder
    decays or a short S, it holds the recurrence; the port holds it on
    every row (test above)."""
    arrays, _ = _inputs(2, 1, S, 2, 16, rate=rate)
    y, state = (np.asarray(t) for t in jax_wkv_chunked(
        *[jnp.asarray(t) for t in arrays]))
    want_y, want_state = _recurrence(*arrays)
    err = np.abs(y - want_y).max()
    if breaks:
        assert np.isnan(state).any() and err > 10.0
    else:
        assert np.isfinite(state).all()
        _close(y, want_y)
        _close(state, want_state)


def test_wkv_keeps_bf16_inputs_dtype():
    """bf16 r, k, v and f32 w: y comes back in bf16, the state in f32.  y
    is held against the reference's f32 y: its one rounding to bf16 is at
    most half an ulp (2^-8 relative), inside the tolerance."""
    arrays, init = _inputs(3, 1, 100, 2, 16)
    r, k, v, w, u = map(torch.from_numpy, arrays)
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    y, state = ops.wkv(r, k, v, w, u, torch.from_numpy(init))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want_y, want_state = jax_wkv_chunked(
        *[jnp.asarray(np.asarray(t.float()), dt) for t, dt in
          ((r, jnp.bfloat16), (k, jnp.bfloat16), (v, jnp.bfloat16),
           (w, jnp.float32), (u, jnp.float32))],
        init_state=jnp.asarray(init))
    assert want_y.dtype == jnp.float32
    _close(y.float().numpy(), want_y)
    _close(state, want_state)


def test_impl_ref_and_unknown_impl():
    arrays, init = _inputs(4, 1, 40, 2, 16)
    t = [torch.from_numpy(x) for x in arrays]
    got = ops.wkv(*t, torch.from_numpy(init), impl="ref")
    want = wkv_ref(*t, torch.from_numpy(init))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.wkv(*t, impl="pallas")


@pytest.mark.parametrize("case,match", [
    ("rank", "need r"),
    ("k shape", "do not agree"),
    ("u shape", "do not agree"),
    ("init shape", "init_state"),
    ("P unsupported", "P one of"),
    ("dtype", "dtypes"),
    ("w dtype", "float32"),
    ("u dtype", "float32"),
    ("P strided", "contiguous"),
    ("stride not 16 bytes", "16 bytes"),
    ("cpu", "CUDA"),
])
def test_kernel_checks_raise_on_what_it_does_not_take(case, match):
    """What the wrapper refuses before any launch (the checks run on CPU
    tensors here; the last one is the device check)."""
    B, S, H, P = 2, 10, 3, 16
    r, k, v, w = (torch.zeros(B, S, H, P) for _ in range(4))
    u, init = torch.zeros(H, P), None
    if case == "rank":
        r = torch.zeros(B, S, H * P)
    elif case == "k shape":
        k = torch.zeros(B, S, H + 1, P)
    elif case == "u shape":
        u = torch.zeros(P, H)
    elif case == "init shape":
        init = torch.zeros(B, H, P, P + 1)
    elif case == "P unsupported":
        r, k, v, w = (torch.zeros(B, S, H, 24) for _ in range(4))
        u = torch.zeros(H, 24)
    elif case == "dtype":
        v = v.to(torch.bfloat16)
    elif case == "w dtype":
        w = w.to(torch.bfloat16)
    elif case == "u dtype":
        u = u.to(torch.bfloat16)
    elif case == "P strided":
        k = torch.zeros(B, S, P, H).transpose(2, 3)
    elif case == "stride not 16 bytes":
        v = torch.zeros(B, S, H * P + 1)[..., 1:].unflatten(-1, (H, P))
    with pytest.raises(ValueError, match=match):
        ops._check(r, k, v, w, u, init)


def _kernel_order(r, k, v, w, u, init):
    """y and the final state in f64 in the CUDA kernel's order
    (csrc/wkv.cu).  First the state-free parts of every chunk of 16 rows,
    which the kernel's producer warps compute ahead of the chain: the
    decays as running products over each half of 8 rows, the second half
    scaled by the first's product; 1 / incl of a row as the reciprocal of
    its half's last incl times the decays after the row (a reciprocal of
    each row where that last incl is below 1e-37); the masked scores
    r~ k~^T summed over p in four interleaved partial sums of 4-term
    steps; the bonus r u k summed over each 16 columns, then over the
    groups.  Then the state chain, one chunk a step: y as two partial
    sums, over alternate 8-row tiles of the state (r~ state) and alternate
    4-row slices of the chunk (scores v); the state grown by k~^T v four
    rows at a time, then scaled by the chunk's last incl."""
    r, k, v, w, u = (np.asarray(t, np.float64) for t in (r, k, v, w, u))
    B, S, H, P = r.shape
    T, half = 16, 8
    nc = -(-S // T)
    pad = ((0, 0), (0, nc * T - S), (0, 0), (0, 0))
    r, k, v = (np.pad(t, pad) for t in (r, k, v))
    w = np.pad(w, pad, constant_values=1.0)
    # k-step (n, e) of a product over p takes p = 8 n + 2 tig + e
    steps = [[8 * n + 2 * tig + e for tig in range(4)]
             for n in range(P // 8) for e in range(2)]
    mask = np.tril(np.ones((T, T), bool), -1)
    parts = []
    for c in range(nc):
        rows = slice(c * T, (c + 1) * T)
        rc, kc, vc = r[:, rows], k[:, rows], v[:, rows]
        wc = np.maximum(w[:, rows], 1e-8)
        pre = np.concatenate([np.cumprod(wc[:, :half], axis=1),
                              np.cumprod(wc[:, half:], axis=1)], axis=1)
        base = np.ones_like(pre)
        base[:, half:] = pre[:, half - 1:half]
        excl = base * np.concatenate([np.ones_like(pre[:, :1]), pre[:, :-1]],
                                     axis=1)
        excl[:, half] = base[:, half]
        inv = np.empty_like(pre)
        for h0 in (0, half):
            last = base[:, h0] * pre[:, h0 + half - 1]
            x = 1.0 / np.maximum(last, 1e-37)
            for s in range(h0 + half - 1, h0 - 1, -1):
                each = 1.0 / np.maximum(base[:, s] * pre[:, s], 1e-37)
                inv[:, s] = np.where(last >= 1e-37, x, each)
                x = x * wc[:, s]
        rt, kt = rc * excl, kc * inv
        acc = np.zeros((4, B, H, T, T))
        for i, ps in enumerate(steps):
            acc[i % 4] += np.einsum("bihp,bjhp->bhij", rt[..., ps],
                                    kt[..., ps])
        scores = np.where(mask, (acc[0] + acc[1]) + (acc[2] + acc[3]), 0.0)
        ruk = rc * u * kc
        bonus = np.zeros((B, T, H))
        for g in range(0, P, 16):
            bonus = bonus + ruk[..., g:g + 16].sum(-1)
        scores = scores + np.einsum("bih,ij->bhij", bonus, np.eye(T))
        parts.append((rt, kt, vc, scores, base[:, -1] * pre[:, -1]))
    state = (np.zeros((B, H, P, P)) if init is None
             else np.asarray(init, np.float64).copy())
    y = np.zeros((B, nc * T, H, P))
    for c, (rt, kt, vc, scores, last) in enumerate(parts):
        acc = np.zeros((2, B, T, H, P))
        for i, ps in enumerate(steps):
            acc[(i // 2) % 2] += np.einsum("bihp,bhpq->bihq", rt[..., ps],
                                           state[:, :, ps])
        for j in range(4):
            js = slice(4 * j, 4 * j + 4)
            acc[j % 2] += np.einsum("bhij,bjhq->bihq", scores[..., js],
                                    vc[:, js])
            state = state + np.einsum("bthp,bthq->bhpq", kt[:, js],
                                      vc[:, js])
        y[:, c * T:(c + 1) * T] = acc[0] + acc[1]
        state = state * last[..., None]
    return y[:, :S], state


@pytest.mark.parametrize("S,rate,with_init", [
    (40, 0.2, True), (48, 5.0, False), (200, 1.6, True), (256, 5.0, True),
    (250, 0.05, True)])
def test_kernel_order_rounds_like_plain_version(S, rate, with_init):
    """The CUDA kernel sums in f64 in another order than ``wkv_ref``; both
    round y and the state once.  Two such f64 sums should round to the
    same f32 and bf16 values all but everywhere: the share of equal
    entries is held to 0.9999, as the card test holds the kernel.  Decay
    rates log-normal around ``rate`` and capped at 5 (rate 5: about half
    at the cap), S ending inside a chunk (40, 200, 250), at a chunk's end
    inside a turn of the kernel's ring of two chunks (48) or at a turn's
    end (256), with and without an initial state."""
    arrays, init = _inputs(5, 2, S, 2, 32, rate=rate, u_scale=0.5)
    init = init if with_init else None
    y, state = _kernel_order(*arrays, init)
    assert np.isfinite(y).all() and np.isfinite(state).all()
    want_y, want_state = wkv_ref(*map(torch.from_numpy, arrays),
                                 None if init is None
                                 else torch.from_numpy(init))
    got_y = torch.from_numpy(y).float()
    for dt in (torch.float32, torch.bfloat16):
        same = (got_y.to(dt) == want_y.to(dt)).float().mean().item()
        assert same >= 0.9999, (dt, same)
    same = (torch.from_numpy(state).float() == want_state).float().mean()
    assert same.item() >= 0.9999
    _close(y, want_y.numpy())
