"""The port's layers against ``repro.models.layers``, on the CPU in f32.

Same inputs (numpy, seeded) and the reference's own weights (drawn by
``jax.random`` and carried over through numpy) go through both.
Tolerance 1e-5: f32 throughout, only the order of sums and the
transcendental implementations differ between XLA and torch.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import load_numpy_  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("shape", [(2, 7, 4, 16), (2, 7, 2, 2, 16)])
def test_apply_rope_flat_and_grouped_layouts(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.arange(5, 5 + shape[1], dtype=np.int32)
    _close(L.rope_frequencies(16, 1e6), JL.rope_frequencies(16, 1e6))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_mlp():
    rng = np.random.default_rng(2)
    tree = _np_tree(JL.mlp_params(jax.random.key(0), 64, 128, jnp.float32))
    p = load_numpy_(L.MLP(64, 128, device="cpu", dtype=torch.float32), tree)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    _close(L.mlp(p, torch.from_numpy(x)),
           JL.mlp(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))


@pytest.mark.parametrize("cache_pos,S", [(0, 4), (5, 1), (14, 4), (30, 20)])
def test_cache_write_ring(cache_pos, S):
    rng = np.random.default_rng(3)
    Tc = 16
    ck, cv = (rng.standard_normal((2, Tc, 2, 8)).astype(np.float32)
              for _ in range(2))
    k, v = (rng.standard_normal((2, S, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = JL._cache_write({"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                           jnp.asarray(k), jnp.asarray(v), cache_pos)
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    got = L._cache_write(cache, torch.from_numpy(k), torch.from_numpy(v),
                         cache_pos)
    assert got is cache                  # written in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("cache_pos,S", [(0, 1), (0, 4), (5, 1), (14, 4),
                                         (30, 1)])
def test_cache_slot_positions(cache_pos, S):
    got = L._cache_slot_positions(16, cache_pos, S)
    want = JL._cache_slot_positions(16, cache_pos, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _attn_setup(qk_norm):
    tree = _np_tree(JL.attention_params(jax.random.key(1), 64, 4, 2, 16,
                                        qk_norm, jnp.float32))
    p = load_numpy_(L.Attention(64, 4, 2, 16, qk_norm, device="cpu",
                                dtype=torch.float32), tree)
    return p, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("window,Tc", [(0, 32), (16, 16)])
def test_multihead_attention_prefill_then_decode(qk_norm, window, Tc):
    """Prefill writes the ring (wrapping when the window is shorter than
    the prompt); two decode steps then attend over it."""
    rng = np.random.default_rng(4)
    p, jp = _attn_setup(qk_norm)
    kw = dict(n_heads=4, n_kv=2, d_head=16, qk_norm=qk_norm, rope_theta=1e6,
              window=window)
    B, S = 2, 24
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    zeros = np.zeros((B, Tc, 2, 16), np.float32)
    jcache = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
    cache = {"k": torch.from_numpy(zeros.copy()),
             "v": torch.from_numpy(zeros.copy())}

    pos = np.arange(S, dtype=np.int32)
    want, jcache = JL.multihead_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                          None, jcache, 0, **kw)
    got, cache = L.multihead_attention(p, torch.from_numpy(x),
                                       torch.from_numpy(pos), cache, 0, **kw)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])

    for t in range(2):
        xt = rng.standard_normal((B, 1, 64)).astype(np.float32)
        pos = np.array([S + t], np.int32)
        want, jcache = JL.multihead_attention(
            jp, jnp.asarray(xt), jnp.asarray(pos), None, jcache, S + t,
            decode=True, **kw)
        got, cache = L.multihead_attention(
            p, torch.from_numpy(xt), torch.from_numpy(pos), cache, S + t,
            decode=True, **kw)
        _close(got, want)
        for name in ("k", "v"):
            _close(cache[name], jcache[name])
