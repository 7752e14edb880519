"""The port's grouped expert matmul against the JAX reference, on the CPU.

On the CPU the wrapper runs the plain version; it is held against
``repro.kernels.moe_gmm.ref.gmm_ref`` (the Pallas kernel's oracle) and
against the Pallas ``gmm`` itself in interpret mode, over the reference
kernel tests' sweep.  The CUDA kernel is compared with the plain version
on the card by tests/test_torch_gmm_card.py and by chip_smoke.py.

Tolerances, normalised by max |want| as in tests/test_kernels.py: f32
1e-5 (summation order), bf16 2e-2 (one bf16 rounding of the output).
"""

import contextlib
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.moe_gmm.ops import grouped_matmul as jax_gmm  # noqa: E402
from repro.kernels.moe_gmm.ref import gmm_ref as jax_oracle  # noqa: E402
from repro_torch.kernels.moe_gmm import ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, x_shape, w_shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.05).astype(np.float32)
    return x, w


def _close_normalised(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("E,C,D,F", [(4, 128, 256, 128), (2, 256, 512, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_sweep_matches_jax_oracle_and_pallas(E, C, D, F, dtype):
    x, w = _inputs(0, (E, C, D), (E, D, F))
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    before = ops.launches
    got = ops.grouped_matmul(tx, tw)
    assert ops.launches == before   # a CPU tensor never launches
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, F)
    got = got.float().numpy()
    _close_normalised(got, jax_oracle(jx, jw), TOL[dtype])
    _close_normalised(got, jax_gmm(jx, jw, impl="interpret"), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_takes_the_models_expert_buffers(dtype):
    """(B,E,C,D) in, (B,E,C,F) out: each batch row is the (E,C,D) product
    (the reference model's einsum ``becd,edf->becf``), at a ragged C."""
    B, E, C, D, F = 3, 4, 24, 64, 40
    x, w = _inputs(1, (B, E, C, D), (E, D, F))
    dt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt)
    got = ops.grouped_matmul(tx, tw)
    assert tuple(got.shape) == (B, E, C, F) and got.dtype == dt
    for b in range(B):
        assert torch.equal(got[b], gmm_ref(tx[b], tw))
    want = jnp.einsum("becd,edf->becf", jnp.asarray(x, jnp.float32),
                      jnp.asarray(np.asarray(tw.float()), jnp.float32))
    _close_normalised(got.float().numpy(), want, TOL[dtype])


def test_impl_ref_and_unknown_impl():
    x, w = _inputs(2, (2, 8, 16), (2, 16, 8))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(ops.grouped_matmul(tx, tw, impl="ref"),
                       gmm_ref(tx, tw))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.grouped_matmul(tx, tw, impl="pallas")


@pytest.mark.parametrize("case,match", [
    ("w rank", "need x"),
    ("E mismatch", "do not agree"),
    ("D not multiple of 8", "multiples of 8"),
    ("dtype", "dtypes"),
    ("D strided", "contiguous"),
    ("odd row stride", "strides must be multiples of 8"),
    ("cpu", "CUDA"),
])
def test_kernel_checks_raise_on_what_it_does_not_take(case, match):
    """What the wrapper refuses before any launch (the checks run on CPU
    tensors here; the last one is the device check)."""
    f32 = torch.float32
    x, w = torch.zeros(2, 8, 16), torch.zeros(2, 16, 8)
    if case == "w rank":
        w = torch.zeros(16, 8)
    elif case == "E mismatch":
        w = torch.zeros(3, 16, 8)
    elif case == "D not multiple of 8":
        x, w = torch.zeros(2, 8, 12), torch.zeros(2, 12, 8)
    elif case == "dtype":
        w = w.to(torch.bfloat16)
    elif case == "D strided":
        x = torch.zeros(2, 16, 8, dtype=f32).transpose(1, 2)
    elif case == "odd row stride":
        x = torch.zeros(2, 8, 20)[..., :16]
    with pytest.raises(ValueError, match=match):
        ops._check(x, w)


@pytest.mark.parametrize("B,C,want", [
    (3, 8, "narrow"),      # granite's decode: 24 rows an expert
    (3, 320, "wide"),      # granite's prefill: 960 rows
    (1, 64, "narrow"),     # the first design's limit
    (8, 8, "narrow"),
    (2, 28, "narrow"),     # C padded to 32 a batch row: 64 rows
    (1, 72, "narrow"),     # past it: the cluster design
    (3, 24, "narrow"),
    (3, 20, "narrow"),     # padded to 24 a batch row: 72 rows
    (32, 8, "narrow"),     # mixtral's decode at 32 slots: 256 rows
    (1, 256, "narrow"),    # 256 rows: the narrow kernel's limit
    (33, 8, "wide"),       # 264 rows: one group past it
    (1, 264, "wide"),
    (2, 124, "narrow"),    # C padded to 128 a batch row: 256 rows
    (3, 84, "wide"),       # padded to 88 a batch row: 264 rows
    (32, 160, "wide"),     # mixtral's chat prefill: 5,120 rows
])
def test_bf16_kernel_choice_follows_the_rows_an_expert_holds(B, C, want):
    """bf16 picks the narrow kernel up to NARROW_MAX_ROWS (256) rows (each
    batch row's C padded to 8, the narrow kernel's N), the wide one past
    it; f32 always has its own kernel."""
    assert ops.narrow_rows(B, C) == B * -(-C // 8) * 8
    assert ops.choose_kernel(torch.bfloat16, B, C) == want
    assert (ops.narrow_rows(B, C) <= ops.NARROW_MAX_ROWS) == \
        (want == "narrow")
    assert ops.choose_kernel(torch.float32, B, C) == "f32"


class _StubLibrary:
    """The kernel library's C entry points, recording each launch's
    arguments and accepting it, so that the wrapper's own accounting runs
    on the CPU."""

    def __init__(self):
        self.launched = []

    def moe_gmm(self, *args):
        self.launched.append(args)
        return 0

    def moe_gmm_encode_weights(self, *args):
        return 0


@pytest.mark.parametrize("B,C,dtype,kernel", [
    (32, 8, torch.bfloat16, "narrow"),
    (3, 8, torch.bfloat16, "narrow"),
    (33, 8, torch.bfloat16, "wide"),
    (2, 8, torch.float32, "f32"),
])
def test_launches_by_kernel_counts_what_the_library_was_handed(
        monkeypatch, B, C, dtype, kernel):
    """Each launch counts once in ``launches`` and once under the kernel
    ``choose_kernel`` named, which is the kernel id the library gets."""
    lib = _StubLibrary()
    monkeypatch.setattr(ops, "_kernel", lambda: lib)
    monkeypatch.setattr(ops, "_check", lambda x, w: None)
    monkeypatch.setattr(ops, "_maps", type(ops._maps)())
    monkeypatch.setattr(ops, "launches", 0)
    monkeypatch.setattr(ops, "launches_by_kernel", {})
    monkeypatch.setattr(ops, "last_kernel", None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros((B, 2, C, 64), dtype=dtype)
    w = torch.zeros((2, 64, 32), dtype=dtype)
    for n in (1, 2):
        out = ops._launch(x, w)
        assert tuple(out.shape) == (B, 2, C, 32)
        assert ops.launches == n and ops.last_kernel == kernel
        assert ops.launches_by_kernel == {kernel: n}
        args = lib.launched[-1]
        assert args[3:6] == (B, 2, C)
        assert args[-3] == ops._KERNEL_IDS[kernel]
        assert (args[-2] is None) == (kernel == "f32")


@pytest.mark.parametrize("shape,strides,want", [
    ((3, 32, 8, 1024), (262144, 8192, 1024, 1), (262144, 8192, 1024)),
    # a strided view: strides kept as they are
    ((3, 4, 40, 128), (34560, 6912, 144, 1), (34560, 6912, 144)),
    # a dim of size 1: its free stride replaced by the contiguous one
    ((1, 4, 8, 64), (7, 512, 64, 1), (2048, 512, 64)),
    ((32, 1024, 512), (0, 512, 1), None),       # broadcast: zero stride
    ((2, 8, 16), (128, 12, 1), None),            # 24 bytes: not 16-aligned
])
def test_tma_strides(shape, strides, want):
    assert ops.tma_strides(shape, strides) == want


def test_weight_map_key_holds_what_the_map_is_made_from():
    """The cached map of w is keyed by its address, dims, strides and box,
    and by nothing else: views with other values get other keys, the same
    values the same key."""
    w = torch.zeros(4, 64, 32, dtype=torch.bfloat16)
    key = ops.weight_map_key(w)
    assert key == (w.data_ptr(), 4, 64, 32, 2048, 32, ops.TILE_K, 64)
    assert ops.weight_map_key(w.view(4, 64, 32)) == key
    for other in (w[1:], w[:, :56], w[:, :, :24], w[:, ::2]):
        assert ops.weight_map_key(other) != key
