"""The port's flash attention against the JAX reference, on the CPU.

On the CPU the wrapper runs the plain version; it is held against
``repro.kernels.flash_attention.ref.attention_ref`` (the Pallas kernel's
oracle) over the reference kernel tests' sweep, and against the
reference model's attention (``_plain_attention`` and the XLA flash path)
for GQA and ring-buffer positions.  The CUDA kernel itself is compared
with the plain version on the card by tests/test_torch_flash_card.py
(which does not need JAX) and by chip_smoke.py.

Tolerances: f32 5e-5 (summation order and exp differ between XLA and
torch), bf16 2e-2 (one bf16 rounding of the output), as in
tests/test_kernels.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jax_oracle  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

TOL = {"float32": 5e-5, "bfloat16": 2e-2}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,T,H,D", [
    (2, 512, 512, 4, 64),
    (1, 1024, 1024, 2, 128),
    (2, 256, 1024, 4, 64),
    (1, 512, 512, 3, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_flash_sweep_matches_jax_oracle(B, S, T, H, D, dtype, causal,
                                        window):
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, s) for s in ((B, S, H, D), (B, T, H, D),
                                         (B, T, H, D)))
    want = jax_oracle(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                      causal=causal, window=window)
    before = ops.launches
    got = ops.flash_attention(*(_to_torch(a, dtype) for a in (q, k, v)),
                              causal=causal, window=window)
    assert ops.launches == before   # a CPU tensor never launches
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _ring_positions(rng, T, n_unwritten):
    """Shuffled slot positions with some slots never written (-1)."""
    k_pos = rng.permutation(T).astype(np.int32)
    k_pos[rng.choice(T, n_unwritten, replace=False)] = -1
    return k_pos


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("ring", [False, True])
def test_gqa_and_ring_positions_match_model_attention(window, ring):
    """GQA without repeating KV (head h reads kv head h // G) and
    non-monotone positions with -1 slots, against the reference model's
    plain attention (which repeats KV) and its XLA flash path."""
    rng = np.random.default_rng(1)
    B, S, T, Hq, Hkv, D = 2, 48, 80, 8, 2, 64
    q = _normal(rng, (B, S, Hq, D))
    k, v = _normal(rng, (B, T, Hkv, D)), _normal(rng, (B, T, Hkv, D))
    q_pos = np.arange(T - S, T, dtype=np.int32)
    k_pos = (_ring_positions(rng, T, 10) if ring
             else np.arange(T, dtype=np.int32))
    G = Hq // Hkv
    kr, vr = (jnp.repeat(jnp.asarray(a), G, axis=2) for a in (k, v))
    args = (jnp.asarray(q), kr, vr, jnp.asarray(q_pos), jnp.asarray(k_pos))
    plain = np.asarray(JL._plain_attention(*args, window, True))
    xla_flash = np.asarray(JL.flash_attention(*args, window, True))
    got = ops.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(k_pos), window=window)
    for want in (plain, xla_flash):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


def test_attention_ref_is_explicit_and_other_impls_raise():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 8, 2, 64)))
               for _ in range(3))
    pos = torch.arange(8, dtype=torch.int32)
    auto = ops.flash_attention_fwd(q, k, v, pos, pos)
    ref = ops.flash_attention_fwd(q, k, v, pos, pos, impl="ref")
    torch.testing.assert_close(auto, attention_ref(q, k, v, pos, pos))
    torch.testing.assert_close(ref, auto)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention_fwd(q, k, v, pos, pos, impl="cuda")


def test_non_cpu_tensor_never_falls_back_to_plain(monkeypatch):
    """A tensor off the CPU goes to the kernel's operator, never the plain
    version: a meta tensor reaches the operator's shape function (no
    build, no launch), and the kernel itself refuses anything but CUDA
    tensors."""
    before = ops.launches

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ops, "attention_ref", plain)
    q = torch.empty((1, 8, 2, 64), device="meta")
    pos = torch.empty((8,), dtype=torch.int32, device="meta")
    out, lse = ops.flash_attention_fwd(q, q, q, pos, pos, return_lse=True)
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape,
                                                       q.dtype)
    assert (lse.shape, lse.dtype) == ((1, 2, 8), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ops._launch(q, q, q, pos, pos, 0, True)
    assert ops.launches == before


def _view(shape, strides, offset=0, dtype=torch.bfloat16):
    base = torch.zeros(offset + sum((n - 1) * s for n, s in
                                    zip(shape, strides)) + 1, dtype=dtype)
    return base.as_strided(shape, strides, offset)


@pytest.mark.parametrize("name,shape,strides,offset,want", [
    # contiguous (B,S,H,D)
    ("contiguous", (2, 10, 4, 64), (2560, 256, 64, 1), 0, (2560, 256, 64)),
    # q, k, v as head slices of one fused projection: read in place
    ("fused qkv view", (2, 10, 4, 64), (7680, 768, 64, 1), 256,
     (7680, 768, 64)),
    # size-1 dims may carry any stride; they are never stepped along
    ("size-1 dims", (1, 10, 1, 80), (3, 80, 7, 1), 0, (800, 80, 80)),
    # a row start 2 bytes off 16: the pad=1 view of the card test
    ("unaligned base", (1, 10, 4, 64), (7681, 769, 64, 1), 1, None),
    # head stride of 40 bytes: D sliced out of wider rows
    ("stride not a multiple of 16 bytes", (1, 10, 3, 16), (600, 60, 20, 1),
     0, None),
    # a batch broadcast by expand
    ("zero stride", (2, 10, 4, 64), (0, 256, 64, 1), 0, None),
])
def test_tma_strides_say_what_tma_reads_in_place(name, shape, strides,
                                                  offset, want):
    """The bf16 kernel reads q, k and v through TMA tensor maps, which need
    16-byte aligned bases and strides: ``tma_strides`` gives the (B, rows,
    H) strides the maps use, or None where the wrapper must copy."""
    t = _view(shape, strides, offset)
    assert t.data_ptr() % 16 == (offset * 2) % 16
    assert ops.tma_strides(t) == want, name


@pytest.mark.parametrize("pad", [0, 1])
def test_tma_operands_copy_only_what_tma_cannot_read(pad):
    """An aligned view goes to the kernel as it is; an unaligned one as a
    contiguous copy with the same values, never to the plain version."""
    rng = np.random.default_rng(3)
    S, H, D = 12, 4, 64
    fused = torch.from_numpy(_normal(rng, (2, S, 3 * H * D + 8))).to(
        torch.bfloat16)[..., pad:pad + 3 * H * D].reshape(2, S, 3 * H, D)
    q, k, v = fused[:, :, :H], fused[:, :, H:2 * H], fused[:, :, 2 * H:]
    out = ops.tma_operands(q, k, v)
    for t, (got, strides) in zip((q, k, v), out):
        torch.testing.assert_close(got, t, atol=0, rtol=0)
        if pad == 0:
            assert got is t and strides == t.stride()[:3]
        else:
            assert got is not t and got.is_contiguous()
            assert got.data_ptr() % 16 == 0
            assert strides == (S * H * D, H * D, D)
