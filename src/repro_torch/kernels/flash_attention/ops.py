"""Public op: flash attention forward, the Hopper kernel or its plain version.

A CPU tensor goes to the plain version (``ref.attention_ref``).  A CUDA
tensor launches the kernel in ``csrc/flash_fwd.cu`` or raises: there is no
fallback.  ``impl="ref"`` asks for the plain version explicitly, for the
tests and for comparing the kernel with it on the card.

When grad is enabled and q, k or v requires it, the forward runs inside
``FlashAttention``, a ``torch.autograd.Function``: the same kernel (or the
plain version) with its log-sum-exp output, and as the backward
``ref.flash_bwd_ref``, plain PyTorch, as the reference's backward
(``repro.models.layers._fa_bwd``) is plain XLA.

The bf16 kernel reads q, k and v through TMA, which needs 16-byte
aligned bases and strides; ``tma_strides`` says whether a tensor meets
that, and ``tma_operands`` hands the kernel a contiguous copy of one that
does not (never the plain version).

The kernel is the operator ``torch.ops.repro_torch.flash_fwd``: its CUDA
implementation launches the kernel, and its fake (also its meta)
implementation gives the outputs' shapes and dtypes, so a meta tensor (the
dry run) reaches the kernel's shape function, never the kernel or the
plain version.  ``work`` is the kernel's work count (FLOPs and bytes),
which the operator's FLOP formula, the dry run and the card's bound read.

``launches`` counts the kernel launches this process made.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build, _sharded
from .ref import attention_ref, flash_bwd_ref

launches = 0

HEAD_DIMS = (16, 32, 64, 80, 128)
# (qk head dim, v head dim) pairs where they differ: DeepSeek-V2's latent
# attention expanded for prefill, qk nope 128 + rope 64, v 128
SPLIT_HEAD_DIMS = ((192, 128),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu",)
_TMA_ALIGN = 16               # bytes, for a tensor map's base and strides
_TMA_MAX_STRIDE = 1 << 40     # bytes


def tma_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """The (B, rows, H) strides, in elements, with which TMA reads the
    4-d ``t`` in place, or None when it cannot: a base address or a stride
    that is not a multiple of 16 bytes, or a zero stride.  A dim of size 1
    is never stepped along, so its stride is replaced by the one a
    contiguous tensor would have there (torch leaves such strides free)."""
    if t.data_ptr() % _TMA_ALIGN:
        return None
    size = t.element_size()
    shape, strides = t.shape, t.stride()
    out = [0, 0, 0]
    inner = shape[3]
    for dim in (2, 1, 0):
        stride = strides[dim] if shape[dim] > 1 else inner
        nbytes = stride * size
        if nbytes <= 0 or nbytes % _TMA_ALIGN or nbytes >= _TMA_MAX_STRIDE:
            return None
        out[dim] = stride
        inner *= shape[dim]
    return tuple(out)


def tma_operands(*ts: torch.Tensor) -> list[tuple[torch.Tensor,
                                                  tuple[int, int, int]]]:
    """Each tensor with the strides the kernel reads it by: the tensor
    itself where TMA can read it in place, else a contiguous copy."""
    out = []
    for t in ts:
        strides = tma_strides(t)
        if strides is None:
            t = t.clone(memory_format=torch.contiguous_format)
            strides = tma_strides(t)
        out.append((t, strides))
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_fwd", _SOURCES)
    fn = lib.flash_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 7 + [i] * 7 + [ll] * 9 + [i] * 3 + [p]
    fn.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def _check(q, k, v, q_pos, k_pos) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B,S,Hq,D), (B,T,Hkv,D), "
                         "(B,T,Hkv,Dv)")
    B, S, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, T, Hkv, D) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if S < 1 or T < 1 or Hkv < 1 or Hq % Hkv or (S + 63) // 64 > 65535 \
            or B * Hq * ((S + 127) // 128) >= 2**31:
        raise ValueError(f"need 1 <= S < 2**22, T >= 1, Hq % Hkv == 0 and "
                         f"fewer than 2**31 (batch, head, 128-row) tiles "
                         f"(B={B}, S={S}, T={T}, Hq={Hq}, Hkv={Hkv})")
    if not (D == Dv and D in HEAD_DIMS) and (D, Dv) not in SPLIT_HEAD_DIMS:
        raise ValueError(f"head dims qk {D}, v {Dv} not supported; kernel "
                         f"takes {HEAD_DIMS} for both or (qk, v) in "
                         f"{SPLIT_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: "
                         f"all must be one of {list(_DTYPES)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim D must be contiguous (stride 1)")
    if min(q.stride() + k.stride() + v.stride()) < 0:
        raise ValueError("negative strides are not supported")
    for name, pos, n in (("q_pos", q_pos, S), ("k_pos", k_pos, T)):
        if pos.dtype != torch.int32 or tuple(pos.shape) != (n,) \
                or pos.stride(0) != 1:
            raise ValueError(f"{name} must be contiguous int32 of shape "
                             f"({n},), got {pos.dtype} {tuple(pos.shape)}")


def _launch(q, k, v, q_pos, k_pos, window: int, causal: bool,
            want_lse: bool = False):
    """The kernel's output, and with ``want_lse`` also its (B,Hq,S) f32
    log-sum-exp."""
    global launches
    _check(q, k, v, q_pos, k_pos)
    B, S, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype == torch.bfloat16:
        (q, sq), (k, sk), (v, sv) = tma_operands(q, k, v)
        # the kernel reads positions 16 bytes at a time
        q_pos, k_pos = (t.clone() if t.data_ptr() % _TMA_ALIGN else t
                        for t in (q_pos, k_pos))
    else:
        sq, sk, sv = (t.stride()[:3] for t in (q, k, v))
    lib = _kernel()
    out = torch.empty((B, S, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(), B, S, T, Hq, Hkv, D, Dv,
            *sq, *sk, *sv, int(window), int(bool(causal)), _DTYPES[q.dtype],
            stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()}")
    launches += 1
    return (out, lse) if want_lse else out


@functools.lru_cache(maxsize=None)
def visible_pairs(S: int, T: int, window: int, causal: bool) -> int:
    """The (query, key) pairs the mask leaves visible, per batch row and
    head, with the causal mask aligned bottom-right (query i at position
    T - S + i, key j at j), as the model builds the positions."""
    if not causal:
        return S * T
    q_pos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(q_pos, T - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(B: int, S: int, T: int, Hq: int, Hkv: int, D: int, *,
         window: int = 0, causal: bool = True, itemsize: int = 2,
         want_lse: bool = False, Dv: int | None = None) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: a QK^T product at head dim D and a PV
    product at v's head dim Dv (D where not given) for every visible pair,
    2 FLOP per multiply-add; q, k, v and both positions read once, the
    output (and the f32 lse) written once."""
    Dv = D if Dv is None else Dv
    flops = 2 * B * Hq * visible_pairs(S, T, window, causal) * (D + Dv)
    nbytes = (B * S * Hq * (D + Dv) + B * T * Hkv * (D + Dv)) * itemsize \
        + 4 * (S + T) + (4 * B * Hq * S if want_lse else 0)
    return flops, nbytes


def op_work(q, k, v, q_pos, k_pos, window, causal, want_lse
            ) -> tuple[int, int]:
    """``work`` of one ``flash_fwd`` call, from its arguments."""
    B, S, Hq, D = q.shape
    return work(B, S, k.shape[1], Hq, k.shape[2], D, window=window,
                causal=causal, itemsize=q.element_size(), want_lse=want_lse,
                Dv=v.shape[3])


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, Tensor q_pos, "
            "Tensor k_pos, int window, bool causal, bool want_lse) "
            "-> (Tensor, Tensor)")


def _flash_cuda(q, k, v, q_pos, k_pos, window, causal, want_lse):
    if want_lse:
        return _launch(q, k, v, q_pos, k_pos, window, causal, True)
    out = _launch(q, k, v, q_pos, k_pos, window, causal)
    return out, out.new_empty((0,), dtype=torch.float32)


_LIB.impl("flash_fwd", _flash_cuda, "CUDA")


@torch.library.register_fake("repro_torch::flash_fwd", lib=_LIB)
def _flash_fake(q, k, v, q_pos, k_pos, window, causal, want_lse):
    B, S, Hq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3] or Hq % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    lse = (B, Hq, S) if want_lse else (0,)
    return (q.new_empty((B, S, Hq, v.shape[3])),
            q.new_empty(lse, dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_fwd, get_raw=True)
def _flash_flops(*args, out_val=None, **kwargs) -> int:
    return op_work(*args, **kwargs)[0]


def _forward(q, k, v, q_pos, k_pos, window: int, causal: bool, impl: str,
             want_lse: bool):
    if impl == "ref" or (impl == "auto" and q.device.type == "cpu"):
        return attention_ref(q, k, v, q_pos, k_pos, window, causal,
                             return_lse=want_lse)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}; expected auto | ref")
    out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, q_pos, k_pos,
                                               window, causal, want_lse)
    return (out, lse) if want_lse else out


class FlashAttention(torch.autograd.Function):
    """The reference's ``_fa`` custom VJP: the forward saves (q, k, v,
    positions, out, lse), the backward recomputes the probabilities block
    by block (``flash_bwd_ref``).  Returns (out, lse); lse carries no
    gradient.  The positions are integers and get none (the reference's
    float0 zeros)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window: int, causal: bool,
                impl: str):
        out, lse = _forward(q, k, v, q_pos, k_pos, window, causal, impl,
                            True)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.window, ctx.causal = window, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_ref(q, k, v, q_pos, k_pos, out, lse, dout,
                                   ctx.window, ctx.causal)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_fwd(q, k, v, q_pos, k_pos, *, window: int = 0,
                        causal: bool = True, impl: str = "auto",
                        return_lse: bool = False):
    """q: (B,S,Hq,D); k: (B,T,Hkv,D); v: (B,T,Hkv,Dv); int32 q_pos (S,),
    k_pos (T,).  Returns (B,S,Hq,Dv) in q's dtype, and with ``return_lse`` also the
    rows' log-sum-exp, f32 (B,Hq,S).  impl: auto | ref.  Differentiable
    (through ``FlashAttention``) when grad is enabled and q, k or v
    requires grad.  DTensors run on each rank's local shards
    (``kernels._sharded.flash``)."""
    window, causal = int(window), bool(causal)
    if _sharded.is_sharded(q, k, v):
        return _sharded.flash(flash_attention_fwd, q, k, v, q_pos, k_pos,
                              window=window, causal=causal, impl=impl,
                              return_lse=return_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, q_pos, k_pos, window,
                                        causal, impl)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, q_pos, k_pos, window, causal, impl, return_lse)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """The Pallas kernel's signature: q (B,S,H,D), k/v (B,T,H,D), causal
    mask aligned bottom-right (q_pos = arange(S) + T - S)."""
    S, T = q.shape[1], k.shape[1]
    q_pos = torch.arange(S, dtype=torch.int32, device=q.device) + (T - S)
    k_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    return flash_attention_fwd(q, k, v, q_pos, k_pos, window=window,
                               causal=causal, impl=impl)
