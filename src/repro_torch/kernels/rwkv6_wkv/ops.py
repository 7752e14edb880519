"""Public op: the RWKV6 WKV recurrence, the Hopper kernel or its plain
version.

A CPU tensor goes to the plain version (``ref.wkv_ref``).  A CUDA tensor
launches the kernel in ``csrc/wkv.cu`` or raises: there is no fallback
(the kernel reads r, k, v and w by TMA, so a view whose base or leading
strides are not multiples of 16 bytes is refused).
``impl="ref"`` asks for the plain version explicitly, for the tests and
for comparing the kernel with it on the card.

The op keeps the Pallas kernel's signature, r, k, v, w (B,S,H,P) and u
(H,P) -> (y (B,S,H,P), final state (B,H,P,P) f32), plus the model's
initial state.  r, k, v and w are read in place through their strides.

Under autograd (``WKV``) the forward is the kernel and the backward the
gradients of the plain version (f64), recomputed from the saved inputs.

The kernel is the operator ``torch.ops.repro_torch.wkv``: its CUDA
implementation launches the kernel, and its fake (also its meta)
implementation gives y's and the final state's shapes and dtypes, so a
meta tensor (the dry run) reaches the kernel's shape function, never the
kernel or the plain version.  ``work`` is the kernel's work count (FLOPs
and bytes), which the operator's FLOP formula, the dry run and the card's
bound read.

``launches`` counts the kernel launches this process made.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build, _sharded
from .._replay import replay_grads
from .ref import CHUNK, wkv_ref

launches = 0

HEAD_DIMS = (16, 32, 64, 128)     # P the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = (Path(__file__).resolve().parent / "csrc" / "wkv.cu",)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("rwkv6_wkv", _SOURCES)
    fn = lib.rwkv6_wkv
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 8 + [i] * 4 + [ll] * 12 + [i, p]
    fn.restype = ctypes.c_int
    lib.rwkv6_wkv_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_wkv_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def tma_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The (B, S, H) strides, in elements, by which the kernel's tensor maps
    read the 4-d ``t`` in place, or None where TMA cannot: a base or a
    stride that is not a multiple of 16 bytes, or a zero stride.  A dim of
    size 1 is never stepped along, so its stride is replaced by the one a
    contiguous tensor would have there."""
    if t.data_ptr() % 16:
        return None
    size = t.element_size()
    out, inner = [0, 0, 0], t.shape[3]
    for dim in (2, 1, 0):
        stride = t.stride(dim) if t.shape[dim] > 1 else inner
        if stride <= 0 or stride * size % 16 or stride * size >= 1 << 40:
            return None
        out[dim] = stride
        inner *= t.shape[dim]
    return out[0], out[1], out[2]


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor,
           init_state: Optional[torch.Tensor]) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError(f"need r, k, v, w (B,S,H,P) and u (H,P), got r "
                         f"{tuple(r.shape)} u {tuple(u.shape)}")
    Bb, S, H, P = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) \
            or tuple(u.shape) != (H, P):
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} w {tuple(w.shape)} u "
                         f"{tuple(u.shape)} do not agree")
    if init_state is not None and tuple(init_state.shape) != (Bb, H, P, P):
        raise ValueError(f"init_state {tuple(init_state.shape)} != "
                         f"{(Bb, H, P, P)}")
    if S < 1 or P not in HEAD_DIMS:
        raise ValueError(f"need S >= 1 and P one of {HEAD_DIMS} (S={S}, "
                         f"P={P})")
    if Bb > 65535 or H > 65535:
        raise ValueError(f"too many rows ({Bb}) or heads ({H}) for the "
                         "launch grid")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes r {r.dtype} k {k.dtype} v {v.dtype}: all "
                         f"one of {list(_DTYPES)}")
    if w.dtype != torch.float32 or u.dtype != torch.float32 or (
            init_state is not None and init_state.dtype != torch.float32):
        raise ValueError("w, u and init_state must be float32")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("the last dim of r, k, v and w must be contiguous")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if tma_strides(t) is None:
            raise ValueError(
                f"{name}: the kernel reads it by TMA, which needs the base "
                f"and the strides of the leading dims in multiples of 16 "
                f"bytes (strides {tuple(t.stride())}, {t.element_size()}"
                "-byte elements)")
    tensors = (r, k, v, w, u) + (() if init_state is None
                                 else (init_state,))
    if r.device.type != "cuda" or any(t.device != r.device
                                      for t in tensors):
        raise ValueError(f"wkv kernel needs every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")


def _launch(r, k, v, w, u, init_state):
    global launches
    _check(r, k, v, w, u, init_state)
    Bb, S, H, P = r.shape
    u = u.contiguous()
    init = None if init_state is None else init_state.contiguous()
    y = torch.empty((Bb, S, H, P), dtype=r.dtype, device=r.device)
    state = torch.empty((Bb, H, P, P), dtype=torch.float32, device=r.device)
    lib = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr(), Bb, S, H, P,
            *tma_strides(r), *tma_strides(k), *tma_strides(v),
            *tma_strides(w), _DTYPES[r.dtype], stream)
    if err == -1:
        raise RuntimeError("rwkv6_wkv: cuTensorMapEncodeTiled refused a "
                           "tensor map of r, k, v or w")
    if err:
        raise RuntimeError("rwkv6_wkv launch failed: "
                           f"{lib.rwkv6_wkv_error_string(err).decode()}")
    launches += 1
    return y, state


def work(B: int, S: int, H: int, P: int, itemsize: int = 2,
         init_state: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one call.  FLOPs are the reference algorithm's at
    the reference model's chunk (``CHUNK``), 2 FLOP per multiply-add: the
    scores r~ k~^T and their product with v (T x T x P each), r~ state and
    the state update (T x P x P each), a chunk.  Bytes: r, k, v and y in
    ``itemsize``, w and u f32, the f32 final state (and initial state)
    each read or written once."""
    T, n = CHUNK, B * S * H * P
    flops = 2 * B * H * -(-S // T) * (2 * T * T * P + 2 * T * P * P)
    nbytes = 4 * n * itemsize + n * 4 + H * P * 4 \
        + B * H * P * P * 4 * (1 + init_state)
    return flops, nbytes


def op_work(r, k, v, w, u, init_state) -> tuple[int, int]:
    """``work`` of one ``wkv`` call, from its arguments."""
    B, S, H, P = r.shape
    return work(B, S, H, P, r.element_size(), init_state is not None)


def _wkv_cuda(r, k, v, w, u, init_state):
    return _launch(r, k, v, w, u, init_state)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("wkv(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
            "Tensor? init_state) -> (Tensor, Tensor)")
_LIB.impl("wkv", _wkv_cuda, "CUDA")


@torch.library.register_fake("repro_torch::wkv", lib=_LIB)
def _wkv_fake(r, k, v, w, u, init_state):
    B, S, H, P = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) \
            or tuple(u.shape) != (H, P):
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} w {tuple(w.shape)} u "
                         f"{tuple(u.shape)} do not agree")
    return (r.new_empty((B, S, H, P)),
            r.new_empty((B, H, P, P), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv, get_raw=True)
def _wkv_flops(*args, out_val=None) -> int:
    return op_work(*args)[0]


def _forward(r, k, v, w, u, init_state, impl: str):
    if impl == "ref" or (impl == "auto" and r.device.type == "cpu"):
        return wkv_ref(r, k, v, w, u, init_state)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}; expected auto | ref")
    return torch.ops.repro_torch.wkv(r, k, v, w, u, init_state)


class WKV(torch.autograd.Function):
    """The recurrence under autograd: the forward is the kernel (or the
    plain version, by ``impl``), returning (y, final state); the backward
    runs ``wkv_ref`` again on the saved inputs, in f64 as its forward
    does, and takes its gradients, for r, k, v, w, u and the initial
    state.  The reference has no wkv backward: it trains through
    ``wkv_chunked`` under ``jax.grad``.  The kernel's y equals the plain
    version's, and the backward reads only the inputs, so the gradients
    do not depend on which forward ran.  An output that got no gradient
    (training drops the final state) arrives as None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init_state, impl: str):
        ctx.save_for_backward(r, k, v, w, u, init_state)
        ctx.set_materialize_grads(False)
        return _forward(r, k, v, w, u, init_state, impl)

    @staticmethod
    def backward(ctx, dy, dstate):
        return replay_grads(wkv_ref, ctx.saved_tensors, ctx.needs_input_grad,
                            (dy, dstate)) + (None,)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, init_state: Optional[torch.Tensor] = None, *,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B,S,H,P) f32 or bf16; w: (B,S,H,P) f32 decays in (0,1);
    u: (H,P) f32 bonus; init_state: (B,H,P,P) f32 ``[k_dim, v_dim]`` or
    None.  Returns (y (B,S,H,P) in r's dtype, final_state (B,H,P,P) f32).
    impl: auto | ref.  Differentiable (through ``WKV``) when grad is
    enabled and an input requires grad.  DTensors run on each rank's local
    shards (``kernels._sharded.wkv``)."""
    if _sharded.is_sharded(r, k, v, w, u, init_state):
        return _sharded.wkv(wkv, r, k, v, w, u, init_state, impl=impl)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, w, u, init_state)):
        return WKV.apply(r, k, v, w, u, init_state, impl)
    return _forward(r, k, v, w, u, init_state, impl)
