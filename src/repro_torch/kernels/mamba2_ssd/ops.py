"""Public op: the Mamba2 chunked SSD scan, the Hopper kernel or its plain
version.

A CPU tensor goes to the plain version (``ref.ssd_ref``).  A CUDA tensor
launches the kernel in ``csrc/ssd.cu`` or raises: there is no fallback.
``impl="ref"`` asks for the plain version explicitly, for the tests and
for comparing the kernel with it on the card.

The op keeps the Pallas kernel's signature, xdt (B,S,H,P), a (B,S,H), B
and C (B,S,N) -> (y (B,S,H,P), final state (B,H,P,N) f32), plus the
model's initial state.  xdt, B and C are read in place through their
strides.

Under autograd (``SSD``) the forward is the kernel and the backward the
gradients of the plain version, recomputed from the saved inputs.

The kernel is the operator ``torch.ops.repro_torch.ssd``: its CUDA
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
from .ref import CHUNK, ssd_ref

launches = 0

STATE_DIMS = (16, 32, 64, 128)     # N the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd.cu",)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("mamba2_ssd", _SOURCES)
    fn = lib.mamba2_ssd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 7 + [i] * 5 + [ll] * 10 + [i, p]
    fn.restype = ctypes.c_int
    lib.mamba2_ssd_error_string.argtypes = [ctypes.c_int]
    lib.mamba2_ssd_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def _check(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, init_state: Optional[torch.Tensor]) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if xdt.dim() != 4 or a.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError(f"need xdt (B,S,H,P), a (B,S,H), B and C (B,S,N), "
                         f"got {tuple(xdt.shape)} {tuple(a.shape)} "
                         f"{tuple(Bm.shape)} {tuple(Cm.shape)}")
    Bb, S, H, P = xdt.shape
    N = Bm.shape[2]
    if tuple(a.shape) != (Bb, S, H) or tuple(Bm.shape) != (Bb, S, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"shapes xdt {tuple(xdt.shape)} a {tuple(a.shape)} "
                         f"B {tuple(Bm.shape)} C {tuple(Cm.shape)} do not "
                         "agree")
    if init_state is not None and tuple(init_state.shape) != (Bb, H, P, N):
        raise ValueError(f"init_state {tuple(init_state.shape)} != "
                         f"{(Bb, H, P, N)}")
    if S < 1 or P < 16 or P % 16 or N not in STATE_DIMS:
        raise ValueError(f"need S >= 1, P a multiple of 16 and N one of "
                         f"{STATE_DIMS} (S={S}, P={P}, N={N})")
    if Bb > 65535 or H > 65535:
        raise ValueError(f"too many rows ({Bb}) or heads ({H}) for the "
                         "launch grid")
    if xdt.dtype not in _DTYPES or Bm.dtype != xdt.dtype \
            or Cm.dtype != xdt.dtype:
        raise ValueError(f"dtypes xdt {xdt.dtype} B {Bm.dtype} C "
                         f"{Cm.dtype}: all one of {list(_DTYPES)}")
    if a.dtype != torch.float32 or (init_state is not None
                                    and init_state.dtype != torch.float32):
        raise ValueError("a and init_state must be float32")
    if xdt.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("the last dim of xdt, B and C must be contiguous")
    if any(s % 8 for s in xdt.stride()[:-1] + Bm.stride()[:-1]
           + Cm.stride()[:-1]) \
            or any(t.data_ptr() % 16 for t in (xdt, Bm, Cm)):
        raise ValueError("strides must be multiples of 8 elements and base "
                         "pointers 16-byte aligned (the bf16 kernel's TMA "
                         "tensor maps take 16-byte strides)")
    tensors = (xdt, a, Bm, Cm) + (() if init_state is None
                                  else (init_state,))
    if xdt.device.type != "cuda" or any(t.device != xdt.device
                                        for t in tensors):
        raise ValueError(f"ssd kernel needs every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")


def _launch(xdt, a, Bm, Cm, init_state):
    global launches
    _check(xdt, a, Bm, Cm, init_state)
    Bb, S, H, P = xdt.shape
    N = Bm.shape[2]
    init = None if init_state is None else init_state.contiguous()
    y = torch.empty((Bb, S, H, P), dtype=xdt.dtype, device=xdt.device)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32,
                        device=xdt.device)
    lib = _kernel()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = lib.mamba2_ssd(
            xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if init is None else init.data_ptr(), y.data_ptr(),
            state.data_ptr(), Bb, S, H, P, N, *xdt.stride()[:3],
            *a.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
            _DTYPES[xdt.dtype], stream)
    if err == -1:
        raise RuntimeError("mamba2_ssd: cuTensorMapEncodeTiled refused a "
                           "tensor map "
                           f"(xdt {tuple(xdt.shape)} strides {xdt.stride()}, "
                           f"B strides {Bm.stride()}, C strides {Cm.stride()})")
    if err:
        raise RuntimeError("mamba2_ssd launch failed: "
                           f"{lib.mamba2_ssd_error_string(err).decode()}")
    launches += 1
    return y, state


def work(B: int, S: int, H: int, P: int, N: int, itemsize: int = 2,
         init_state: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one call.  FLOPs are the reference algorithm's at
    the reference model's chunk (``CHUNK``; the scores C B^T and their
    product with X per head over whole chunks, the states and the
    inter-chunk term), 2 FLOP per multiply-add, whatever the kernel's own
    chunk.  Bytes: xdt and y in ``itemsize``, a f32, B and C (shared by the
    heads), the f32 final state (and initial state) each read or written
    once."""
    flops = 2 * B * H * S * (CHUNK * N + CHUNK * P + 2 * P * N)
    nbytes = 2 * B * S * H * P * itemsize + B * S * H * 4 \
        + 2 * B * S * N * itemsize + B * H * P * N * 4 * (1 + init_state)
    return flops, nbytes


def op_work(xdt, a, Bm, Cm, init_state) -> tuple[int, int]:
    """``work`` of one ``ssd`` call, from its arguments."""
    B, S, H, P = xdt.shape
    return work(B, S, H, P, Bm.shape[2], xdt.element_size(),
                init_state is not None)


def _ssd_cuda(xdt, a, Bm, Cm, init_state):
    return _launch(xdt, a, Bm, Cm, init_state)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd(Tensor xdt, Tensor a, Tensor Bm, Tensor Cm, "
            "Tensor? init_state) -> (Tensor, Tensor)")
_LIB.impl("ssd", _ssd_cuda, "CUDA")


@torch.library.register_fake("repro_torch::ssd", lib=_LIB)
def _ssd_fake(xdt, a, Bm, Cm, init_state):
    B, S, H, P = xdt.shape
    N = Bm.shape[2]
    if tuple(a.shape) != (B, S, H) or tuple(Bm.shape) != (B, S, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"shapes xdt {tuple(xdt.shape)} a {tuple(a.shape)} "
                         f"B {tuple(Bm.shape)} C {tuple(Cm.shape)} do not "
                         "agree")
    return (xdt.new_empty((B, S, H, P)),
            xdt.new_empty((B, H, P, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd, get_raw=True)
def _ssd_flops(*args, out_val=None) -> int:
    return op_work(*args)[0]


def _forward(xdt, a, Bm, Cm, init_state, impl: str):
    if impl == "ref" or (impl == "auto" and xdt.device.type == "cpu"):
        return ssd_ref(xdt, a, Bm, Cm, init_state)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}; expected auto | ref")
    return torch.ops.repro_torch.ssd(xdt, a, Bm, Cm, init_state)


class SSD(torch.autograd.Function):
    """The scan under autograd: the forward is the kernel (or the plain
    version, by ``impl``), returning (y, final state); the backward runs
    ``ssd_ref`` again on the saved inputs and takes its gradients, for
    xdt, a, B, C and the initial state.  The reference has no ssd
    backward: it trains through ``ssd_chunked`` under ``jax.grad``.  An
    output that got no gradient (training drops the final state) arrives
    as None."""

    @staticmethod
    def forward(ctx, xdt, a, Bm, Cm, init_state, impl: str):
        ctx.save_for_backward(xdt, a, Bm, Cm, init_state)
        ctx.set_materialize_grads(False)
        return _forward(xdt, a, Bm, Cm, init_state, impl)

    @staticmethod
    def backward(ctx, dy, dstate):
        return replay_grads(ssd_ref, ctx.saved_tensors, ctx.needs_input_grad,
                            (dy, dstate)) + (None,)


def ssd(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None, *,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt: (B,S,H,P) dt-premultiplied inputs; a: (B,S,H) f32 log decays;
    Bm, Cm: (B,S,N); init_state: (B,H,P,N) f32 or None.  Returns (y
    (B,S,H,P) in xdt's dtype, final_state (B,H,P,N) f32).
    impl: auto | ref.  Differentiable (through ``SSD``) when grad is
    enabled and an input requires grad.  DTensors run on each rank's local
    shards (``kernels._sharded.ssd``)."""
    if _sharded.is_sharded(xdt, a, Bm, Cm, init_state):
        return _sharded.ssd(ssd, xdt, a, Bm, Cm, init_state, impl=impl)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xdt, a, Bm, Cm, init_state)):
        return SSD.apply(xdt, a, Bm, Cm, init_state, impl)
    return _forward(xdt, a, Bm, Cm, init_state, impl)
