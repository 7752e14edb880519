"""Public op: grouped expert matmul, the Hopper kernels or their plain version.

A CPU tensor goes to the plain version (``ref.gmm_ref``).  A CUDA tensor
launches a kernel in ``csrc/gmm.cu`` or raises: there is no fallback.
``impl="ref"`` asks for the plain version explicitly, for the tests and
for comparing the kernels with it on the card.

The op keeps the Pallas kernel's signature, x (E,C,D) x w (E,D,F) ->
(E,C,F), and also takes the model's expert buffers x (B,E,C,D) in place,
through their strides, giving (B,E,C,F): no copy folds B into C.

bf16 has two kernels, picked by ``choose_kernel`` from the rows an expert
holds: ``wide`` (a persistent wgmma GEMM fed by TMA, for prefill) and
``narrow`` (the weights as wgmma's 64-row side and up to 256 rows as its
N, for decode and short prompts).  Both read x and w through TMA tensor
maps, which ``cuTensorMapEncodeTiled`` encodes; a map it refuses
raises.
The weights' map is cached keyed by exactly what it is made from
(``weight_map_key``), so a hit is always right.  f32 has one kernel on
the CUDA cores.

Under autograd (``GroupedMatmul``) the forward is the kernel and the
backward plain PyTorch (``gmm_bwd_ref``): the weights' gradients are
read from x and dy, and never as a transposed view through the kernel.

The kernels are the operator ``torch.ops.repro_torch.gmm``: its CUDA
implementation launches one, and its fake (also its meta) implementation
gives the output's shape and dtype, so a meta tensor (the dry run) reaches
the kernels' shape function, never a kernel or the plain version.  The
operator is registered through ``torch.library.Library``, whose dispatch
costs the host less than a ``custom_op``'s.  ``work`` is the kernels' work
count (FLOPs and bytes), which the operator's FLOP formula, the dry run
and the card's bound read.

``launches`` counts the kernel launches this process made,
``launches_by_kernel`` the same by kernel (``choose_kernel``'s names);
``last_kernel`` names the kernel the last launch ran.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build, _sharded
from .ref import gmm_ref

launches = 0
launches_by_kernel: dict[str, int] = {}
last_kernel: str | None = None

BLOCK_M = 64        # rows (b, c) of one expert per f32 block; see gmm.cu
TILE_K = 64         # depths a k-tile of the bf16 kernels (one 128-byte row)
# The narrow kernel puts an expert's rows, padded to 8 in each batch row,
# on wgmma's N side and reads each weight tile once for all of them: one
# warpgroup a block at every N up to 64 (granite's decode at 3 slots holds
# 24 rows), a cluster of two blocks sharing the rows at N = 128, 192 and
# 256 (wgmma's largest; mixtral's decode at 32 slots holds 256).  It never
# computes more rows than the wide kernel, whose 64-row half-tiles each
# hold one batch row's rows; past 256 rows the wide kernel serves.
NARROW_MAX_ROWS = 256
MAP_CACHE_SIZE = 256   # weights' tensor maps kept (granite holds 72)
_KERNEL_IDS = {"f32": 0, "wide": 1, "narrow": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_SOURCES = (Path(__file__).resolve().parent / "csrc" / "gmm.cu",)
_TMA_MAX_STRIDE = 1 << 40     # bytes
_maps: OrderedDict = OrderedDict()


def narrow_rows(B: int, C: int) -> int:
    """N of the narrow kernel: each batch row's C rows padded to 8."""
    return B * -(-C // 8) * 8


def choose_kernel(dtype: torch.dtype, B: int, C: int) -> str:
    """The kernel for x (B,E,C,D) of ``dtype``: f32, narrow or wide."""
    if dtype == torch.float32:
        return "f32"
    return "narrow" if narrow_rows(B, C) <= NARROW_MAX_ROWS else "wide"


def tma_strides(shape, strides, itemsize: int = 2) -> tuple | None:
    """The strides (in elements, all dims but the last, which is
    contiguous) with which TMA reads a tensor in place, or None when it
    cannot: a stride that is zero or not a multiple of 16 bytes.  A dim of
    size 1 is never stepped along, so its stride is replaced by the one a
    contiguous tensor would have there (torch leaves such strides free)."""
    out = list(strides[:-1])
    inner = shape[-1]
    for dim in range(len(shape) - 2, -1, -1):
        stride = strides[dim] if shape[dim] > 1 else inner
        nbytes = stride * itemsize
        if nbytes <= 0 or nbytes % 16 or nbytes >= _TMA_MAX_STRIDE:
            return None
        out[dim] = stride
        inner *= shape[dim]
    return tuple(out)


def weight_map_key(w: torch.Tensor) -> tuple:
    """What w's tensor map is made from, and so its cache key: the
    address, the dims (E, D, F), the strides of E and D in elements and
    the box."""
    E, D, F = w.shape
    return (w.data_ptr(), E, D, F, w.stride(0), w.stride(1), TILE_K, 64)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("moe_gmm", _SOURCES)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm.argtypes = [p] * 3 + [i] * 5 + [ll] * 5 + [i, p, p]
    lib.moe_gmm.restype = i
    lib.moe_gmm_encode_weights.argtypes = [p, p, i, i, i, ll, ll]
    lib.moe_gmm_encode_weights.restype = i
    lib.moe_gmm_error_string.argtypes = [i]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def _weight_operand(lib, w: torch.Tensor):
    """w as the kernels read it (itself, or a contiguous copy where TMA
    cannot read it in place) and its encoded tensor map (128 bytes), from
    the cache or new."""
    key = weight_map_key(w)
    buf = _maps.get(key)
    if buf is not None:
        _maps.move_to_end(key)
        return w, buf
    strides = tma_strides(w.shape, w.stride())
    if strides is None:
        return _weight_operand(lib, w.contiguous())
    buf = ctypes.create_string_buffer(128)
    E, D, F = w.shape
    if lib.moe_gmm_encode_weights(buf, w.data_ptr(), E, D, F, *strides):
        raise RuntimeError("moe_gmm: cuTensorMapEncodeTiled refused the "
                           f"tensor map of w {tuple(w.shape)} strides "
                           f"{strides}")
    _maps[key] = buf
    if len(_maps) > MAP_CACHE_SIZE:
        _maps.popitem(last=False)
    return w, buf


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ValueError on anything the kernels do not take."""
    if x.dim() not in (3, 4) or w.dim() != 3:
        raise ValueError(f"need x (E,C,D) or (B,E,C,D) and w (E,D,F), got "
                         f"x {tuple(x.shape)} w {tuple(w.shape)}")
    E, C, D = x.shape[-3:]
    F = w.shape[2]
    if tuple(w.shape[:2]) != (E, D):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "agree on E and D")
    if D < 8 or F < 8 or D % 8 or F % 8:
        raise ValueError(f"D={D} and F={F} must be positive multiples of 8")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dtypes x {x.dtype} w {w.dtype}: both must be one "
                         f"of {list(_DTYPES)}")
    if x.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError("the last dim of x and of w must be contiguous")
    if any(s % 8 for s in x.stride()[:-1] + w.stride()[:-1]) \
            or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("strides must be multiples of 8 elements and base "
                         "pointers 16-byte aligned (16-byte row loads)")
    rows = C * (x.shape[0] if x.dim() == 4 else 1)
    if (rows + BLOCK_M - 1) // BLOCK_M > 65535 or E > 65535:
        raise ValueError(f"too many rows ({rows}) or experts ({E}) for the "
                         "launch grid")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gmm kernel needs x and w on one CUDA device, got "
                         f"{x.device} and {w.device}")


def _tma_operand(t: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """t with the strides TMA reads it by: t itself, or a contiguous copy
    where a stride is zero."""
    strides = tma_strides(t.shape, t.stride())
    if strides is None:
        t = t.contiguous()
        strides = tma_strides(t.shape, t.stride())
    return t, strides


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches, last_kernel
    _check(x, w)
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    B, E, C, D = x4.shape
    F = w.shape[2]
    kernel = choose_kernel(x.dtype, B, C)
    lib = _kernel()
    wmap = None
    if kernel == "f32":
        xs, ws = x4.stride()[:3], w.stride()[:2]
    else:
        x4, xs = _tma_operand(x4)
        w, wmap = _weight_operand(lib, w)
        ws = w.stride()[:2]
    out = torch.empty((B, E, C, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gmm(x4.data_ptr(), w.data_ptr(), out.data_ptr(),
                          B, E, C, D, F, *xs, *ws, _KERNEL_IDS[kernel],
                          wmap, stream)
    if err:
        raise RuntimeError(f"moe_gmm ({kernel}) launch failed: "
                           f"{lib.moe_gmm_error_string(err).decode()}")
    launches += 1
    launches_by_kernel[kernel] = launches_by_kernel.get(kernel, 0) + 1
    last_kernel = kernel
    return out if x.dim() == 4 else out[0]


def work(B: int, E: int, C: int, D: int, F: int, itemsize: int = 2
         ) -> tuple[int, int]:
    """(FLOPs, bytes) of one call on x (B,E,C,D) and w (E,D,F): 2 FLOP per
    multiply-add; x and w read once, the output written once."""
    return (2 * B * E * C * D * F,
            (B * E * C * D + E * D * F + B * E * C * F) * itemsize)


def op_work(x, w) -> tuple[int, int]:
    """``work`` of one ``gmm`` call, from its arguments."""
    B = x.shape[0] if x.dim() == 4 else 1
    E, C, D = x.shape[-3:]
    return work(B, E, C, D, w.shape[2], x.element_size())


def _gmm_cuda(x, w):
    return _launch(x, w)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("gmm(Tensor x, Tensor w) -> Tensor")
_LIB.impl("gmm", _gmm_cuda, "CUDA")


@torch.library.register_fake("repro_torch::gmm", lib=_LIB)
def _gmm_fake(x, w):
    if x.dim() not in (3, 4) or w.dim() != 3 \
            or tuple(w.shape[:2]) != tuple(x.shape[-3::2]):
        raise ValueError(f"need x (E,C,D) or (B,E,C,D) and w (E,D,F) that "
                         f"agree, got x {tuple(x.shape)} w {tuple(w.shape)}")
    return x.new_empty(tuple(x.shape[:-1]) + (w.shape[2],))


@register_flop_formula(torch.ops.repro_torch.gmm, get_raw=True)
def _gmm_flops(x, w, out_val=None) -> int:
    return op_work(x, w)[0]


def _forward(x: torch.Tensor, w: torch.Tensor, impl: str) -> torch.Tensor:
    if impl == "ref" or (impl == "auto" and x.device.type == "cpu"):
        return gmm_ref(x, w)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}; expected auto | ref")
    return torch.ops.repro_torch.gmm(x, w)


def gmm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The products' gradients, plain PyTorch: dx = dy w^T per expert and
    dw = sum over (b, c) of x^T dy, each accumulated in f32 (f64 for f64
    inputs, as the forward) and cast to x's and w's dtypes (what
    ``jax.grad`` of the reference's einsum gives)."""
    acc = torch.promote_types(dy.dtype, torch.float32)
    dyf = dy.to(acc)
    dx = torch.einsum("...ecf,edf->...ecd", dyf, w.to(acc)).to(x.dtype)
    dw = torch.einsum("...ecd,...ecf->edf", x.to(acc), dyf).to(w.dtype)
    return dx, dw


class GroupedMatmul(torch.autograd.Function):
    """The expert products under autograd: the forward is the kernel (or
    the plain version, by ``impl``), the backward ``gmm_bwd_ref``.  The
    reference has no gmm backward: it trains through einsums under
    ``jax.grad``."""

    @staticmethod
    def forward(ctx, x, w, impl: str):
        ctx.save_for_backward(x, w)
        return _forward(x, w, impl)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = gmm_bwd_ref(x, w, dy)
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """x: (E,C,D) or (B,E,C,D); w: (E,D,F) -> (E,C,F) or (B,E,C,F) in x's
    dtype, each product accumulated in f32.  impl: auto | ref.
    Differentiable (through ``GroupedMatmul``) when grad is enabled and x
    or w requires grad.  DTensors run on each rank's local shards
    (``kernels._sharded.gmm``)."""
    if _sharded.is_sharded(x, w):
        return _sharded.gmm(grouped_matmul, x, w, impl=impl)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w, impl)
    return _forward(x, w, impl)
