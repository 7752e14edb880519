"""Public op: grouped expert matmul, the Hopper kernel or its plain version.

A CPU tensor goes to the plain version (``ref.gmm_ref``).  A CUDA tensor
launches the kernel in ``csrc/gmm.cu`` or raises: there is no fallback.
``impl="ref"`` asks for the plain version explicitly, for the tests and
for comparing the kernel with it on the card.

The op keeps the Pallas kernel's signature, x (E,C,D) x w (E,D,F) ->
(E,C,F), and also takes the model's expert buffers x (B,E,C,D) in place,
through their strides, giving (B,E,C,F): no copy folds B into C.

``launches`` counts the kernel launches this process made.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build
from .ref import gmm_ref

launches = 0

BLOCK_M = 64        # rows (b, c) of one expert per block; see gmm.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = (Path(__file__).resolve().parent / "csrc" / "gmm.cu",)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("moe_gmm", _SOURCES)
    fn = lib.moe_gmm
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 3 + [i] * 5 + [ll] * 5 + [i, p]
    fn.restype = ctypes.c_int
    lib.moe_gmm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _kernel()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take."""
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


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    _check(x, w)
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    B, E, C, D = x4.shape
    F = w.shape[2]
    out = torch.empty((B, E, C, F), dtype=x.dtype, device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gmm(x4.data_ptr(), w.data_ptr(), out.data_ptr(),
                          B, E, C, D, F, *x4.stride()[:3],
                          *w.stride()[:2], _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("moe_gmm launch failed: "
                           f"{lib.moe_gmm_error_string(err).decode()}")
    launches += 1
    return out if x.dim() == 4 else out[0]


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """x: (E,C,D) or (B,E,C,D); w: (E,D,F) -> (E,C,F) or (B,E,C,F) in x's
    dtype, each product accumulated in f32.  impl: auto | ref."""
    if impl == "ref" or (impl == "auto" and x.device.type == "cpu"):
        return gmm_ref(x, w)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}; expected auto | ref")
    return _launch(x, w)
