"""Build the port's CUDA sources at first use and load them with ctypes.

Each kernel's ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/repro_torch_kernels/`` at
the root of the checkout, keyed by a hash of the sources and the flags,
so an edited source is rebuilt and an unchanged one is loaded as is.
The headers under ``kernels/common/`` (``#include "common/..."``) are
hashed with every library, so an edited header rebuilds them all.
Nothing prebuilt is committed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def common_headers() -> list[Path]:
    """The shared headers every kernel source may include."""
    return sorted((KERNELS_DIR / "common").glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on a machine with the CUDA toolkit")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *common_headers()]:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``build/repro_torch_kernels/<name>-<hash>.so``
    unless it is there already; nvcc's report (registers, shared memory,
    spills) is kept beside it as ``.log``.  Returns the library's path."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(KERNELS_DIR), "-o", tmp,
               *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"({' '.join(cmd)}):\n{proc.stdout}"
                               f"{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)   # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, sources: tuple) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    return ctypes.CDLL(str(build(name, sources)))
