"""Fault-tolerant checkpointing with atomic manifests: the port of
``repro.checkpoint.manager``, with its on-disk format, so a checkpoint
written by either package restores in the other.

* **format**: one directory ``step_<10 digits>`` a checkpoint, holding
  ``arrays.npz`` (keys: the ``/``-joined tree paths, with ``__`` in place
  of ``/``) and ``manifest.json`` (step, extra, and each array's shape and
  logical dtype).  npz cannot hold bf16: bf16 is widened to f32 on disk
  and the manifest says ``"bfloat16"``.  Trees are the reference's layout
  (``convert.params_to_tree``, ``convert.opt_state_to_tree``);
* **atomic**: arrays are written to a temp directory, fsynced, then the
  directory is renamed into place last - a crash mid-save never corrupts
  the latest checkpoint;
* **async**: the arrays are copied to the host on the calling thread (the
  trainer then updates its tensors in place) and written on a writer
  thread; the writer serializes on a GCR-wrapped ``PthreadMutexLock`` (the
  checkpoint store is a contended resource when many trainers share a
  filesystem - the paper's mechanism again);
* **retention**: keeps the newest ``keep`` checkpoints, deleting older ones
  only after a successful save (never drops the last good state);
* **sharded**: a DTensor leaf is gathered by ``save`` (every rank calls it)
  and only rank 0 of a started process group writes; ``restore(shardings=)``
  places each loaded leaf on the current mesh (the elastic resume: a
  checkpoint written on one mesh restores on another, or on one device).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from ..convert import to_numpy
from ..core import gcr_wrap
from ..core.locks import PthreadMutexLock


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _writer() -> bool:
    """Whether this process writes: rank 0, or a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._lock = gcr_wrap(PthreadMutexLock(), promote_threshold=64)
        self._pending: Optional[threading.Thread] = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None) -> None:
        """state: nested dict of tensors (params/opt/...), copied to the
        host now (DTensors gathered: every rank calls); extra:
        JSON-serializable.  Only the writer (rank 0) writes."""
        host = {k: (to_numpy(v), str(v.dtype).removeprefix("torch."))
                for k, v in _flatten(state).items()}
        if not _writer():
            return
        if self.async_save:
            self.wait()
            t = threading.Thread(
                target=self._write, args=(step, host, extra or {}),
                daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(step, host, extra or {})

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               extra: Dict) -> None:
        self._lock.acquire()
        try:
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "extra": extra, "arrays": {}}
            storable = {}
            for k, (arr, dtype) in host.items():
                manifest["arrays"][k] = {"shape": list(arr.shape),
                                         "dtype": dtype}
                storable[k.replace("/", "__")] = arr
            with open(tmp / "arrays.npz", "wb") as f:
                np.savez(f, **storable)
                f.flush()
                os.fsync(f.fileno())
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic publish
            self._gc()
        finally:
            self._lock.release()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, step: Optional[int] = None,
                shardings: Optional[Any] = None):
        """Returns (step, state, extra), state a nested dict of numpy
        arrays in their logical dtypes, except bf16, which numpy lacks:
        those come back widened to f32 as stored (exactly), and loading
        them into a bf16 parameter casts them back.  ``shardings``: a
        nested dict of ``parallel.sharding.LeafSharding`` matching (part
        of) the state tree; each leaf it names comes back placed on its
        mesh (a DTensor, or one per layer for a stacked leaf) - the
        elastic resume on a different mesh."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        with np.load(d / "arrays.npz") as npz:
            for k, meta in manifest["arrays"].items():
                arr = npz[k.replace("/", "__")]
                want = meta["dtype"]
                if str(arr.dtype) != want and want != "bfloat16":
                    arr = arr.astype(np.dtype(want))
                flat[k] = arr
        if shardings is not None:
            flat_sh = _flatten(shardings)
            flat = {k: flat_sh[k].place(v) if k in flat_sh else v
                    for k, v in flat.items()}
        return manifest["step"], _unflatten(flat), manifest["extra"]
