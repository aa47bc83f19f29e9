"""Fault-tolerant checkpointing: atomic, async (PyTorch port of the JAX
package's ``train/checkpoint.py``, the same layout).

Layout (one directory per step)::

    <dir>/step_000420/
        manifest.json      # step, leaf paths, shapes, dtypes, leaf files
        leaf_00000.npy ... # one .npy per state leaf (host numpy)
    <dir>/LATEST           # atomic pointer file -> "step_000420"

Leaf paths are the reference's (``.params['periods']['b0']['mixer']['wq']``),
so either package restores the other's checkpoints of the same config.  A
bfloat16 leaf, which numpy has no type for, is stored as float32 (exact)
with ``"bfloat16"`` in the manifest; restore casts every leaf to the dtype
of the state it restores into.

Guarantees used by the restart path:

* **atomicity** — writes land in ``.tmp-step_X`` and are ``os.rename``-d
  into place only after fsync; a crash mid-save never corrupts the previous
  checkpoint, and LATEST flips last;
* **async** — ``save_async`` copies the state to the host (blocking only
  for the device->host copy) then writes on a background thread, so the
  train loop overlaps checkpoint I/O with the next steps;
* **device-agnostic restore** — leaves are stored as full host arrays keyed
  by tree path; ``restore`` puts each on the device of the state it
  restores into;
* **retention** — ``keep`` most recent checkpoints are retained, older ones
  deleted after a successful save (never before);
* **sharded state** — a DTensor leaf (``launch.train --mesh``) is gathered
  into its full tensor on every rank and written by rank 0 alone; restore
  places each leaf as the DTensor it restores into is placed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..sharding import full_tensor, is_dtensor
from ._tree import tree_map, tree_paths, tree_unflatten

__all__ = ["Checkpointer", "save", "restore", "latest_step"]


def _group_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or no group."""
    return _group_size() == 1 or torch.distributed.get_rank() == 0


def _barrier() -> None:
    if _group_size() > 1:
        torch.distributed.barrier()


def _host(leaf) -> tuple:
    """(numpy array, dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def latest_step(directory: str) -> Optional[int]:
    pointer = os.path.join(directory, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    if not name.startswith("step_"):
        return None
    return int(name[len("step_") :])


def save(directory: str, step: int, state) -> str:
    """Synchronous atomic save (DTensor leaves gathered; only rank 0
    writes).  Returns the final checkpoint path."""
    state = tree_map(full_tensor, state)
    name = f"step_{step:06d}"
    tmp = os.path.join(directory, f".tmp-{name}")
    final = os.path.join(directory, name)
    if not _writer():
        return final
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree_paths(state)):
        arr, dtype = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    pointer_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(pointer_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.rename(pointer_tmp, os.path.join(directory, "LATEST"))
    return final


def restore(directory: str, state_like, step: Optional[int] = None):
    """Rebuild ``state_like``'s tree from disk: each leaf takes the shape it
    had on disk, which must be ``state_like``'s, and the dtype and device of
    ``state_like``'s leaf (a tensor; any other leaf comes back as a CPU
    tensor of the stored dtype).  Returns ``(state, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves = []
    for key, like in tree_paths(state_like):
        if key not in by_path:
            raise KeyError(f"checkpoint misses leaf {key}")
        entry = by_path[key]
        arr = np.load(os.path.join(path, entry["file"]))
        want_shape = tuple(getattr(like, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {key}: checkpoint shape {arr.shape} != {want_shape}"
            )
        t = torch.from_numpy(arr)
        if isinstance(like, torch.Tensor):
            t = t.to(device=like.device, dtype=like.dtype)
        if is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor

            t = distribute_tensor(t, like.device_mesh, like.placements)
        leaves.append(t)
    return tree_unflatten(state_like, leaves), manifest["step"]


class Checkpointer:
    """Async wrapper with retention.  One in-flight save at a time — a new
    ``save_async`` waits for the previous write to finish (the host copy is
    taken synchronously so the state can keep changing)."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, state) -> None:
        self.wait()
        # copy to the host NOW (cheap vs. step time; a CPU leaf is copied too;
        # a DTensor is gathered first, on every rank)
        host_state = tree_map(lambda x: full_tensor(x).detach().to("cpu", copy=True)
                              if isinstance(x, torch.Tensor) else x, state)
        if not _writer():
            return

        def work():
            try:
                save(self.directory, step, host_state)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, state) -> str:
        self.wait()
        out = save(self.directory, step, state)
        if _writer():
            self._gc()
        _barrier()  # every rank sees the checkpoint once this returns
        return out

    def restore_latest(self, state_like):
        self.wait()
        _barrier()
        return restore(self.directory, state_like)

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n[len("step_") :])
            for n in os.listdir(self.directory)
            if n.startswith("step_")
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:06d}"),
                ignore_errors=True,
            )
