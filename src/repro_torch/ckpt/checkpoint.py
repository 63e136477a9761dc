"""Async, atomically-published train-state checkpoints with restore onto a
given device.

Mirrors `repro/ckpt/checkpoint.py` and keeps its on-disk format, so each
package restores the other's checkpoints:

Layout:  <dir>/step_<N>/   arrays.npz  +  meta.json
         <dir>/step_<N>.tmp.<pid>      staging, atomically renamed.

  - keys: each leaf's key path joined by "/" (`params/blocks/sub0/attn/wq`,
    `opt/count`);
  - leaves numpy cannot hold (bf16) are stored as a uint8 byte view, with
    the true dtype name ("bfloat16") in `meta["dtypes"]`;
  - async: the copy to host memory happens on the caller's thread, the
    file write on a background thread; `wait()` joins outstanding saves;
  - atomic publish: readers only ever see complete step_<N> directories;
  - retention: keep_last prunes old steps after a successful publish.

The copy on the caller's thread is a real copy (`.to("cpu", copy=True)`),
also for a CPU tensor: the optimizer updates the state in place, so a
snapshot that shared storage with it would race the next step's update.

`restore(step, like_state, device)` restores onto the `like` leaves'
shapes and dtypes, on one device; with `mesh` and a `placements` tree it
restores onto those placements (each rank keeps its slices), which may
differ from the ones the state was saved from: the reference's elastic
restore.

A sharded state (DTensor leaves) is saved whole: every rank gathers each
leaf (a collective, so every rank calls `save`) and rank 0 writes.  A
blocking save and `wait()` end with a barrier, so no rank reads a step
before rank 0 has published it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_mod
from repro_torch.sharding import partition

# dtypes numpy holds natively; the rest are stored as a byte view
_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
           "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _flatten(state) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Host copies of every leaf, by key, and their true dtype names."""
    arrays, dtypes = {}, {}
    for path, leaf in tree_mod.leaves_with_paths(state):
        key = _key(path)
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        dtypes[key] = _dtype_name(t.dtype)
        if dtypes[key] not in _NATIVE:
            t = t.view(torch.uint8)
        arrays[key] = t.numpy()
    return arrays, dtypes


def _ranks() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _ranks()[1] > 1:
        dist.barrier()


def _from_saved(arr: np.ndarray, true_dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.require(arr, requirements="C"))
    if str(arr.dtype) != true_dtype:       # raw byte view round-trip
        t = t.view(getattr(torch, true_dtype))
    return t


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._pending: list[threading.Thread] = []

    # -- save -------------------------------------------------------------

    def save(self, step: int, state, meta: dict | None = None,
             blocking: bool = False) -> None:
        arrays, dtypes = _flatten(state)
        meta = dict(meta or {}, step=step, time=time.time(),
                    dtypes=dtypes)
        if _ranks()[0] != 0:        # rank 0 writes; the rest only gather
            if blocking:
                _barrier()
            return

        def _write():
            tmp = self.dir / f"step_{step}.tmp.{os.getpid()}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "arrays.npz", **arrays)
            (tmp / "meta.json").write_text(json.dumps(meta))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._prune()

        t = threading.Thread(target=_write, daemon=True)
        t.start()
        self._pending.append(t)
        if blocking:
            t.join()
            _barrier()

    def wait(self) -> None:
        for t in self._pending:
            t.join()
        self._pending.clear()
        _barrier()

    def _prune(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore -----------------------------------------------------------

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if p.is_dir() and ".tmp." not in p.name)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like_state, device=None, mesh=None,
                placements=None):
        """The saved state in like_state's structure, each leaf with its
        `like` leaf's shape and dtype, on `device` (default: each like
        leaf's own device; pass one for `meta` like leaves).  With `mesh`
        and `placements` (a tree of per-mesh-dim placement lists matching
        like_state) each leaf becomes a DTensor at its placements."""
        saved_dtypes = self.meta(step).get("dtypes", {})
        pls = (tree_mod.leaves(placements) if placements is not None
               else None)
        with np.load(self.dir / f"step_{step}" / "arrays.npz") as data:
            def leaf(i, path, like):
                key = _key(path)
                arr = data[key]
                t = _from_saved(arr, saved_dtypes.get(key, str(arr.dtype)))
                if tuple(t.shape) != tuple(like.shape):
                    raise ValueError(f"{key}: ckpt {tuple(t.shape)} vs "
                                     f"target {tuple(like.shape)}")
                t = t.to(device if device is not None else like.device,
                         like.dtype)
                if pls is not None:
                    t = partition.distribute(t, mesh, pls[i])
                return t
            return tree_mod.unflatten(like_state, [
                leaf(i, p, like) for i, (p, like) in enumerate(
                    tree_mod.leaves_with_paths(like_state))])

    def meta(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step_{step}" / "meta.json").read_text())

