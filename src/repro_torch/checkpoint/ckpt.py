"""Fault-tolerant checkpointing (port of `repro/checkpoint/ckpt.py`), in
the reference's on-disk format, so a checkpoint written by either
package restores in the other:

  * `step_<N>/manifest.json` lists every leaf (name, npz key, shape,
    dtype, encoded) and `step_<N>/arrays.npz` holds the leaves as
    logically global arrays; bfloat16 is stored as raw bytes, flagged
    `encoded` (npz has no bfloat16);
  * **step-atomic**: written to `step_<N>.tmp/`, fsynced, renamed, and
    the parent directory fsynced, so a crash mid-write never corrupts the
    latest checkpoint; `.tmp` debris is removed when the directory is
    scanned;
  * `CheckpointManager` snapshots to host memory on the caller's thread
    and, with `async_write`, writes on a background thread; `keep`
    bounds how many complete checkpoints stay.

Trees are nested dicts/lists of tensors; leaves are named by their path,
e.g. ``params/stages/0/b0/wq``.  The training
loop saves the reference's layout (`convert.params_to_reference`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..tree import named_leaves, tree_map, tree_map_with_path

_NATIVE_DTYPES = {"bool", "int8", "int16", "int32", "int64", "uint8",
                  "uint16", "uint32", "uint64", "float16", "float32",
                  "float64", "complex64", "complex128"}


def _host(leaf):
    """A host copy that outlives the caller's next in-place update."""
    return leaf.detach().to("cpu", copy=True)


def _encode(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _decode(arr: np.ndarray, leaf: dict):
    """A stored leaf as a torch tensor (bfloat16 from its raw bytes)."""
    if not leaf.get("encoded"):
        return torch.from_numpy(np.array(arr))     # keeps 0-d leaves 0-d
    if leaf["dtype"] != "bfloat16":
        raise ValueError(f"leaf {leaf['name']!r}: cannot decode dtype "
                         f"{leaf['dtype']}")
    raw = np.ascontiguousarray(arr).view(np.int16).reshape(leaf["shape"])
    return torch.from_numpy(raw.copy()).view(torch.bfloat16)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomic save.  Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    arrays = {}
    for i, (name, leaf) in enumerate(named_leaves(tree)):
        arr, dtype = _encode(leaf)
        key = f"a{i}"
        encoded = dtype not in _NATIVE_DTYPES
        arrays[key] = (np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
                       if encoded else arr)
        manifest["leaves"].append(
            {"name": name, "key": key, "shape": list(arr.shape),
             "dtype": dtype, "encoded": encoded})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)         # atomicity point
    # durability point: fsync the parent so the rename survives a crash
    dfd = os.open(ckpt_dir, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.isdir(os.path.join(ckpt_dir, d)):
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
        elif d.endswith(".tmp"):   # crash debris
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of `like_tree`: each leaf becomes a
    tensor of the like leaf's dtype and device.  Returns (tree, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def one(name, like):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            leaf = by_name[name]
            t = _decode(data[leaf["key"]], leaf)
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"leaf {name!r}: checkpoint shape "
                                 f"{tuple(t.shape)} != {tuple(like.shape)}")
            return t.to(dtype=like.dtype, device=like.device)

        return tree_map_with_path(one, like_tree), manifest["extra"]


class CheckpointManager:
    """Rolling checkpoints with optional async writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 async_write: bool = False):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        # snapshot on the caller thread (device -> host), write async
        host_tree = tree_map(_host, tree)
        if self.async_write:
            def work():
                try:
                    save(self.ckpt_dir, step, host_tree, extra)
                    self._gc()
                except Exception as e:   # surfaced on the next save/wait
                    self._error = e
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save(self.ckpt_dir, step, host_tree, extra)
            self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error

    def _gc(self):
        steps = sorted(
            int(d[5:]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.ckpt_dir)

    def restore(self, like_tree, step: int | None = None):
        step = step if step is not None else self.latest()
        if step is None:
            return None
        return restore(self.ckpt_dir, step, like_tree)
