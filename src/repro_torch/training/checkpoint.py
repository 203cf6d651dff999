"""Checkpointing with async write and atomic commit (the JAX package's
``training/checkpoint.py``, on numpy and torch).

Layout (one directory per step):

    <dir>/step_000123.tmp/        <- written here first
        META.json                  (leaf paths, shapes, dtypes, step)
        leaf_00000.npy ...
    <dir>/step_000123/             <- atomic rename on completion

A state is a tree of dicts, NamedTuples, lists and leaves (tensors or numpy
arrays); a leaf's path joins its keys with "/" (the trainer's tree is
keyed by ``convert.Leaf.key``: ``params/layers/3/attn/wq``, ``opt/m/...``,
``opt/step``).  A bf16 tensor is stored as float32, which holds it
exactly, with ``bfloat16`` named as its dtype in META.json.

Fault-tolerance contract (tested):
  * a crash mid-write leaves only a ``.tmp`` dir, ignored on restore;
  * ``restore_latest`` picks the newest committed step;
  * ``restore`` writes into the tensors of ``like`` in place (captured
    graphs and views keep reading the same storage) after checking every
    shape, and returns numpy arrays for numpy leaves.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(state: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in order: dict keys as given, NamedTuple fields,
    list indices."""
    if isinstance(state, Mapping):
        items = state.items()
    elif isinstance(state, tuple) and hasattr(state, "_fields"):
        items = state._asdict().items()
    elif isinstance(state, (list, tuple)):
        items = enumerate(state)
    else:
        return [(prefix, state)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten_like(like: Any, leaves: iter) -> Any:
    if isinstance(like, Mapping):
        return {k: _unflatten_like(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_like(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and the dtype to name for it."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, state: Any, step: int, *, keep: int = 3) -> str:
    """Synchronous save with atomic commit. Returns the final path."""
    return _write(directory, [(p, *_to_host(x)) for p, x in _flatten(state)], step, keep)


def _write(directory: str, leaves, step: int, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "leaves": []}
    for i, (path, arr, dtype) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"].append({"path": path, "file": fname, "shape": list(arr.shape),
                               "dtype": dtype})
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


class AsyncCheckpointer:
    """Snapshot to host, write on a background thread (training continues)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, state: Any, step: int) -> None:
        self.wait()
        host = [(p, *_to_host(x)) for p, x in _flatten(state)]

        def _run():
            self.last_path = _write(self.directory, host, step, self.keep)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def available_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "META.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: every shape is checked
    first, then each tensor leaf is written in place (cast to its dtype)
    and each other leaf replaced by the stored array.  Returns (the tree,
    the step)."""
    with open(os.path.join(path, "META.json")) as f:
        meta = json.load(f)
    by_path = {entry["path"]: entry for entry in meta["leaves"]}
    loaded = []
    for key, leaf in _flatten(like):
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, by_path[key]["file"]))
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {expect}")
        loaded.append((leaf, arr))
    out = []
    with torch.no_grad():
        for leaf, arr in loaded:
            if torch.is_tensor(leaf):
                leaf.copy_(torch.from_numpy(arr).to(leaf.dtype))
                out.append(leaf)
            else:
                out.append(arr)
    return _unflatten_like(like, iter(out)), int(meta["step"])


def restore_latest(directory: str, like: Any):
    steps = available_steps(directory)
    if not steps:
        return None, -1
    return restore(os.path.join(directory, f"step_{steps[-1]:08d}"), like)


def _gc(directory: str, keep: int) -> None:
    steps = available_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
