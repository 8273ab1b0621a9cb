"""Torn-write-safe, async checkpointing of tensor trees.

The counterpart of the JAX package's `checkpoint/checkpointer.py`, in its
layout:
    <dir>/step_000123/
        arrays.npz            # flattened leaf path -> ndarray
        MANIFEST.json         # step, leaf metadata, the extra dict
                              # (data-pipeline cursor ...); written LAST

A checkpoint is valid iff MANIFEST.json parses — a crash mid-save leaves
no manifest, so `latest_step` skips it (torn-write safety).  Leaf paths
join the nested dict keys with ``||`` in sorted order, as the JAX
package's flatten does.  bf16 leaves (which NumPy has no type for) are
stored as their 16-bit patterns, with "bfloat16" in the manifest.  There
is no mesh: `restore_checkpoint` puts each leaf on the target leaf's
device (or `device` for a `TensorSpec` target).

`AsyncCheckpointer.save` copies every tensor to host memory before it
returns and writes in a daemon thread.  The copy matters more than in the
JAX package: the port's optimizer updates parameters in place, so the
next step would otherwise change the arrays under the writer.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

_SEP = "||"
_BF16 = "bfloat16"


def _paths(tree, prefix: tuple = ()):
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _paths(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> tuple:
    """({path: ndarray}, {path: dtype name}) of a nested dict's leaves."""
    flat, dtypes = {}, {}
    for path, leaf in _paths(tree):
        key = _SEP.join(str(p) for p in path)
        flat[key] = _to_numpy(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        dtypes[key] = _BF16 if bf16 else str(flat[key].dtype)
    return flat, dtypes


def _write(directory: Path, step: int, flat: dict, dtypes: dict,
           extra: Optional[dict], keep: int) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    # Manifest written last => its presence marks a complete checkpoint.
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _garbage_collect(directory, keep)
    return final


def save_checkpoint(directory: str | Path, step: int, tree: Any, *,
                    extra: Optional[dict] = None, keep: int = 3) -> Path:
    """Write `tree` (nested dicts of tensors or arrays) as step `step`;
    keeps the newest `keep` checkpoints."""
    flat, dtypes = _flatten(tree)
    return _write(Path(directory), step, flat, dtypes, extra, keep)


def _garbage_collect(directory: Path, keep: int):
    steps = sorted(
        (p for p in directory.glob("step_*") if (p / "MANIFEST.json").exists()),
        key=lambda p: p.name,
    )
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    best = None
    for p in directory.glob("step_*"):
        if not (p / "MANIFEST.json").exists():
            continue  # torn write — ignore
        try:
            manifest = json.loads((p / "MANIFEST.json").read_text())
        except Exception:
            continue
        if best is None or manifest["step"] > best:
            best = manifest["step"]
    return best


def restore_checkpoint(directory: str | Path, step: int, target: Any, *,
                       device=None):
    """Restore into the structure of `target` (a nested dict of tensors or
    `TensorSpec`s): each leaf a new tensor of the target leaf's shape and
    dtype, on its device (a `TensorSpec` leaf: on `device`, default the
    CPU).  Returns (tree, extra)."""
    path = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "MANIFEST.json").read_text())
    data = np.load(path / "arrays.npz")

    def load(keys: tuple, leaf) -> torch.Tensor:
        key = _SEP.join(str(k) for k in keys)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        if manifest["leaves"][key]["dtype"] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = leaf.device if isinstance(leaf, torch.Tensor) else device
        return t.to(device=dev or "cpu", dtype=leaf.dtype)

    def rebuild(node: dict, prefix: tuple) -> dict:
        return {key: rebuild(sub, prefix + (key,)) if isinstance(sub, dict)
                else load(prefix + (key,), sub) for key, sub in node.items()}

    return rebuild(target, ()), manifest["extra"]


class AsyncCheckpointer:
    """Copy to the host synchronously, write in a background daemon
    thread.  The last save's host copy and write seconds and its bytes are
    kept in `last_copy_seconds`, `last_write_seconds` (after `wait`) and
    `last_bytes`."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[str] = None
        self.last_copy_seconds = self.last_write_seconds = 0.0
        self.last_bytes = 0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()  # one in flight at a time
        t0 = time.perf_counter()
        flat, dtypes = _flatten(tree)   # host copies, before any update
        self.last_copy_seconds = time.perf_counter() - t0
        self.last_bytes = sum(a.nbytes for a in flat.values())

        def work():
            t1 = time.perf_counter()
            try:
                _write(self.directory, step, flat, dtypes, extra, self.keep)
            except Exception as e:  # surfaced on next wait()/save()
                self.last_error = repr(e)
            self.last_write_seconds = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
