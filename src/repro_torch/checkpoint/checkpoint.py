"""Checkpointing: save/restore of parameter trees, rotation and background
saves, in the JAX package's format, so a checkpoint written by either
package opens in the other.

A checkpoint is a directory holding `arrays.npz` (one array per leaf) and
`manifest.json` with `keys` (sorted), `dtypes` and `metadata`. A leaf's
key is its path joined by "/" as jax names it: a dict key is its name, a
tuple index its number (`layers/0/attn/wq`; 8-bit moments give
`.../q` and `.../s`). bf16 leaves are stored as a uint16 view with
"bfloat16" in `dtypes` (npz has no bfloat16). The JAX package's
`treedef` entry is jax's own repr of the tree's structure; the port
writes its own description there, and neither package's restore reads
it: restore walks the caller's `like` tree and takes each leaf by key.
Writes are atomic (a `.tmp` directory, then a rename), so a preemption
mid-save never corrupts the latest checkpoint.

Restore returns CPU tensors (or tensors on `device=`) in the manifest's
dtypes; the caller moves them where it trains.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.common import map_descs, tree_unflatten


def _paths(tree, prefix: tuple = ()) -> list:
    """(key, leaf) pairs in `jax.tree.flatten`'s order, keys as jax's
    paths joined by "/"."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _paths(v,
                                                              prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def _describe(tree) -> str:
    """The tree's structure: {key: ...} dicts, (...) tuples, * leaves."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in tree) + ",)"
    return "*"


def _flatten(tree) -> tuple[dict, dict]:
    """{key: numpy array} (bf16 as its uint16 view) and {key: dtype name}
    of a tree of tensors."""
    out, dtypes = {}, {}
    for key, leaf in _paths(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[key], dtypes[key] = \
                t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        else:
            out[key] = t.numpy()
            dtypes[key] = str(out[key].dtype)
    return out, dtypes


def save_pytree(path: str, tree, *, metadata: dict | None = None) -> None:
    """Atomic save of a tree of tensors."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat, dtypes = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"treedef": "repro_torch " + _describe(tree),
                   "keys": sorted(flat), "dtypes": dtypes,
                   "metadata": metadata or {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _from_numpy(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_pytree(path: str, like, device=None):
    """Restore into the structure of `like` (any tree whose leaves have a
    `.shape`: tensors, arrays, `ParamDesc`s): each leaf read by its key,
    its shape checked against `like`'s, in the manifest's dtype. Returns
    CPU tensors, or tensors on `device`."""
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in _paths(like):
            arr = data[key]
            want = tuple(getattr(leaf, "shape", ()))
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint mismatch at {key}: "
                                 f"{arr.shape} vs {want}")
            t = _from_numpy(arr, dtypes.get(key))
            leaves.append(t if device is None else t.to(device))
    return tree_unflatten(like, iter(leaves))


def restore_metadata(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["metadata"]


class CheckpointManager:
    """Step-indexed checkpoint directory with rotation and async save."""

    def __init__(self, directory: str, *, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, *, metadata: dict | None = None,
             background: bool = False) -> None:
        """Save `tree` as step `step`, then drop all but the newest
        `keep_n`. With `background`, the leaves are copied to the host
        first (a copy even of host tensors, which the caller may update in
        place) and a thread writes them (`wait()` joins it)."""
        meta = {"step": step, **(metadata or {})}
        if background:      # a copy: the caller updates its tensors in place
            host = map_descs(lambda x: x.detach().to("cpu", copy=True), tree)
            self.wait()
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._save_sync(step, tree, meta)

    def _save_sync(self, step, tree, meta):
        save_pytree(self._step_dir(step), tree, metadata=meta)
        self._rotate()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def restore(self, like, step: int | None = None, device=None):
        """(tree, metadata) of step `step` (default the latest), or
        (None, None) when the directory holds none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        tree = restore_pytree(self._step_dir(step), like, device=device)
        meta = restore_metadata(self._step_dir(step))
        return tree, meta

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
