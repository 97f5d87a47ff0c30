"""Checkpointing with async save, in the reference's on-disk layout.

One directory per step:

    <dir>/step_00000123/
        manifest.json          leaf keys, shapes, dtypes, metadata
        shard_0.npz            the leaves, by flattened key path

Leaf keys are the reference's (`repro.checkpoint.manager`): dict keys by
name, NamedTuple fields as ``.field``, sequence items by index, joined
with ``/`` (``carry/1/.mu/.raw_off``), so a checkpoint written by either
package loads in the other. A tree is any nesting of dicts, NamedTuples,
tuples and lists over tensors, numpy arrays and numbers.

Async: ``save(..., blocking=False)`` copies the leaves to host memory and
writes them in a background thread, so the caller resumes after the copy,
not after the write. Leaves restore onto the device of the template's
tensors or, with ``shardings=`` (a matching tree of
`repro_torch.parallel.axes.NamedSharding`s, the elastic-restore path),
straight onto a mesh: each rank keeps its own shard of each leaf as a
DTensor (a rank outside that mesh gets None), whatever mesh wrote it.
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

from repro_torch.parallel.axes import distribute


def _items(tree: Any, prefix: tuple = ()):
    """(key path, leaf) pairs in the reference's order: dict keys sorted,
    NamedTuple fields and sequence items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in `_items` order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array np.savez can write, true dtype name). bfloat16 has no numpy
    dtype: it is stored as same-width unsigned ints, as the reference
    stores it, and the manifest records the true dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype_name: str, template) -> Any:
    """The saved array as the template leaf's kind: a tensor on the
    template's device and dtype, or a numpy array."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(template, torch.Tensor):
        return t.to(device=template.device, dtype=template.dtype)
    want = np.asarray(template).dtype
    return (t.float() if dtype_name == "bfloat16" else t).numpy() \
        .astype(want)


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    metadata: Optional[dict] = None, *,
                    blocking: bool = True,
                    host_index: int = 0) -> "SaveHandle":
    """Write ``tree`` under ``directory/step_<step>``; returns a handle
    (``.wait()`` joins the writer thread)."""
    directory = Path(directory)
    stepdir = directory / f"step_{step:08d}"
    tmpdir = directory / f".tmp_step_{step:08d}"
    # copy to host memory first: the caller may overwrite its tensors next
    host = {k: _to_host(v) for k, v in _items(tree)}

    def write():
        tmpdir.mkdir(parents=True, exist_ok=True)
        manifest = {
            "step": step,
            "treedef": type(tree).__name__,
            "keys": sorted(host),
            "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
            "dtypes": {k: dt for k, (_, dt) in host.items()},
            "metadata": metadata or {},
            "written_at": time.time(),
        }
        (tmpdir / "manifest.json").write_text(json.dumps(manifest, indent=1))
        np.savez(tmpdir / f"shard_{host_index}.npz",
                 **{k: a for k, (a, _) in host.items()})
        if stepdir.exists():
            shutil.rmtree(stepdir)
        tmpdir.rename(stepdir)           # atomic publish

    if blocking:
        write()
        return SaveHandle(None, stepdir)
    th = threading.Thread(target=write, daemon=True)
    th.start()
    return SaveHandle(th, stepdir)


class SaveHandle:
    def __init__(self, thread: Optional[threading.Thread], path: Path):
        self._thread = thread
        self.path = path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()


def load_checkpoint(directory: str | Path, template: Any, *,
                    step: Optional[int] = None,
                    shardings: Any = None) -> tuple[Any, dict]:
    """Restore the latest (or a specific) step into ``template``'s
    structure; returns ``(tree, metadata | {"step": step})``.
    ``shardings``: a matching tree of `NamedSharding`s that places every
    leaf on its mesh (on the template leaf's device)."""
    directory = Path(directory)
    if step is None:
        steps = sorted(directory.glob("step_*"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        stepdir = steps[-1]
    else:
        stepdir = directory / f"step_{step:08d}"
    manifest = json.loads((stepdir / "manifest.json").read_text())
    arrays: dict[str, np.ndarray] = {}
    for shard in sorted(stepdir.glob("shard_*.npz")):
        with np.load(shard) as z:
            arrays.update({k: z[k] for k in z.files})
    shards = [s for _, s in _items(shardings)] if shardings is not None \
        else None
    leaves = []
    for i, (key, leaf) in enumerate(_items(template)):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        want = tuple(np.shape(leaf))
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint {arr.shape} != {want}")
        if shards is None:
            leaves.append(_from_host(arr, manifest["dtypes"][key], leaf))
            continue
        full = _from_host(arr, manifest["dtypes"][key], leaf.new_empty(
            (), device="cpu"))
        sh = shards[i]
        leaves.append(distribute(full, sh.mesh, sh.placements, leaf.device)
                      if sh.mesh.get_coordinate() is not None else None)
    return _rebuild(template, iter(leaves)), \
        manifest["metadata"] | {"step": manifest["step"]}


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; one in-flight async save."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._pending: Optional[SaveHandle] = None
        self.last_save_s: float = 0.0
        self.last_restore_s: float = 0.0

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             *, blocking: bool = False) -> SaveHandle:
        if self._pending is not None:
            self._pending.wait()
        t0 = time.perf_counter()
        handle = save_checkpoint(self.directory, step, tree, metadata,
                                 blocking=blocking)
        self.last_save_s = time.perf_counter() - t0
        self._pending = None if blocking else handle
        self._gc()
        return handle

    def restore(self, template: Any, *, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, dict]:
        self.wait()
        t0 = time.perf_counter()
        out = load_checkpoint(self.directory, template, step=step,
                              shardings=shardings)
        self.last_restore_s = time.perf_counter() - t0
        return out

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = sorted(self.directory.glob("step_*"))
        return int(steps[-1].name.split("_")[1]) if steps else None

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.wait()
            self._pending = None
            self._gc()       # prune only after every rename has landed

    def _gc(self) -> None:
        steps = sorted(self.directory.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)
