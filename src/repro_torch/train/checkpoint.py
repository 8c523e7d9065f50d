"""Atomic, optionally asynchronous checkpoints of a tree of tensors (the
JAX package's ``train/checkpoint.py``, on PyTorch).

Layout (one directory per step), the JAX package's::

    <dir>/step_00000420/
        manifest.json        # treedef, shapes, dtypes, step, write-complete
        leaf_00000.npy ...   # one file per leaf

* **atomic** — written to ``step_XXXXXXXX.tmp/`` then ``os.rename``d; a
  crash in the middle of a write never corrupts the latest checkpoint.
* **leaf order** — the leaves are numbered as ``jax.tree_util`` flattens:
  dicts in sorted-key order, lists and tuples in order.  So a template
  whose dicts were built in another order restores each leaf under its own
  key, and a checkpoint of f32/f64 leaves written by the JAX package
  restores here, and the reverse.
* **snapshot** — ``save`` copies every leaf to host memory before it
  returns, also with ``blocking=False``: the port's optimizer and engine
  advance tensors in place, and a later write must not reach the
  checkpoint.  A CPU tensor is cloned (its ``.numpy()`` would share its
  memory).
* **async** — ``save(..., blocking=False)`` hands the file writes to a
  daemon thread; at most one write is outstanding (the next ``save`` or
  ``wait`` joins it and raises its error, if any).
* **leaf types** — tensors, numpy arrays and Python numbers (the train
  state's ``"step"`` is an ``int``); numpy has no bfloat16, so a bf16
  tensor is stored as its ``uint16`` bits with ``"bfloat16"`` in the
  manifest's ``dtypes`` and viewed back on restore.
* **restore** — each leaf becomes a fresh tensor on the template leaf's
  device and in its dtype (never an alias of the template); numbers come
  back as the template's Python type.
* **elastic** — a ``sharding.ShardedTensor`` leaf is saved whole (its
  shards joined on the host), as the JAX package saves a sharded array;
  ``restore(..., shardings=)`` splits each leaf onto the mesh its
  ``NamedSharding`` names, which need not be the mesh (or the lack of
  one) that wrote the checkpoint.

``STATS`` sums what the saves and restores since ``reset_stats`` moved and
took: bytes, the snapshot (device to host) and the file writes of each
save, the reads and the placement of each restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import ShardedTensor, _put

_PENDING: Optional[threading.Thread] = None
_PENDING_ERROR: List[BaseException] = []

#: totals since ``reset_stats``: ``saves`` / ``save_bytes`` /
#: ``snapshot_s`` (leaves copied to host memory) / ``write_s`` (files
#: written, in the writer thread for an async save), ``restores`` /
#: ``restore_bytes`` / ``read_s`` (files read) / ``place_s`` (tensors made
#: on the template's device)
STATS: Dict[str, float] = {
    "saves": 0, "save_bytes": 0, "snapshot_s": 0.0, "write_s": 0.0,
    "restores": 0, "restore_bytes": 0, "read_s": 0.0, "place_s": 0.0}


def reset_stats() -> None:
    """Zero ``STATS``."""
    for k in STATS:
        STATS[k] = 0 if isinstance(STATS[k], int) else 0.0


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def flatten(tree) -> Tuple[list, str]:
    """(leaves, treedef string) with dicts in sorted-key order, as
    ``jax.tree_util.tree_flatten`` orders them; ``None`` is an empty
    subtree."""
    leaves: list = []

    def walk(x):
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}" for k in sorted(x)) + "}"
        if isinstance(x, (list, tuple)):
            inner = ", ".join(walk(v) for v in x)
            return f"[{inner}]" if isinstance(x, list) else f"({inner},)"
        if x is None:
            return "None"
        leaves.append(x)
        return "*"
    return leaves, walk(tree)


def unflatten(template, leaves):
    """``template``'s structure (its dicts in their own key order) with the
    leaves taken in ``flatten``'s order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            vals = {k: build(x[k]) for k in sorted(x)}
            return {k: vals[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if x is None:
            return None
        return next(it)
    return build(template)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` as numpy, its dtype name for the manifest)."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
            return bits, "bfloat16"
        a = t.to("cpu", copy=True).numpy()
    else:
        a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _join_pending() -> None:
    global _PENDING
    if _PENDING is not None:
        _PENDING.join()
        _PENDING = None
    if _PENDING_ERROR:
        err = _PENDING_ERROR.pop()
        raise RuntimeError(f"async checkpoint write failed: {err}") from err


def save(ckpt_dir: str, step: int, state, blocking: bool = True) -> str:
    """Write ``state`` (a tree of tensors, arrays and numbers) for
    ``step``; returns the step's directory.  Every leaf is on the host
    before this returns; with ``blocking=False`` the files are written by a
    background thread (``wait`` joins it)."""
    global _PENDING
    _join_pending()               # one outstanding async write at most

    leaves, treedef = flatten(state)
    t0 = time.perf_counter()
    host = [_to_host(l) for l in leaves]
    STATS["snapshot_s"] += time.perf_counter() - t0
    STATS["saves"] += 1
    STATS["save_bytes"] += sum(a.nbytes for a, _ in host)

    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"

    def write():
        t1 = time.perf_counter()
        os.makedirs(tmp, exist_ok=True)
        for i, (a, _) in enumerate(host):
            np.save(os.path.join(tmp, _leaf_name(i)), a)
        manifest = {
            "step": int(step),
            "n_leaves": len(host),
            "treedef": treedef,
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [dt for _, dt in host],
            "complete": True,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        STATS["write_s"] += time.perf_counter() - t1

    def write_async():
        try:
            write()
        except BaseException as e:  # re-raised by the next save or wait
            _PENDING_ERROR.append(e)

    if blocking:
        write()
    else:
        _PENDING = threading.Thread(target=write_async, daemon=True)
        _PENDING.start()
    return final


def wait() -> None:
    """Block until an async save has landed; raise its error, if any."""
    _join_pending()


def steps(ckpt_dir: str) -> List[int]:
    """The complete checkpoints' steps, ascending (``.tmp`` directories
    and directories without a manifest are ignored)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    s = steps(ckpt_dir)
    return s[-1] if s else None


def _host_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


def _place(arr: np.ndarray, dtype_name: str, like, shard=None):
    """The stored leaf as ``like``'s kind: a fresh tensor on its device and
    in its dtype, a numpy array of its dtype, or a Python number; split
    onto a mesh by ``shard`` (a ``NamedSharding``) where given."""
    if shard is not None and not isinstance(like, (bool, int, float)):
        return _put(_host_tensor(arr, dtype_name), shard, dtype=like.dtype)
    if isinstance(like, ShardedTensor):
        return _put(_host_tensor(arr, dtype_name), like.sharding, dtype=like.dtype)
    if isinstance(like, torch.Tensor):
        return _host_tensor(arr, dtype_name).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    raise TypeError(f"cannot restore a leaf into a {type(like).__name__}")


def restore(ckpt_dir: str, target, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``target`` (a tree of tensors, arrays
    and numbers: each leaf's device, dtype and type; a ``ShardedTensor``
    leaf onto its own sharding); ``step`` None: the latest complete
    checkpoint.  ``shardings``: a matching tree of ``NamedSharding``s, for
    elastic placement on the *current* mesh (which may differ from the
    mesh, or the one device, that wrote the checkpoint); ``target`` then
    gives the dtypes (meta tensors will do, ``train_loop.state_specs``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        raise IOError(f"incomplete checkpoint at {path}")

    t_leaves, _ = flatten(target)
    if manifest["n_leaves"] != len(t_leaves):
        raise ValueError(f"leaf count mismatch: checkpoint {manifest['n_leaves']} "
                         f"vs target {len(t_leaves)}")
    dtypes = manifest.get("dtypes", [None] * len(t_leaves))
    s_leaves = flatten(shardings)[0] if shardings is not None \
        else [None] * len(t_leaves)
    if len(s_leaves) != len(t_leaves):
        raise ValueError(f"{len(s_leaves)} shardings for {len(t_leaves)} leaves")
    out = []
    for i, (t, dt, sh) in enumerate(zip(t_leaves, dtypes, s_leaves)):
        t0 = time.perf_counter()
        arr = np.load(os.path.join(path, _leaf_name(i)))
        t1 = time.perf_counter()
        want = tuple(t.shape) if hasattr(t, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} vs "
                             f"target {want}")
        out.append(_place(arr, dt, t, sh))
        STATS["read_s"] += t1 - t0
        STATS["place_s"] += time.perf_counter() - t1
        STATS["restore_bytes"] += arr.nbytes
    STATS["restores"] += 1
    return unflatten(target, out)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Remove all but the ``keep`` latest complete checkpoints."""
    for s in steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
