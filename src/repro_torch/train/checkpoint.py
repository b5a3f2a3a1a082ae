"""Content-hashed checkpoints of the port's parameter trees; port of
``repro.train.checkpoint``.

Layout on disk, the reference's:
  <dir>/step_<N>/manifest.json        tree paths, shapes, dtypes, each
                                      leaf's shard and sha256 hash
  <dir>/step_<N>/shard_0_<i>.npz      leaf arrays, at most 64 a file
                                      (the reference's host-0 names)

  * atomic publish: the manifest is written last, to a temp file then
    renamed, so a crash mid-save never leaves a manifest naming missing
    shards;
  * content hashes: a corrupt or truncated shard is refused at restore;
  * async save: ``save_async`` copies the leaves to host memory at once
    and writes them on a daemon thread.

The reference also reshards at restore, onto the target mesh of an
elastic restart; one card has no mesh, so ``restore`` takes no
shardings and puts each leaf on the device of the leaf it replaces.

A tree is nested dicts, lists, tuples and named tuples of tensors (the
port's parameter trees, ``convert``; ``(params, optim.adam.AdamState)``);
:func:`flatten` names each leaf by its "/"-joined path, as the
reference's ``_tree_paths`` does (dict keys sorted, list indices, named
tuple fields by name), and :func:`unflatten` puts a flat dict back into
a tree's structure.  A Python int or float leaf (``AdamState.step``) is
saved as a 0-d array and restored as the Python number it replaces.
The optimiser (``optim.adam``) runs over the flat view.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# a dtype numpy cannot hold, stored as a same-width integer view; the
# manifest keeps the true dtype
_VIEW_AS = {torch.bfloat16: (torch.int16, np.uint16)}


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / lists -> {"a/0/b": leaf}, in the reference's leaf
    order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):                    # a named tuple
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: Dict[str, Any], like: Any, prefix: str = "") -> Any:
    """The structure of ``like`` with its leaves taken from ``flat`` by
    path."""
    if isinstance(like, dict):
        return {k: unflatten(flat, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if hasattr(like, "_fields"):                      # a named tuple
        return type(like)(*(unflatten(flat, v, f"{prefix}/{k}" if prefix
                                      else k)
                            for k, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(flat, v, f"{prefix}/{i}" if prefix
                                    else str(i))
                          for i, v in enumerate(like))
    return flat[prefix]


def _to_host(leaf) -> np.ndarray:
    """A tensor or array leaf -> a numpy copy (integer view for dtypes
    numpy lacks), with its dtype name."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype in _VIEW_AS:
        return t.view(_VIEW_AS[t.dtype][0]).numpy().view(_VIEW_AS[t.dtype][1])
    return t.numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def save(tree: Any, directory: str, step: int) -> str:
    """Synchronous save of a tree of tensors or numpy arrays.  Returns
    the checkpoint's path."""
    ckpt = Path(directory) / f"step_{step:08d}"
    ckpt.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    by_shard: Dict[str, Dict[str, np.ndarray]] = {}
    for i, (name, leaf) in enumerate(flatten(tree).items()):
        arr = _to_host(leaf)
        key, shard = f"a{i}", f"shard_0_{i // 64}.npz"
        manifest["leaves"][name] = {
            "key": key, "shape": list(arr.shape), "dtype": _dtype_name(leaf),
            "sha": _sha(arr), "shard": shard}
        by_shard.setdefault(shard, {})[key] = arr
    for fname, group in by_shard.items():
        np.savez(ckpt / (fname + ".tmp"), **group)
        os.replace(ckpt / (fname + ".tmp.npz"), ckpt / fname)
    tmp = ckpt / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest))
    os.replace(tmp, ckpt / "manifest.json")      # atomic publish
    return str(ckpt)


_save_threads: List[threading.Thread] = []
_save_lock = threading.Lock()


def save_async(tree: Any, directory: str, step: int) -> threading.Thread:
    """Copy the leaves to host memory now; write them on a thread."""
    host = {name: leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf)
            for name, leaf in flatten(tree).items()}
    t = threading.Thread(target=save, args=(host, directory, step),
                         daemon=True)
    with _save_lock:
        _save_threads.append(t)
    t.start()
    return t


def wait_pending_saves() -> None:
    with _save_lock:
        threads = list(_save_threads)
        _save_threads.clear()
    for t in threads:
        t.join()


def steps(directory: str) -> List[int]:
    """The published steps under ``directory`` (those with a manifest),
    in order."""
    d = Path(directory)
    if not d.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in d.iterdir()
                  if p.name.startswith("step_")
                  and (p / "manifest.json").exists())


def latest_step(directory: str) -> Optional[int]:
    published = steps(directory)
    return published[-1] if published else None


def restore(tree_like: Any, directory: str, step: Optional[int] = None,
            verify: bool = True) -> Any:
    """Restore into the structure of ``tree_like`` (the latest step by
    default); each leaf lands on the device of the leaf it replaces.
    Raises ``IOError`` on a leaf whose bytes do not match its hash."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    shards: Dict[str, Any] = {}
    out = {}
    try:
        for name, like in flatten(tree_like).items():
            meta = manifest["leaves"][name]
            if meta["shard"] not in shards:
                shards[meta["shard"]] = np.load(ckpt / meta["shard"])
            arr = shards[meta["shard"]][meta["key"]]
            if verify and _sha(arr) != meta["sha"]:
                raise IOError(f"checkpoint corruption in {name} "
                              f"({meta['shard']})")
            dtype = getattr(torch, meta["dtype"])
            t = torch.from_numpy(np.array(arr))
            if dtype in _VIEW_AS:
                t = t.view(_VIEW_AS[dtype][0]).view(dtype)
            if isinstance(like, (int, float)):
                out[name] = type(like)(t.item())
            else:
                out[name] = t.to(like.device if isinstance(
                    like, torch.Tensor) else "cpu")
    finally:
        for f in shards.values():
            f.close()
    return unflatten(out, tree_like)


def prune_old(directory: str, keep: int = 3) -> None:
    for s in steps(directory)[:-keep]:
        shutil.rmtree(Path(directory) / f"step_{s:08d}", ignore_errors=True)
