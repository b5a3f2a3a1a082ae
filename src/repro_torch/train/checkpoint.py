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

On a mesh (``shardings``: a tree of ``distributed.sharding.
NamedSharding``, ``to_named(mesh, train_shardings(...))``), ``save``
gathers each leaf to full size and rank 0 alone writes it, in the same
format and with the same hashes as a single-device save; ``restore``
gives each rank its piece of every saved leaf, whatever mesh wrote it
(the resharding of an elastic restart).  Without shardings each leaf
lands on the device of the leaf it replaces.

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
    """The first 16 hex digits of the sha256 of the array's bytes (read
    in place: no copy of a contiguous array)."""
    return hashlib.sha256(memoryview(np.ascontiguousarray(arr))
                          ).hexdigest()[:16]


def save(tree: Any, directory: str, step: int,
         shardings: Any = None) -> str:
    """Synchronous save of a tree of tensors or numpy arrays.  Returns
    the checkpoint's path.  With ``shardings`` (``tree`` holds this
    rank's pieces) every rank joins the gathers, rank 0 writes the full
    leaves, and all return once the manifest is published."""
    if shardings is not None:
        return _save_sharded(tree, directory, step, shardings)
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


def _save_sharded(tree: Any, directory: str, step: int,
                  shardings: Any) -> str:
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    named = flatten(shardings)
    host = {}
    with torch.no_grad():
        for name, leaf in flatten(tree).items():
            if isinstance(leaf, torch.Tensor):
                sh = named[name]
                leaf = shd.gather_leaf(leaf, sh.mesh, sh.spec).cpu()
            host[name] = leaf
    path = str(Path(directory) / f"step_{step:08d}")
    if dist.get_rank() == 0:
        path = save(host, directory, step)
    dist.barrier()
    return path


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
            shardings: Any = None, verify: bool = True) -> Any:
    """Restore into the structure of ``tree_like`` (the latest step by
    default); each leaf lands on the device of the leaf it replaces.
    ``shardings``: a ``NamedSharding`` tree for the TARGET mesh; each
    rank keeps its piece of every full saved leaf.  Raises ``IOError``
    on a leaf whose bytes do not match its hash."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    shards: Dict[str, Any] = {}
    named = flatten(shardings) if shardings is not None else {}
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
            out[name] = _leaf(arr, meta["dtype"], like, named.get(name))
    finally:
        for f in shards.values():
            f.close()
    return unflatten(out, tree_like)


def _leaf(arr: np.ndarray, dtype_name: str, like, sharding):
    """A restored leaf: the Python number ``like`` is, or a tensor (this
    rank's piece under ``sharding``) on ``like``'s device."""
    dtype = getattr(torch, dtype_name)
    t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
    if dtype in _VIEW_AS:
        t = t.view(_VIEW_AS[dtype][0]).view(dtype)
    if isinstance(like, (int, float)):
        return type(like)(t.item())
    if sharding is not None:
        from repro_torch.distributed.sharding import shard_leaf
        t = shard_leaf(sharding.mesh, t, sharding.spec)
    return t.to(like.device if isinstance(like, torch.Tensor) else "cpu")


def prune_old(directory: str, keep: int = 3) -> None:
    for s in steps(directory)[:-keep]:
        shutil.rmtree(Path(directory) / f"step_{s:08d}", ignore_errors=True)
