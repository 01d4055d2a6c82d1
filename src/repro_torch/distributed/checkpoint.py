"""Step-atomic checkpointing of numpy state trees (the port of the JAX
package's ``repro.distributed.checkpoint``, same on-disk layout).

Layout:
  <dir>/step_<N>/manifest.json   — tree leaves' paths, shapes, dtypes
  <dir>/step_<N>/arrays.npz      — one entry per leaf (path-keyed)
  <dir>/step_<N>/COMMIT          — written LAST; a step without COMMIT is
                                   an aborted write and is ignored/pruned

A tree is nested dicts (keys sorted, as a pytree flatten orders them),
lists and tuples (by index), with array-like leaves; ``None`` is an empty
subtree.  A leaf's path is its keys joined by ``/``, so a checkpoint
written by either package reads back in the other.  The reference
flattens and rebuilds with ``jax.tree_util``; here a plain recursive walk
does it, and restored leaves are numpy arrays (the streaming service's
state lives on the host).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "prune"]


def _walk(tree, fn: Callable[[str, Any], Any], prefix: Tuple[str, ...] = ()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, prefix + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn("/".join(prefix), tree)


def _flatten(tree) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}

    def put(key, leaf):
        flat[key] = leaf
        return leaf

    _walk(tree, put)
    return flat


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    tree,
    extra: Optional[dict] = None,
) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    dtypes = {k: str(a.dtype) for k, a in arrays.items()}
    # npz can't hold ml_dtypes (bfloat16 etc.) — store bit-views, record
    # the logical dtype in the manifest
    arrays = {
        k: (a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
        for k, a in arrays.items()
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {
            k: {"shape": list(a.shape), "dtype": dtypes[k]}
            for k, a in arrays.items()
        },
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write(str(step))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            continue  # aborted write
        s = int(name.split("_")[1])
        best = s if best is None else max(best, s)
    return best


def restore_checkpoint(
    ckpt_dir: str,
    tree_like,
    step: Optional[int] = None,
) -> Tuple[Any, int, dict]:
    """Restore into the structure of `tree_like` (numpy leaves)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:

        def rebuild(key, leaf):
            arr = data[key]
            want = manifest["leaves"][key]["dtype"]
            if want == "bfloat16" and arr.dtype == np.uint16:
                import ml_dtypes

                arr = arr.view(ml_dtypes.bfloat16)
            return arr

        tree = _walk(tree_like, rebuild)
    return tree, step, manifest.get("extra", {})


def prune(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(ckpt_dir)
        if n.startswith("step_")
        and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, "COMMIT"))
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
    # sweep aborted writes
    for n in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, n)
        if n.endswith(".tmp") or (
            n.startswith("step_") and not os.path.exists(os.path.join(full, "COMMIT"))
        ):
            shutil.rmtree(full, ignore_errors=True)
