"""Minimal but real checkpointing: a tree of tensors <-> flat-key .npz.

Port of ``repro/checkpoint/checkpoint.py``, with the reference's file keys
letter for letter, so a checkpoint written by either package restores in
the other:

* a tree is nested dicts, tuples, lists and NamedTuples whose leaves are
  tensors, numpy arrays or Python numbers (``None`` holds no leaf);
* a key joins the path's parts with ``|``: a dict key as its string, with
  each ``/`` of the port's flat ``{path: tensor}`` keys as ``|`` (the port's
  ``layers/attn_wq`` is the reference's nested ``layers|attn_wq``), a tuple
  or list index as its number, a NamedTuple field as ``.name`` (an Adam
  state is ``opt|.step``, ``opt|.slots|0|layers|w``, ...);
* bf16 is widened to f32 in the file (.npz has no bf16); ``restore``
  narrows each leaf back to the template's dtype and puts it on the
  template's device;
* the write is atomic (a temp file with a ``.npz`` suffix, then
  ``os.replace``), so an interrupted save never corrupts the latest
  checkpoint.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step"]

_SEP = "|"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's key strings."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k).replace("/", _SEP),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()        # .npz cannot hold bf16; restore narrows back
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(path: str, step: int, tree: Any) -> str:
    """Write ``<path>/ckpt_<step>.npz`` atomically; returns the file path."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"ckpt_{step:08d}.npz")
    flat: Dict[str, np.ndarray] = {k: _to_numpy(leaf) for k, leaf in _leaves(tree)}
    # suffix must be .npz: np.savez appends it otherwise, and the rename
    # would move an empty file
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f))]
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)
    return arr


def _rebuild(tree: Any, data, path: Tuple[str, ...] = ()) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, data, path + (str(k).replace("/", _SEP),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, n), data, path + (f".{n}",))
                            for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, data, path + (str(i),)) for i, v in enumerate(tree))
    return _restore_leaf(data[_SEP.join(path)], tree)


def restore(path: str, step: int, template: Any) -> Any:
    """Load ``ckpt_<step>.npz`` into the structure of ``template``: each
    leaf in the template leaf's dtype, on its device."""
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as data:
        return _rebuild(template, data)
