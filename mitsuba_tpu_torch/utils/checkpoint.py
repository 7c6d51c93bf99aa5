"""Checkpoint and resume (port of mitsuba_tpu/utils/checkpoint.py): scene,
parameter and film state.

- The reference's scene serialisation (trimesh.h:192-201 `.serialized`
  dumps, serialization.h:33) -> any tree of the port's dataclasses
  (Scene, its tables, MediumTable), dicts, lists and tuples round-trips
  its tensors and arrays through one zlib-compressed npz; the static
  fields come from the structure passed to `load_pytree`.
- Mid-render resume (the reference has `-x` and SIGHUP's partial film,
  mitsuba.cpp:81-110) -> a film checkpoints as (sum, count), so
  accumulation goes on exactly where it stopped.
"""
from __future__ import annotations

import dataclasses
import io
import zlib

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray)


def _children(tree):
    """(kind, keys, values) of a container, or None for a leaf or a
    static value."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return "dataclass", names, [getattr(tree, k) for k in names]
    if isinstance(tree, dict):
        return "dict", list(tree), list(tree.values())
    if isinstance(tree, (list, tuple)):
        return "seq", None, list(tree)
    return None


def tree_leaves(tree) -> list:
    """The tensors and arrays of a tree, depth first in field order."""
    if _is_leaf(tree):
        return [tree]
    node = _children(tree)
    if node is None:
        return []
    return [leaf for v in node[2] for leaf in tree_leaves(v)]


def _rebuild(like, leaves):
    if _is_leaf(like):
        arr = next(leaves)
        if torch.is_tensor(like):
            return torch.as_tensor(arr, device=like.device)
        return arr
    node = _children(like)
    if node is None:
        return like
    kind, keys, values = node
    new = [_rebuild(v, leaves) for v in values]
    if kind == "dataclass":
        return dataclasses.replace(like, **dict(zip(keys, new)))
    if kind == "dict":
        return type(like)(zip(keys, new))
    if hasattr(like, "_fields"):                # a named tuple
        return type(like)(*new)
    return type(like)(new)


def save_pytree(path: str, tree) -> None:
    """Write every tensor and array of `tree` to one compressed file."""
    leaves = [x.detach().cpu().numpy() if torch.is_tensor(x)
              else np.asarray(x) for x in tree_leaves(tree)]
    buf = io.BytesIO()
    np.savez(buf, *leaves)
    with open(path, "wb") as f:
        f.write(zlib.compress(buf.getvalue(), 6))


def load_pytree(path: str, like):
    """The tree saved by save_pytree, in the structure of `like`, whose
    static fields it keeps and whose tensors' devices it takes (the
    reference's by-name class instantiation on unserialisation)."""
    with open(path, "rb") as f:
        raw = zlib.decompress(f.read())
    data = np.load(io.BytesIO(raw))
    n = len(tree_leaves(like))
    if len(data.files) != n:
        raise ValueError(f"{path} holds {len(data.files)} arrays, the "
                         f"structure given {n}")
    return _rebuild(like, iter(data[f"arr_{i}"] for i in range(n)))


class FilmCheckpoint:
    """An accumulating film that survives interruption: the float64 sum
    of the passes weighted by their spp, and the spp count."""

    def __init__(self, height: int, width: int):
        self.sum = np.zeros((height, width, 3), np.float64)
        self.count = 0

    def add_pass(self, img, spp: int):
        if torch.is_tensor(img):
            img = img.detach().cpu().numpy()
        self.sum += np.asarray(img, np.float64) * spp
        self.count += spp

    @property
    def image(self):
        return (self.sum / max(self.count, 1)).astype(np.float32)

    def save(self, path: str):
        np.savez_compressed(path, sum=self.sum, count=self.count)

    @staticmethod
    def load(path: str) -> "FilmCheckpoint":
        data = np.load(path)
        fc = FilmCheckpoint(*data["sum"].shape[:2])
        fc.sum = data["sum"]
        fc.count = int(data["count"])
        return fc
