"""Checkpoint and resume of a whole batched run state.

The port's counterpart of ``live_ekf_slam_tpu/utils/checkpoint.py`` (npz
backend): ``save`` writes every tensor of a state tree, such as the
per-tick ``eval.runner.RunCarry``, to an ``.npz`` as ``leaf_{i}`` in the
tree's order; ``restore`` reads them back into the structure of a template
tree, each with its template's shape check, dtype and device, so that a
state saved from the card restores on the CPU and the other way round. A
tree is a tensor (or array), None, a dataclass (the ``StateFields``
containers of ``core/types``), a tuple, a list or a dict of trees.
``save_sharded`` and ``restore_sharded`` are the counterpart of JAX's orbax
pair, which saves sharded arrays: a tree placed on a world mesh
(``parallel/mesh.Shards``) goes to one ``.npz``, shard by shard, and comes
back shard by shard, each on its template's device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def tree_map(tree, fn):
    """``tree`` with every leaf replaced by ``fn(leaf)``, in the tree's order."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(getattr(tree, f.name), fn)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    raise TypeError(f"checkpoint: not a tree of tensors: {type(tree).__name__}")


def leaves(tree) -> list:
    """The tensors of ``tree`` in the order ``save`` numbers them."""
    out = []
    tree_map(tree, out.append)
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree) -> None:
    """Save a tree of tensors to an .npz (host side)."""
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves(tree))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def restore(path: str, like):
    """The tree saved at ``path`` in the structure of ``like``, each leaf
    with its template's dtype on its template's device."""
    data = np.load(path)
    count = iter(range(len(data.files) + 1))

    def one(template):
        i = next(count)
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf {i} shape {tuple(arr.shape)} "
                             f"!= template {tuple(template.shape)}")
        if isinstance(template, torch.Tensor):
            return torch.from_numpy(arr).to(device=template.device,
                                            dtype=template.dtype)
        return arr.astype(template.dtype)

    return tree_map(like, one)


def save_sharded(path: str, shards) -> None:
    """Save a tree placed on a mesh (``parallel.mesh.Shards``) to an .npz:
    shard d's leaves as ``shard{d}_leaf_{i}``, with the shard count and the
    world axis (-1 for a replicated tree)."""
    shards.join()  # read each shard after its stream has written it
    arrays = {f"shard{d}_leaf_{i}": _numpy(leaf)
              for d, part in enumerate(shards.parts)
              for i, leaf in enumerate(leaves(part))}
    axis = shards.placement.axis
    arrays["n_shards"] = np.asarray(len(shards.parts))
    arrays["axis"] = np.asarray(-1 if axis is None else axis)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def restore_sharded(path: str, like):
    """The sharded tree saved at ``path`` in the placement of ``like`` (a
    ``Shards`` of the same mesh size and world axis): shard d's leaves with
    the dtype and on the device of ``like``'s shard d."""
    from live_ekf_slam_tpu_torch.parallel.mesh import Shards

    data = np.load(path)
    axis = like.placement.axis
    saved = (int(data["n_shards"]), int(data["axis"]))
    if saved != (len(like.parts), -1 if axis is None else axis):
        raise ValueError(f"checkpoint of {saved[0]} shards on axis {saved[1]}, "
                         f"template of {len(like.parts)} on axis {axis}")

    def shard(d, template):
        count = iter(range(len(data.files)))

        def one(t):
            i = next(count)
            arr = data[f"shard{d}_leaf_{i}"]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint shard {d} leaf {i} shape "
                                 f"{tuple(arr.shape)} != template {tuple(t.shape)}")
            if isinstance(t, torch.Tensor):
                return torch.from_numpy(arr).to(device=t.device, dtype=t.dtype)
            return arr.astype(t.dtype)
        return tree_map(template, one)

    return Shards([shard(d, p) for d, p in enumerate(like.parts)],
                  like.placement)
