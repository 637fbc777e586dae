"""Flat-buffer packing of a tree of tensors (counterpart of
``pcrcg_tpu/utils/packing.py``).

``pack_pytree`` folds a nested dict / list / tuple of tensors (a module's
parameters, their gradients, a state dict) into one 1-D buffer per dtype,
and ``unpack`` restores the tree exactly.  The data-parallel step reduces
its gradients this way: one ``all_reduce`` over one flat buffer, in a
fixed layout, instead of one per tensor (``train/step.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch


def _flatten(tree, leaves: List[torch.Tensor]):
    """The tree's structure with each tensor replaced by its leaf index."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return len(leaves) - 1
    if isinstance(tree, Mapping):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    raise TypeError(f"pack_pytree: unsupported leaf {type(tree).__name__}")


def _unflatten(struct, leaves: List[torch.Tensor]):
    if isinstance(struct, int):
        return leaves[struct]
    if isinstance(struct, Mapping):
        return {k: _unflatten(v, leaves) for k, v in struct.items()}
    return type(struct)(_unflatten(v, leaves) for v in struct)


def pack_pytree(tree) -> Tuple[Callable[[Any], Dict[str, torch.Tensor]],
                               Callable[[Dict[str, torch.Tensor]], Any]]:
    """-> (pack, unpack): ``pack(tree)`` -> {dtype name: flat 1-D tensor};
    ``unpack(packed)`` -> the tree (leaves are views of the flat buffers;
    an exact round trip).  Both are bound to this tree's structure, shapes
    and dtypes: ``pack`` raises on a tree that differs."""
    leaves: List[torch.Tensor] = []
    struct = _flatten(tree, leaves)
    specs = [(tuple(t.shape), t.dtype) for t in leaves]
    by_dtype: Dict[str, List[int]] = {}
    for i, (_, dt) in enumerate(specs):
        by_dtype.setdefault(str(dt).replace("torch.", ""), []).append(i)

    def pack(t) -> Dict[str, torch.Tensor]:
        ls: List[torch.Tensor] = []
        if _flatten(t, ls) != struct:
            raise ValueError("pack(): the tree's structure differs from the captured one")
        for i, leaf in enumerate(ls):
            if (tuple(leaf.shape), leaf.dtype) != specs[i]:
                raise ValueError(f"pack(): leaf {i} is {tuple(leaf.shape)} {leaf.dtype}, "
                                 f"captured {specs[i]}")
        return {name: torch.cat([ls[i].reshape(-1) for i in idxs])
                for name, idxs in by_dtype.items()}

    def unpack(packed: Dict[str, torch.Tensor]):
        out: List[torch.Tensor] = [None] * len(specs)  # type: ignore[list-item]
        for name, idxs in by_dtype.items():
            flat, off = packed[name], 0
            for i in idxs:
                shape = specs[i][0]
                n = 1
                for s in shape:
                    n *= s
                out[i] = flat[off:off + n].view(shape)
                off += n
        return _unflatten(struct, out)

    return pack, unpack
