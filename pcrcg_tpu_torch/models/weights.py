"""Weights carried across from the JAX package.

``state_dict_from_jax`` turns the JAX ``KPFCNN`` variables (a nested dict
of numpy arrays, ``{"params", "constants"}``) into this package's
``KPFCNN.state_dict()``, kernel points included, with the transposes of
``pcrcg_tpu/models/torch_import.py::export_kpfcnn_state_dict``: flax Dense
kernels [in, out] become Linear weights [out, in] (or 1x1 conv weights
[out, in, 1] / [out, in, 1, 1]).  The result loads with ``strict=True``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _emit(out: Dict[str, np.ndarray], path, value: np.ndarray) -> None:
    head = path[0]
    if head.startswith(("encoder_", "decoder_")):
        i = head.split("_")[1]
        blk = ("encoder_blocks." if head[0] == "e" else "decoder_blocks.") + i
        rest = path[1:]
        if rest in (("KPConv", "weights"), ("KPConv", "kernel_points")):
            out[f"{blk}.KPConv.{rest[1]}"] = value
        elif rest[-2:] == ("mlp", "kernel"):
            out[f"{blk}.{'.'.join(rest[:-2] + ('mlp',))}.weight"] = value.T
        else:
            raise KeyError("/".join(path))
    elif head in ("bottle", "proj_gnn", "proj_score", "node_overlap_predict"):
        out[f"{head}.weight" if path[1] == "kernel" else f"{head}.bias"] = (
            value.T[:, :, None] if path[1] == "kernel" else value
        )
    elif head == "epsilon":
        out["epsilon"] = value
    elif head == "gnn":
        i = path[1].split("_")[1]
        if path[1].startswith("self_"):
            out[f"gnn.layers.{i}.{path[2]}.weight"] = value.T[:, :, None, None]
        else:
            if path[2] == "attn":
                mod = {"proj_q": "attn.proj.0", "proj_k": "attn.proj.1",
                       "proj_v": "attn.proj.2", "merge": "attn.merge"}[path[3]]
                leaf = path[4]
            else:
                mod, leaf = {"mlp1": "mlp.0", "mlp2": "mlp.3"}[path[2]], path[3]
            if leaf == "kernel":
                out[f"gnn.layers.{i}.{mod}.weight"] = value.T[:, :, None]
            else:
                out[f"gnn.layers.{i}.{mod}.bias"] = value
    elif head.startswith("folding1_"):
        k = int(head.split("_")[1]) * 2
        leaf = "weight" if path[1] == "kernel" else "bias"
        out[f"folding1.{k}.{leaf}"] = value.T if leaf == "weight" else value
    elif head in ("linear1", "linear2"):
        leaf = "weight" if path[1] == "kernel" else "bias"
        out[f"{head}.{leaf}"] = value.T if leaf == "weight" else value
    else:
        raise KeyError("/".join(path))


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX KPFCNN variables -> this package's KPFCNN state dict."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                _emit(out, path + (k,), np.asarray(v, np.float32))

    walk(variables["params"], ())
    for blk, sub in variables.get("constants", {}).items():
        out[f"encoder_blocks.{blk.split('_')[1]}.KPConv.kernel_points"] = np.asarray(
            sub["KPConv"]["kernel_points"], np.float32
        )
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
