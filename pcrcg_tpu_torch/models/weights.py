"""Weights carried across from the JAX package, and reference 2D-backbone
checkpoints.

``state_dict_from_jax`` turns the JAX ``KPFCNN`` variables (a nested dict
of numpy arrays, ``{"params", "constants"}``) into this package's
``KPFCNN.state_dict()``, kernel points included, with the transposes of
``pcrcg_tpu/models/torch_import.py::export_kpfcnn_state_dict``: flax Dense
kernels [in, out] become Linear weights [out, in] (or 1x1 conv weights
[out, in, 1] / [out, in, 1, 1]).  ``pcrcg_state_dict_from_jax`` does the
same for the JAX ``PCRCG`` (``params`` under ``lift/backbone2d`` and
``kpfcnn``, ``batch_stats`` under ``lift/backbone2d``, ``constants``):
flax conv kernels HWIO become OIHW, BN ``scale`` / ``bias`` become
``weight`` / ``bias`` and ``mean`` / ``var`` the running statistics.
Both results load with ``strict=True``.

``load_backbone2d`` is the counterpart of ``torch_import.py::
load_backbone2d`` / ``import_torch_resunet``: a reference torch ResNet or
Res50UNet checkpoint (torchvision, pri3d, MoCo, DataParallel layouts)
merged into a ``ResUNet`` by name and shape, with a report.
``load_kpfcnn`` is the counterpart of ``torch_import.py::load_kpfcnn``: a
reference KPFCNN checkpoint, whose key layout ``KPFCNN`` keeps, merged
into the model by name and shape (the ``pretrain`` of the ``Trainer``).
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


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


def _leaves(tree: Mapping, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.array(v, np.float32)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX KPFCNN variables -> this package's KPFCNN state dict."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _leaves(variables["params"]):
        _emit(out, path, value)
    for blk, sub in variables.get("constants", {}).items():
        out[f"encoder_blocks.{blk.split('_')[1]}.KPConv.kernel_points"] = np.array(
            sub["KPConv"]["kernel_points"], np.float32
        )
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _resunet_module(path: tuple) -> str:
    """A flax ResUNet module path -> the torch module path."""
    if path[0] != "encoder":
        return "decoder." + ".".join(path)
    if not path[1].startswith("layer"):
        return path[1]
    stage, block = path[1].split("_")
    sub = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(path[2],
                                                                                 path[2])
    return f"{stage}.{block}.{sub}"


def resunet_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """JAX ResUNet ``params`` and ``batch_stats`` -> ``ResUNet.state_dict()``."""
    leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "mean": "running_mean", "var": "running_var"}
    out = {}
    for tree in (params, batch_stats):
        for path, value in _leaves(tree):
            if path[-1] == "kernel":  # HWIO -> OIHW
                value = value.transpose(3, 2, 0, 1)
            out[f"{_resunet_module(path[:-1])}.{leaf_name[path[-1]]}"] = value
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def pcrcg_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PCRCG variables -> this package's ``PCRCG.state_dict()``."""
    params = variables["params"]
    kp = {"params": params["kpfcnn"], "constants": variables.get("constants", {})["kpfcnn"]}
    out = {f"kpfcnn.{k}": v for k, v in state_dict_from_jax(kp).items()}
    if "lift" in params:
        bb = resunet_state_dict_from_jax(params["lift"]["backbone2d"],
                                         variables["batch_stats"]["lift"]["backbone2d"])
        out.update((f"lift.backbone2d.{k}", v) for k, v in bb.items())
    return out


# Wrapper prefixes of real-world checkpoints, stripped in this order:
# DataParallel, pri3d (reference trainer.py:14-21), MoCo v2's query
# encoder (its momentum 'encoder_k.' is kept, so it is skipped), SimCLR /
# SwAV wrappers, the reference Res50UNet's encoder.
_PREFIXES = ("module.", "backbone.", "model.", "encoder_q.", "convnet.", "encoder.", "rgb_net.")


def _strip_prefix(key: str) -> str:
    for p in _PREFIXES:
        if key.startswith(p):
            key = key[len(p):]
    return key


def import_backbone2d_state_dict(state_dict: Mapping, backbone: nn.Module) -> dict:
    """Merge a torch ResNet / Res50UNet state dict into ``backbone`` (a
    ``ResUNet``) in place: prefixes stripped, ``fc.*`` and
    ``num_batches_tracked`` dropped, a tensor loaded where its name exists
    with the same shape, else skipped (the reference's shape-filtered
    ``load_state_dict(strict=False)``).  -> {loaded, skipped, skipped_keys}."""
    own = backbone.state_dict()
    loaded, skipped = [], []
    with torch.no_grad():
        for key, tensor in state_dict.items():
            k = _strip_prefix(key)
            if k.startswith("fc.") or k.endswith("num_batches_tracked") or k not in own:
                skipped.append(key)
                continue
            value = torch.as_tensor(np.asarray(
                tensor.detach().cpu() if hasattr(tensor, "detach") else tensor, np.float32))
            if tuple(value.shape) != tuple(own[k].shape):
                skipped.append(key)
                continue
            own[k].copy_(value)
            loaded.append(key)
    return {"loaded": len(loaded), "skipped": len(skipped), "skipped_keys": skipped[:20]}


def load_backbone2d(path: str, backbone: nn.Module) -> dict:
    """Load a torch ``.pth`` (the reference's init modes 'pri3d' /
    '3dmatch' / 'image_net', trainer.py:49-70) into ``backbone``; the
    state dict may sit under 'state_dict', 'model' or 'model_state_dict'.
    Tensors and plain containers only (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return import_backbone2d_state_dict(ckpt, backbone)


def import_kpfcnn_state_dict(state_dict: Mapping, model: nn.Module) -> dict:
    """Merge a reference-format torch KPFCNN state dict (the layout of
    ``KPFCNN.state_dict()``, kernel points included) into ``model`` in
    place, the reference's ``load_state_dict(strict=False)`` pretrain flow
    (lib/trainer.py:163-184): a 'module.' prefix stripped, running
    statistics and ``num_batches_tracked`` skipped, a tensor loaded where
    its name exists with the same shape.  -> {loaded, skipped, errors}:
    errors name checkpoint tensors that matched nothing and model tensors
    the checkpoint did not hold."""
    own = model.state_dict()
    loaded, skipped, errors = [], [], []
    with torch.no_grad():
        for key, tensor in state_dict.items():
            k = key[len("module."):] if key.startswith("module.") else key
            if k.endswith("num_batches_tracked") or ".running_" in k:
                skipped.append(key)
                continue
            value = torch.as_tensor(np.asarray(
                tensor.detach().cpu() if hasattr(tensor, "detach") else tensor, np.float32))
            if k not in own or tuple(value.shape) != tuple(own[k].shape):
                errors.append(f"no match/shape for: {key}")
                continue
            own[k].copy_(value)
            loaded.append(k)
    errors.extend(f"not in checkpoint: {k}" for k in own if k not in set(loaded))
    return {"loaded": len(loaded), "skipped": len(skipped), "errors": errors}


def load_kpfcnn(path: str, model: nn.Module) -> dict:
    """Load a reference torch KPFCNN checkpoint file (its state dict may sit
    under 'state_dict', 'model' or 'model_state_dict') into ``model`` with
    ``import_kpfcnn_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return import_kpfcnn_state_dict(ckpt, model)
