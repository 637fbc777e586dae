"""The mesh and the placement of a pair batch on it (counterpart of
``pcrcg_tpu/parallel/mesh.py``).

The JAX mesh has a 'data' axis (pairs) and a 'model' axis (the two clouds
of a pair over two devices, through GSPMD).  Here the mesh is the ranks of
``torch.distributed`` (``parallel/multihost.py``): each rank takes its rows
of the pair axis and, with ``n_model = 2``, its cloud of each pair
(``parallel/cloud.py``: the model runs one cloud a rank and exchanges what
couples the clouds); parameters and optimizer state are the same on every
rank (broadcast from rank 0), and the step reduces gradients and stats
itself (``train/step.py::train_step_dp``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from pcrcg_tpu_torch.parallel.multihost import (
    DataMesh, cloud_mesh, global_data_mesh, host_local_batch_slice,
)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> DataMesh:
    """The ``(n_data, n_model)`` mesh over every rank: ``n_model`` 1 (pure
    data parallelism) or 2 (the cloud axis; collective, see
    ``multihost.cloud_mesh``), ``n_data`` by default the rest.  Raises
    ``ValueError`` for another ``n_model`` or when ``n_data · n_model`` is
    not the number of ranks."""
    if n_model not in (1, 2):
        raise ValueError(f"n_model={n_model}: a pair has two clouds, so the cloud ('model') "
                         "axis has 1 or 2 ranks")
    mesh = global_data_mesh(device)
    n_data = mesh.world_size // n_model if n_data is None else n_data
    if n_data * n_model != mesh.world_size:
        raise ValueError(f"n_data={n_data} x n_model={n_model}, but the run has "
                         f"{mesh.world_size} rank(s): one process a device (python -m "
                         "pcrcg_tpu_torch.main starts them, or torchrun --nproc-per-node)")
    return mesh if n_model == 1 else cloud_mesh(n_model, device)


def _shard(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """This rank's rows of a leaf and, on the cloud axis, its cloud of a
    leaf whose axis 1 is the pair's two clouds (JAX's ``spec[1] =
    'model'``)."""
    x = x[host_local_batch_slice(x.shape[0], mesh)]
    if mesh.cloud is not None and x.dim() >= 2 and x.shape[1] == mesh.cloud.size:
        x = x[:, mesh.cloud.index:mesh.cloud.index + 1]
    return x


def shard_pair_batch(batch, mesh: DataMesh):
    """This rank's shard of a ``PairBatch`` (every leaf has the pair axis
    first; raw clouds and extras included)."""
    return batch.map(lambda x: _shard(x, mesh))


def shard_images(images: Optional[dict], mesh: DataMesh, batch_size: int) -> Optional[dict]:
    """This rank's shard of the per-pair image dict: leaves whose leading
    axis is the pair batch shard as ``shard_pair_batch`` does (the cloud
    axis keeps its cloud's images), anything else (a shared intrinsics)
    replicates."""
    if images is None:
        return None
    return {k: (_shard(v, mesh) if v.dim() >= 1 and v.shape[0] == batch_size else v)
            for k, v in images.items()}


def replicate(obj, mesh: Optional[DataMesh] = None):
    """Make parameters, buffers and optimizer state the same on every rank:
    rank 0's, broadcast.  ``obj``: an ``nn.Module`` or a ``TrainState``
    (model, optimizer state and the gradient accumulator).  Returns it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    tensors = []
    model = getattr(obj, "model", obj)
    tensors += [t.data for t in model.parameters()] + list(model.buffers())
    optimizer = getattr(obj, "optimizer", None)
    if optimizer is not None:
        for state in optimizer.state.values():
            tensors += [v for v in state.values() if torch.is_tensor(v)]
    tensors += [a for a in (getattr(obj, "_acc", None) or [])]
    nccl = dist.get_backend() == "nccl"
    with torch.no_grad():
        for t in tensors:
            if nccl and t.device.type != "cuda":  # e.g. Adam's step count
                on_card = t.to(torch.cuda.current_device())
                dist.broadcast(on_card, src=0)
                t.copy_(on_card)
            else:
                dist.broadcast(t, src=0)
    return obj
