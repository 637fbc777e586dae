"""Multi-process data parallelism on ``torch.distributed`` (counterpart of
``pcrcg_tpu/parallel/multihost.py``).

The model is pure data parallelism over pairs, as in the JAX package:
parameters replicate, per-pair work never leaves its device, and only the
gradient and the stats are reduced.  PyTorch's idiom is one process per
device (JAX's is one process over many devices), so a run of N devices is N
ranks:

  1. every process calls :func:`initialize` (a no-op in a single process);
  2. :func:`global_data_mesh` names the ranks (the 'data' axis);
  3. each rank loads only its slice of the global pair batch
     (:func:`host_local_batch_slice`, which ``data/loader.py``, the mesh's
     sharding and the step's draws all take), so raw fragments never cross
     processes.

:func:`cloud_mesh` adds the cloud ('model') axis: ``n_data × n_model``
ranks, rank ``d · n_model + m`` holding cloud ``m`` of the pairs of data
row ``d`` (JAX's row-major ``reshape(n_data, n_model)``), so both ranks
of a row load the same pairs (``parallel/cloud.py``).

``initialize`` reads the JAX package's variables (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``) or torchrun's (``MASTER_ADDR`` /
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).  The backend is
``nccl`` when every rank has a card of its own and ``gloo`` on the CPU; a
run whose ranks share a card must ask for ``gloo`` by name.  The choice is
printed.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from pcrcg_tpu_torch.parallel.cloud import CloudAxis


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of a data-parallel run: the pair batch's 'data' axis and,
    with ``cloud``, the cloud ('model') axis of each pair."""

    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None  # None: a single process, no group
    cloud: Optional[CloudAxis] = None  # None: every rank holds both clouds
    data_group: Any = None  # the ranks holding this rank's cloud (None: every rank)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_model(self) -> int:
        return 1 if self.cloud is None else self.cloud.size

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_model

    @property
    def data_rank(self) -> int:
        """This rank's row of the 'data' axis: which pairs it loads."""
        return self.rank // self.n_model


_MESH: Optional[DataMesh] = None


def _env(*names: str) -> Optional[str]:
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; ``tcp://`` and ``file://``
    addresses as they are."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, backend: Optional[str] = None) -> Optional[DataMesh]:
    """Join the process group of a multi-process run and return its mesh;
    ``None`` (nothing done) in a single process with no coordinator.

    ``device``: the rank's device type, CUDA unless the caller names the
    CPU; a CUDA rank takes card ``LOCAL_RANK`` (the rank, without it) when
    every rank has a card of its own.  ``backend``: ``nccl`` / ``gloo``, by
    default ``nccl`` on cards and ``gloo`` on the CPU.  NCCL takes one rank
    per card: ranks that share a card raise unless ``backend="gloo"`` is
    given (gloo reduces CUDA tensors through the host)."""
    global _MESH
    if dist.is_initialized():
        return _MESH
    address = coordinator_address or _env("COORDINATOR_ADDRESS")
    if address is None and _env("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    world = int(num_processes or _env("NUM_PROCESSES", "WORLD_SIZE") or 1)
    if address is None and world == 1:
        return None  # nothing to coordinate: a plain single-process run
    if address is None:
        raise ValueError(f"{world} processes but no coordinator address: set "
                         "COORDINATOR_ADDRESS or MASTER_ADDR / MASTER_PORT")
    rank = int(process_id if process_id is not None else _env("PROCESS_ID", "RANK") or 0)
    local_rank = int(_env("LOCAL_RANK") or rank)
    local_world = int(_env("LOCAL_WORLD_SIZE") or world)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for gloo on the CPU")
        own_card = torch.cuda.device_count() >= local_world
        if backend is None and not own_card:
            raise RuntimeError(
                f"{local_world} ranks on {torch.cuda.device_count()} card(s): NCCL takes one "
                "rank a card; pass backend='gloo' to let ranks share a card")
        backend = backend or "nccl"
        dev = torch.device("cuda", local_rank if own_card else 0)
        torch.cuda.set_device(dev)
        why = "a card a rank" if own_card else "ranks share a card"
    else:
        backend = backend or "gloo"
        why = "CPU ranks"
    # NCCL binds the rank's card now (its barrier and collectives use it).
    bind = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=_init_method(address), world_size=world,
                            rank=rank, **bind)
    _MESH = DataMesh(world, rank, dev, backend)
    print(f"[multihost] rank {rank} of {world} on {dev}: backend {backend} ({why})", flush=True)
    return _MESH


def shutdown() -> None:
    """Leave the process group (the end of a worker)."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def global_data_mesh(device=None) -> DataMesh:
    """The 'data' mesh over every rank of every host: the initialized
    group's, else this single process on ``device`` (CUDA by default)."""
    if _MESH is not None and dist.is_initialized():
        return _MESH
    if dist.is_initialized():  # a group joined without initialize()
        return DataMesh(dist.get_world_size(), dist.get_rank(),
                        torch.device("cuda" if device is None else device), dist.get_backend())
    return DataMesh(1, 0, torch.device("cuda" if device is None else device))


def cloud_mesh(n_model: int, device=None) -> DataMesh:
    """The ``(n_data, n_model)`` mesh over every rank of the initialized
    group (``n_data = world / n_model``): a model group per data row, a
    data group per model column.  Collective: every rank calls it, in the
    same order (``dist.new_group``)."""
    mesh = global_data_mesh(device)
    if mesh.world_size % n_model != 0:
        raise ValueError(f"{mesh.world_size} rank(s) do not split into n_model={n_model}")
    n_data = mesh.world_size // n_model
    d, m = divmod(mesh.rank, n_model)
    model_groups = [dist.new_group([r * n_model + c for c in range(n_model)])
                    for r in range(n_data)]
    data_groups = [dist.new_group([r * n_model + c for r in range(n_data)])
                   for c in range(n_model)]
    return dataclasses.replace(mesh, cloud=CloudAxis(m, n_model, model_groups[d]),
                               data_group=data_groups[m])


def host_local_batch_slice(global_batch_size: int, mesh: Optional[DataMesh] = None) -> slice:
    """The rows of the GLOBAL pair batch this rank loads (by its data row:
    the ranks of a row's cloud axis load the same pairs)."""
    mesh = mesh or global_data_mesh()
    if global_batch_size % mesh.n_data != 0:
        raise ValueError(f"global batch size {global_batch_size} not divisible by the "
                         f"data-parallel process count {mesh.n_data}")
    per = global_batch_size // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def global_pair_batch(local_tree, mesh: DataMesh, global_batch_size: int):
    """This rank's shard of the global batch, on its device: each leaf's
    leading axis must be the shard's (``global_batch_size / n_data``).  In
    PyTorch the global batch exists only as the ranks' shards, so this
    checks and places the shard (the JAX package assembles a global array
    from them)."""
    per = global_batch_size // mesh.n_data

    def put(x):
        if x is None:
            return None
        if x.shape[0] != per:
            raise ValueError(f"a leaf of {x.shape[0]} rows in a shard of {per}")
        return x.to(mesh.device, non_blocking=True)

    if hasattr(local_tree, "map"):
        return local_tree.map(put)
    return {k: put(v) for k, v in local_tree.items()}
