"""Start the ranks of a data-parallel run on this host.

``spawn(target, world_size, ...)`` starts ``world_size`` processes (the
``spawn`` start method: each child imports ``target`` by its module and
name, so a target lives in this package) that join one ``torch.distributed``
group through ``parallel/multihost.py::initialize`` and call ``target``.
``main.py`` uses it for ``data_parallel: N`` when no launcher started the
ranks; ``dp_steps`` is the data-parallel step run on a saved batch that the
CPU tests and ``chip_smoke.py`` hold against the single-process step.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.multiprocessing as mp

from pcrcg_tpu_torch.parallel import multihost


def _entry(rank: int, target, world_size: int, init_method: str, device: Optional[str],
           backend: Optional[str], threads: int, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size), COORDINATOR_ADDRESS=init_method)
    torch.set_num_threads(threads)
    multihost.initialize(init_method, world_size, rank, device=device, backend=backend)
    try:
        target(*args)
    finally:
        multihost.shutdown()


def spawn(target, world_size: int, init_method: str, args: tuple = (),
          device: Optional[str] = None, backend: Optional[str] = None,
          timeout: Optional[float] = None) -> None:
    """Run ``target(*args)`` on ``world_size`` ranks of one process group
    (``init_method``: a ``file://`` rendezvous whose file does not exist
    yet, or a ``tcp://`` address).  Returns when every rank has finished;
    raises if one failed, or (ranks terminated) once ``timeout`` seconds
    have passed."""
    # The ranks share the caller's intra-op threads.
    threads = max(1, torch.get_num_threads() // world_size)
    ctx = mp.start_processes(_entry, args=(target, world_size, init_method, device, backend,
                                           threads, args),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
                proc.join()
            raise TimeoutError(f"{world_size} ranks of {target.__name__} still running after "
                               f"{timeout} s")


def dp_steps(payload_path: str, out_path: str) -> None:
    """A rank's part of the data-parallel check: ``payload_path`` (a
    ``torch.save``) holds the config, the model's state dict, the GLOBAL
    batch (CPU), the global draws of each step (``uniforms``: a list of
    [B, N0·corr_k]), ``images`` or None, and optionally ``eval_uniforms``.
    The rank builds the model on its device, takes its shard
    (``parallel/mesh.py``), runs ``eval_step_dp`` on the given weights (with
    ``eval_uniforms``), then ``train_step_dp`` once per entry of
    ``uniforms`` with the kernels' launch counts zeroed just before; it
    writes ``<out_path>.rank<r>``: the eval stats, the stats of every step,
    the parameters after step 1, the launches and host ms a step."""
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.models.pcrcg import PCRCG
    from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
    from pcrcg_tpu_torch.parallel.mesh import make_mesh, replicate, shard_images
    from pcrcg_tpu_torch.parallel.mesh import shard_pair_batch
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import eval_step_dp, train_step_dp

    payload = torch.load(payload_path, weights_only=False)
    cfg = payload["cfg"]
    mesh = make_mesh()
    model = (PCRCG if cfg.image_feature else KPFCNN)(cfg)
    model.load_state_dict(payload["state_dict"])
    model = model.to(mesh.device).eval()
    state = replicate(TrainState(cfg, model), mesh)
    batch = shard_pair_batch(payload["batch"], mesh).map(lambda t: t.to(mesh.device))
    images = payload.get("images")
    if images is not None:
        images = {k: v.to(mesh.device)
                  for k, v in shard_images(images, mesh, payload["batch"].points.shape[0]).items()}
    out = {"stats": [], "ms": []}
    eval_uniforms = payload.get("eval_uniforms")
    if eval_uniforms is not None:  # on the weights as given
        ev = eval_step_dp(state, cfg, batch, uniforms=eval_uniforms, images=images)
        out["eval"] = {k: float(v) for k, v in ev.items()}
    kernels.reset_launches()
    for i, uniforms in enumerate(payload["uniforms"]):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = train_step_dp(state, cfg, batch, uniforms=uniforms, images=images)
        stats = {k: float(v) for k, v in stats.items()}
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["stats"].append(stats)
        if i == 0:
            out["params"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out["launches"] = dict(kernels.LAUNCHES)
    out["rank"], out["world_size"], out["backend"] = mesh.rank, mesh.world_size, mesh.backend
    out["device"] = str(mesh.device)
    torch.save(out, f"{out_path}.rank{mesh.rank}")
