"""Start the ranks of a data-parallel run on this host.

``spawn(target, world_size, ...)`` starts ``world_size`` processes (the
``spawn`` start method: each child imports ``target`` by its module and
name, so a target lives in this package) that join one ``torch.distributed``
group through ``parallel/multihost.py::initialize`` and call ``target``.
``main.py`` uses it for ``data_parallel: N`` when no launcher started the
ranks; ``dp_steps`` is the data-parallel step run on a saved batch that the
CPU tests and ``chip_smoke.py`` hold against the single-process step, on
the 'data' axis and on the cloud ('model') axis.
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
    [B, N0·corr_k]), ``images`` or None, and optionally ``n_model`` (the
    cloud axis, default 1), ``eval_uniforms``, ``norm_probe`` and
    ``nan_grad``.  The rank builds the model on its device, takes its shard
    on ``make_mesh(n_model=n_model)`` (``parallel/mesh.py``), runs
    ``eval_step_dp`` on the given weights (with ``eval_uniforms``), then
    ``train_step_dp`` once per entry of ``uniforms`` with the kernels'
    launch and exchange counts (``parallel/cloud.py``) zeroed just before;
    it writes ``<out_path>.rank<r>``: the eval stats, the stats of every
    step, the parameters after step 1, the launches and exchanges over the
    steps, host ms a step and, on the card, peak GiB.

    ``norm_probe`` (dict of ``x`` [2, N, C], ``mask`` [2, N], ``w``
    [2, N, C]): first, this rank's cloud of ``x`` through a ``NormBlock``
    on the cloud axis, and the gradient of Σ y·w on the axis's ranks
    (``out["norm_probe"]``: y and dx of its cloud).  ``nan_grad`` ((rank,
    parameter name)): that rank's gradient of that parameter is made NaN
    in every step, a fault the steps must agree to skip."""
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.models.blocks import NormBlock
    from pcrcg_tpu_torch.parallel import cloud
    from pcrcg_tpu_torch.models.pcrcg import PCRCG
    from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
    from pcrcg_tpu_torch.parallel.mesh import make_mesh, replicate, shard_images
    from pcrcg_tpu_torch.parallel.mesh import shard_pair_batch
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import eval_step_dp, train_step_dp

    payload = torch.load(payload_path, weights_only=False)
    cfg = payload["cfg"]
    mesh = make_mesh(n_model=payload.get("n_model", 1))
    out = {"stats": [], "ms": []}
    probe = payload.get("norm_probe")
    if probe is not None:
        x, mask, w = (mesh.cloud.own(probe[k]).to(mesh.device) for k in ("x", "mask", "w"))
        x.requires_grad_(True)
        with torch.enable_grad():
            y = NormBlock()(x, mask, mesh.cloud.psum)
            (y * w).sum().backward()
        out["norm_probe"] = (y.detach().cpu(), x.grad.cpu())
    model = (PCRCG if cfg.image_feature else KPFCNN)(cfg)
    model.load_state_dict(payload["state_dict"])
    model = model.to(mesh.device).eval()
    state = replicate(TrainState(cfg, model), mesh)
    if payload.get("nan_grad") is not None and payload["nan_grad"][0] == mesh.rank:
        param = model.get_parameter(payload["nan_grad"][1])
        param.register_hook(lambda g: torch.full_like(g, float("nan")))
    batch = shard_pair_batch(payload["batch"], mesh).map(lambda t: t.to(mesh.device))
    images = payload.get("images")
    if images is not None:
        images = {k: v.to(mesh.device)
                  for k, v in shard_images(images, mesh, payload["batch"].points.shape[0]).items()}
    eval_uniforms = payload.get("eval_uniforms")
    if eval_uniforms is not None:  # on the weights as given
        ev = eval_step_dp(state, cfg, batch, uniforms=eval_uniforms, images=images, mesh=mesh)
        out["eval"] = {k: float(v) for k, v in ev.items()}
    kernels.reset_launches()
    cloud.reset_exchanges()
    for i, uniforms in enumerate(payload["uniforms"]):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = train_step_dp(state, cfg, batch, uniforms=uniforms, images=images, mesh=mesh)
        stats = {k: float(v) for k, v in stats.items()}
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["stats"].append(stats)
        if i == 0:
            out["params"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out["launches"] = dict(kernels.LAUNCHES)
    out["exchanges"] = dict(cloud.EXCHANGES)
    out["rank"], out["world_size"], out["backend"] = mesh.rank, mesh.world_size, mesh.backend
    out["device"], out["n_model"] = str(mesh.device), mesh.n_model
    if mesh.device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save(out, f"{out_path}.rank{mesh.rank}")
