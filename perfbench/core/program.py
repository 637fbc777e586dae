"""The system under test, ``pcrcg_tpu_torch``: the only module of the
harness that imports it, and only inside its functions, after the harness
has found the card."""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from perfbench.core import weights


def port_config(sections: Mapping):
    """A configuration file's sections -> the port's ``Config`` (sections
    flattened one level, as the port's YAML loader does)."""
    from pcrcg_tpu_torch.config import config_from_dict

    flat = {}
    for key, value in sections.items():
        if isinstance(value, dict) and key != "budgets":
            flat.update(value)
        else:
            flat[key] = value
    return config_from_dict(flat)


def build_kernels() -> None:
    """Build (or find in ``build/pcrcg_tpu_torch/``) the CUDA libraries."""
    from pcrcg_tpu_torch import kernels

    kernels.build_all()


def build_model(cfg, state: Mapping[str, torch.Tensor], device):
    """The model users run for ``cfg``: ``PCRCG`` with the image lift for
    the color model, ``KPFCNN`` otherwise, holding the harness's weights."""
    from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
    from pcrcg_tpu_torch.models.pcrcg import PCRCG

    with torch.device(device):
        model = PCRCG(cfg) if cfg.image_feature else KPFCNN(cfg)
    model = model.to(device).eval()
    weights.load_into(model, state, cfg.image_feature)
    return model


def model_shapes(cfg):
    """The canonical weight names and shapes of ``cfg``'s model (built on
    the meta device: no memory, no init)."""
    from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
    from pcrcg_tpu_torch.models.pcrcg import PCRCG

    with torch.device("meta"):
        model = PCRCG(cfg) if cfg.image_feature else KPFCNN(cfg)
    return weights.model_shapes(model, cfg.image_feature)


def make_batch(sample: Mapping, cfg, device):
    """``data/pair.py::make_pair_batch`` on one pair's raw clouds."""
    from pcrcg_tpu_torch.data.pair import make_pair_batch

    raw = {k: sample[k] for k in ("src_pcd", "tgt_pcd", "rot", "trans")}
    return make_pair_batch([raw], cfg.budgets.points[0], in_feats_dim=cfg.in_feats_dim,
                           device=device)


def register(model, cfg, batch, draws, images, device):
    """``eval/tester.py::register_pair`` on one pair with the injected
    draws, as the testers call it (5,000 sampled points, 50,000 RANSAC
    hypotheses in chunks of 1,024)."""
    from pcrcg_tpu_torch.eval.tester import register_pair

    return register_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0],
                         uniforms=draws["uniforms"], picks=draws["picks"], images=images,
                         device=device, n_points=5000, num_iterations=50000,
                         hypothesis_chunk=1024)


def train_state(cfg, model, steps_per_epoch: int):
    """The optimizer state as the ``Trainer`` builds it: the schedule steps
    once an epoch of ``steps_per_epoch`` pairs."""
    from pcrcg_tpu_torch.train.state import TrainState

    return TrainState(cfg, model, steps_per_epoch=steps_per_epoch)


def train_step(state, cfg, batch, uniforms, images):
    """``train/step.py::train_step``, batch 1."""
    from pcrcg_tpu_torch.train.step import train_step as step

    return step(state, cfg, batch, uniforms=uniforms, images=images)


def draws(cfg, sample: Mapping, gen: torch.Generator, device, train: bool) -> dict:
    """One pair's injected draws, from ``gen``: for registration the Gumbel
    uniforms [2, N0] and the RANSAC picks [chunks, 1024, 3] in
    [0, #valid sampled points); for training the circle loss's uniforms
    [1, N0 corr_k]."""
    n0 = cfg.budgets.points[0]
    if train:
        return {"uniforms": torch.rand(1, n0 * cfg.budgets.corr_k, generator=gen, device=device)}
    u = torch.rand(2, n0, generator=gen, device=device) * (1.0 - 1e-20) + 1e-20
    n_valid = min(5000, len(sample["src_pcd"]), n0)
    chunks = max(50000 // 1024, 1)
    picks = (torch.rand(chunks, 1024, 3, generator=gen, device=device) * n_valid).long()
    return {"uniforms": u, "picks": picks.clamp(max=n_valid - 1)}


def step_module():
    """``train/step.py``: both entries reach the pyramid through its
    ``build_pyramid_cfg`` (``register_pair`` by way of ``forward_pair``),
    and a step its loss through its ``loss_from_outputs``: where the
    traced run marks those layers' ends."""
    from pcrcg_tpu_torch.train import step

    return step


def kpconv_modules(model):
    """The model's KPConv modules (by class), for the forward hooks that
    bracket their calls."""
    return [m for m in model.modules() if type(m).__name__ == "KPConv"]


def lift_module(model, cfg) -> Optional[torch.nn.Module]:
    return model.lift if cfg.image_feature else None


def kpfcnn_module(model, cfg) -> torch.nn.Module:
    return model.kpfcnn if cfg.image_feature else model
