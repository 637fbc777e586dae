"""PCRCG: the color + geometry model (counterpart of
``pcrcg_tpu/models/pcrcg.py``; reference models/architectures.py:181-610,
with backbone2d passed in by the trainer): the 2D backbone lift
(``models/lift.py``) followed by KPFCNN.  With ``image_feature`` off this
is KPFCNN over the ones features (in_feats_dim 1); on, the point features
are the lifted image features and a ones column (in_feats_dim
backbone2d_channels + 1).

The 2D backbone is frozen, as the reference builds it outside the
optimizer (main.py:59, lib/trainer.py:49-70): its parameters do not
require a gradient, so ``TrainState`` neither decays nor moves them, and
TrainModeBN never updates its buffers.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from pcrcg_tpu_torch import resolve_device
from pcrcg_tpu_torch.config import Config
from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
from pcrcg_tpu_torch.models.lift import ImageLift
from pcrcg_tpu_torch.ops.pyramid import Pyramid


def refuse_image_feature(cfg: Config, images: Optional[Mapping]) -> None:
    """Raise on a config with the color branch on (``image_feature``) and no
    images, as the JAX package's model does (pcrcg_tpu/models/pcrcg.py:
    34-35), where a geometry-only KPFCNN would run silently over ones
    columns."""
    if cfg.image_feature and images is None:
        raise ValueError("image_feature=True needs image inputs")


class PCRCG(nn.Module):
    """``forward(pyramid, features, images)`` -> KPFCNN's outputs; with
    ``image_feature`` the lift's features replace ``features``.
    ``images`` holds ``models/lift.py::IMAGE_KEYS`` (one pair)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        if cfg.image_feature:
            self.lift = ImageLift(cfg.backbone2d_channels, cfg.backbone2d_depth,
                                  compute_dtype=cfg.image_compute_dtype)
            self.lift.backbone2d.requires_grad_(False)
        self.kpfcnn = KPFCNN(cfg)

    def forward(self, pyramid: Pyramid, features: torch.Tensor,
                images: Optional[Mapping] = None):
        refuse_image_feature(self.cfg, images)
        if self.cfg.image_feature:
            features = self.lift(pyramid.points[0], pyramid.masks[0], images["colors"],
                                 images["depths"], images["world2cam"], images["valid_maps"],
                                 images["intrinsics"])
        return self.kpfcnn(pyramid, features)


def init_pcrcg(cfg: Config, seed: int = 0, device=None) -> PCRCG:
    """A PCRCG with seeded random weights (drawn on the CPU) on ``device``:
    CUDA unless the caller names the CPU.  Its KPFCNN has the weights of
    ``init_kpfcnn(cfg, seed)``; the backbone draws from its own generator
    of the same seed.  In eval mode."""
    model = PCRCG(cfg)
    model.kpfcnn.reset_parameters(torch.Generator().manual_seed(seed))
    if cfg.image_feature:
        model.lift.backbone2d.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval()
