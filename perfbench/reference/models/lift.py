"""Frozen plain copy of the port's ``models/lift.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

2D→3D feature lift (counterpart of ``pcrcg_tpu/models/lift.py``;
reference models/architectures.py:195-514, the img_num ∈ {1, 2, 3}
branches): the 2D backbone runs on every color image, its feature maps
are gated by the SuperGlue valid maps, and every point takes the features
at its projected pixel.

* Every point carries a (pixel, valid) pair per image
  (``ops/projection.py``), not the reference's variable-length scatters.
* The first valid image wins: the reference applies later images'
  scatters first so that image 1 overwrites (architectures.py:367-370).
* A point no image sees keeps the all-ones row (the reference's
  ``x = ones.repeat(1, 129)``, :360); pad rows are 0.
* Detached: the backbone and the lift run without gradient, so no graph
  of the backbone is kept and backbone2d gets no gradient (:300-307).
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from perfbench.reference.models.resunet import ResUNet
from perfbench.reference.ops.projection import gather_pixel_features, project_points

IMAGE_KEYS = ("colors", "depths", "world2cam", "valid_maps", "intrinsics")


def _exact_div(x: torch.Tensor, denom: float) -> torch.Tensor:
    """x (uint8 / uint16) as float32 divided by ``denom``, equal to the
    host's correctly rounded ``x.astype(float32) / denom`` for every uint8
    (÷255) and uint16 (÷1000) value: the deep backbone amplifies a 1-ulp
    input difference into O(1) feature changes.

    Neither float32 form works here.  A division by a Python scalar on the
    card multiplies by the rounded reciprocal, 1 ulp off for about half of
    the inputs.  The JAX package's x·c_hi + x·c_lo (c_hi = f32(1/d),
    c_lo = f32(1/d − c_hi)) is exact only because XLA fuses it into a
    multiply-add; rounded one op at a time, as eager PyTorch runs it, it
    misses 121 of the 256 uint8 and 24,735 of the 65,536 uint16 values.
    So the product is taken in float64: its error, at most ~2^-52
    relative, is far below the ~2^-35 (1 / (d·2^25)) that separates x/d
    from any float32 rounding midpoint, so the cast to float32 rounds it
    correctly on every device."""
    return (x.to(torch.float64) * (1.0 / denom)).to(torch.float32)


def images_to(images: Mapping, device) -> dict:
    """An image dict (numpy or torch leaves) as tensors on ``device``."""
    return {k: torch.as_tensor(images[k]).to(device) for k in IMAGE_KEYS}


class ImageLift(nn.Module):
    """[2, N, output_channel + 1] input features for KPFCNN from the two
    clouds' image stacks:

    points [2, N, 3] (padded clouds), masks [2, N], colors [2, I, H, W, 3]
    (float in [0, 1], or uint8), depths [2, I, h, w] (meters, or uint16
    millimeters), world2cam [2, I, 4, 4] (fragment frame -> camera),
    valid_maps [2, I, h, w] (SuperGlue confidence gating), intrinsics
    [4, 4] (at (w, h)); I = img_num images a cloud, (h, w) = (H/2, W/2)."""

    def __init__(self, output_channel: int = 128, depth: int = 50, thresh: float = 0.1,
                 compute_dtype: str = "float32"):
        super().__init__()
        dtype = None if compute_dtype == "float32" else getattr(torch, compute_dtype)
        self.backbone2d = ResUNet(output_channel, depth, dtype=dtype)
        self.thresh = thresh

    @torch.no_grad()
    def forward(self, points, masks, colors, depths, world2cam, valid_maps, intrinsics):
        if colors.dtype == torch.uint8:
            colors = _exact_div(colors, 255.0)
        if depths.dtype == torch.uint16:
            depths = _exact_div(depths, 1000.0)
        valid_maps = valid_maps.to(torch.float32)
        fmaps = self.backbone2d(colors)  # [2, I, h, w, C]
        fmaps = (fmaps * valid_maps[..., None]).contiguous()  # 2D-match gating (:282-285)
        pix, valid = project_points(points[:, None], depths, world2cam, intrinsics,
                                    masks[:, None], self.thresh)  # [2, I, N, 2], [2, I, N]
        feats = gather_pixel_features(fmaps, pix, valid)  # [2, I, N, C]
        two, _, n, c = feats.shape
        out = torch.ones(two, n, c + 1, device=feats.device)
        for i in reversed(range(feats.shape[1])):  # the first valid image wins
            out[..., :-1] = torch.where(valid[:, i, :, None], feats[:, i], out[..., :-1])
        return torch.where(masks[..., None], out, 0.0)
