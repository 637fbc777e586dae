"""2D↔3D camera projection (counterpart of ``pcrcg_tpu/ops/projection.py``).

Every 3D point gets a pixel coordinate and a validity bit instead of the
reference's variable-length (inds2d, inds3d) lists (reference
projection.py:31-61): invalid = out of view or failing the
|projected z − depth(pixel)| < thresh consistency test.  The tensor
functions take any leading batch axes (one per image), so the lift
projects every (cloud, image) in one call.

The bounds are tested on the truncated float pixel, before any cast to an
integer: a float outside the int32 range (a point at z = 0, or far
outside the frustum) has no defined conversion, and the CPU and CUDA give
different integers for it (CUDA turns a NaN into 0, which is in bounds).
Tested as floats, every NaN, inf or huge coordinate is out of bounds on
both devices, as the JAX package's saturating cast makes it.
"""
from __future__ import annotations

import numpy as np
import torch


def adjust_intrinsic(intrinsic: np.ndarray, from_dim, to_dim) -> np.ndarray:
    """Rescale a pinhole intrinsic from image size ``from_dim`` (w, h) to
    ``to_dim`` (reference datasets/visualize.py:244-275, including the
    (size − 1)/(size − 1) principal-point scaling).  numpy."""
    if tuple(from_dim) == tuple(to_dim):
        return intrinsic
    out = np.array(intrinsic, dtype=np.float64, copy=True)
    w0, h0 = from_dim
    w1, h1 = to_dim
    if w1 / w0 >= h1 / h0:  # resize limited by height; width keeps aspect
        rh = h1
        rw = (h1 / h0) * w0
    else:
        rw = w1
        rh = (w1 / w0) * h0
    out[0, 0] *= rw / w0
    out[1, 1] *= rh / h0
    out[0, 2] *= (rw - 1) / (w0 - 1)
    out[1, 2] *= (rh - 1) / (h0 - 1)
    return out


def unproject(depth: np.ndarray, intrinsics: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Depth map (meters) [H, W] -> world-space points [M, 3] at the valid
    (> 0) pixels (reference datasets/visualize.py:303-339).  numpy."""
    h, w = depth.shape
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    z = depth.reshape(-1)
    valid = z > 0
    x = x.reshape(-1)[valid]
    y = y.reshape(-1)[valid]
    z = z[valid]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    bx = intrinsics[0, 3] if intrinsics.shape[1] > 3 else 0.0
    by = intrinsics[1, 3] if intrinsics.shape[1] > 3 else 0.0
    pts = np.stack([(x - cx) * z / fx + bx, (y - cy) * z / fy + by, z, np.ones_like(z)], 1)
    world = pts @ np.asarray(pose).T
    return world[:, :3]


def homogeneous_transform(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """matrix [..., 4, 4] (or [..., 3, 3], rotation only), points [..., N, 3]
    -> [..., N, 3] (reference projection.py:13-27)."""
    if matrix.shape[-1] == 3:
        return points @ matrix.transpose(-1, -2)
    return points @ matrix[..., :3, :3].transpose(-1, -2) + matrix[..., None, :3, 3]


def project_points(points, depth_map, world2camera, intrinsics, point_mask, thresh: float = 0.1):
    """points [..., N, 3], depth_map [..., H, W], world2camera [..., 4, 4],
    intrinsics [..., 4, 4], point_mask [..., N] -> (pix [..., N, 2] int32
    (x, y), valid [..., N] bool).

    pix = trunc(u/z, v/z), like the reference's ``.long()`` cast: a u in
    (−1, 0) lands on column 0.  valid needs the pixel in bounds, depth
    consistency within ``thresh`` and the point's mask.  Where the pixel
    is out of bounds, pix is some pixel outside the image (clamped to
    [−1, max(H, W)]), not the JAX package's saturated int32.
    """
    h, w = depth_map.shape[-2:]
    cam = homogeneous_transform(world2camera, points)
    img = homogeneous_transform(intrinsics, cam)
    z = img[..., 2]
    uv = torch.trunc(img[..., :2] / torch.where(z == 0, 1e-12, z)[..., None])
    u, v = uv.unbind(-1)
    in_bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    cx = torch.where(in_bounds, u, 0.0).long()
    cy = torch.where(in_bounds, v, 0.0).long()
    # A plain gather.  The JAX package reads the depth through a row gather
    # and a one-hot sum, a TPU workaround (pcrcg_tpu/ops/projection.py:66-77)
    # whose only visible difference is that a -0.0 depth reads as +0.0; the
    # test |z - depth| < thresh cannot tell the two apart.
    maps = depth_map.expand(*z.shape[:-1], h, w).flatten(-2)
    depth = torch.gather(maps, -1, cy * w + cx)
    valid = in_bounds & (torch.abs(z - depth) < thresh) & point_mask
    pix = uv.nan_to_num(nan=-1.0).clamp(-1, max(h, w)).to(torch.int32)
    return pix, valid


def gather_pixel_features(fmap: torch.Tensor, pix: torch.Tensor, valid: torch.Tensor):
    """fmap [..., H, W, C], pix [..., N, 2] (x, y), valid [..., N] ->
    [..., N, C], zero rows where not valid."""
    h, w, c = fmap.shape[-3:]
    cx = pix[..., 0].long().clamp(0, w - 1)
    cy = pix[..., 1].long().clamp(0, h - 1)
    flat = fmap.expand(*valid.shape[:-1], h, w, c).flatten(-3, -2)
    out = torch.gather(flat, -2, (cy * w + cx)[..., None].expand(*cx.shape, c))
    return torch.where(valid[..., None], out, 0.0)
