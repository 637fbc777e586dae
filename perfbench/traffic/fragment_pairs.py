"""3DMatch-style fragment pairs from the two in-repo fragments (cloud_bin_21
and cloud_bin_34 of 7-scenes-redkitchen, copied under ``assets/``), made on
the device from the seed:

* each fragment cropped by a random half-space to keep a share of its
  points: the pool's shares are evenly spaced over ``keep`` = [lo, hi],
  in an order drawn from the seed (every seed crops to the same sizes);
* the source under a uniform random rotation (SO(3), about the origin of
  its frame), composed into the ground-truth pose;
* ``img_num`` pinhole renders a fragment at height x width (nearest-point
  splats on the half-resolution grid, colors upsampled 2x), colored by a
  procedural texture of the source frame's coordinates, so overlapping
  regions look alike from any view: a torch copy of the port's
  ``assets.py::render_views`` / ``render_pair_images``.

Nothing here imports the program.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

ASSETS = Path(__file__).resolve().parent / "assets"

# The gt.log entry "21 34" of the 3DLoMatch 7-scenes-redkitchen scene: it
# maps fragment 34 into fragment 21's frame.
GT_34_TO_21 = np.array([[-0.455262791, -0.674319721, 0.581230622, -1.796732970],
                        [0.526546951, 0.322440636, 0.786464376, -0.772399229],
                        [-0.717836782, 0.664233294, 0.208264182, 1.131367600]])

# The 3DMatch camera (640 x 480).
BASE_INTR = np.array([[577.87, 0, 319.5, 0], [0, 577.87, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                     np.float64)


def adjust_intrinsic(intrinsic: np.ndarray, from_dim, to_dim) -> np.ndarray:
    """Rescale a pinhole intrinsic from image size ``from_dim`` (w, h) to
    ``to_dim``, with the (size - 1) / (size - 1) principal-point scaling."""
    out = np.array(intrinsic, dtype=np.float64, copy=True)
    w0, h0 = from_dim
    w1, h1 = to_dim
    if w1 / w0 >= h1 / h0:
        rh, rw = h1, (h1 / h0) * w0
    else:
        rw, rh = w1, (w1 / w0) * h0
    out[0, 0] *= rw / w0
    out[1, 1] *= rh / h0
    out[0, 2] *= (rw - 1) / (w0 - 1)
    out[1, 2] *= (rh - 1) / (h0 - 1)
    return out


def fragments():
    """(src [25337, 3], tgt [14602, 3]) float32 and the GT (rot, trans)
    mapping src onto tgt, float64."""
    src = np.load(ASSETS / "cloud_bin_21.npy").astype(np.float32)
    tgt = np.load(ASSETS / "cloud_bin_34.npy").astype(np.float32)
    rot = GT_34_TO_21[:, :3].T
    return src, tgt, rot, -rot @ GT_34_TO_21[:, 3]


def random_rotation(gen: torch.Generator, device) -> torch.Tensor:
    """A uniform rotation [3, 3] float64 (a normalized Gaussian quaternion)."""
    q = torch.randn(4, generator=gen, device=device, dtype=torch.float64)
    w, x, y, z = (q / q.norm()).unbind()
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def crop(points: torch.Tensor, keep: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The points on one side of a random plane, ``keep`` of them (the
    lowest projections on a random direction), in their original order."""
    direction = torch.randn(3, generator=gen, device=points.device)
    proj = points @ (direction / direction.norm())
    n_keep = int(math.ceil(float(keep) * points.shape[0]))
    order = torch.argsort(proj, stable=True)[:n_keep]
    return points[torch.sort(order).values]


def subsample(points: torch.Tensor, n_max, gen: torch.Generator) -> torch.Tensor:
    """At most ``n_max`` of the points, uniformly, in their original order."""
    if n_max is None or points.shape[0] <= n_max:
        return points
    pick = torch.randperm(points.shape[0], generator=gen, device=points.device)[:n_max]
    return points[torch.sort(pick).values]


def procedural_colors(points: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A deterministic RGB texture of position: 0.5 + 0.5 sin(p W + b)."""
    w = torch.randn(3, 3, generator=gen, device=points.device) * 6.0
    b = torch.rand(3, generator=gen, device=points.device) * (2 * math.pi)
    return 0.5 + 0.5 * torch.sin(points @ w + b)


def _lookat_world2cam(eye: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """OpenCV-style world -> camera [4, 4] float64: +z toward ``center``."""
    f = center - eye
    f = f / f.norm()
    up = torch.tensor([0.0, 1.0, 0.0], dtype=f.dtype, device=f.device)
    if abs(float(f @ up)) > 0.95:
        up = torch.tensor([1.0, 0.0, 0.0], dtype=f.dtype, device=f.device)
    r = torch.linalg.cross(f, up)
    r = r / r.norm()
    d = torch.linalg.cross(f, r)
    rot = torch.stack([r, d, f])
    m = torch.eye(4, dtype=f.dtype, device=f.device)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ eye
    return m


def _splat(cam: torch.Tensor, intr: np.ndarray, hh: int, ww: int, values: torch.Tensor,
           out: torch.Tensor) -> None:
    """Write ``values`` of the points in front of the camera at their pixels,
    the nearest point of a pixel winning (ties: the lower row)."""
    z = cam[:, 2]
    front = z > 0.05
    cf, zf, vf = cam[front], z[front], values[front]
    u = (intr[0, 0] * cf[:, 0] / zf + intr[0, 2]).long()
    v = (intr[1, 1] * cf[:, 1] / zf + intr[1, 2]).long()
    ok = (u >= 0) & (u < ww) & (v >= 0) & (v < hh)
    pix, zk, vk = (v * ww + u)[ok], zf[ok], vf[ok]
    by_z = torch.argsort(zk, stable=True)
    by_pix = by_z[torch.argsort(pix[by_z], stable=True)]
    pix_sorted = pix[by_pix]
    first = torch.ones_like(pix_sorted, dtype=torch.bool)
    first[1:] = pix_sorted[1:] != pix_sorted[:-1]
    win = by_pix[first]
    out.view(hh * ww, -1)[pix[win]] = vk[win].reshape(win.shape[0], -1).to(out.dtype)


def render_views(points: torch.Tensor, colors: torch.Tensor, img_num: int,
                 gen: torch.Generator, height: int, width: int):
    """Renders from random directions 2.2 radii out: color [I, H, W, 3],
    depth [I, H/2, W/2] (meters), valid [I, H/2, W/2], world2cam [I, 4, 4]
    and the intrinsics at (W/2, H/2) [4, 4]."""
    dev = points.device
    h2, w2 = height // 2, width // 2
    intr = adjust_intrinsic(BASE_INTR, (640, 480), (w2, h2))
    p64 = points.double()
    center = p64.mean(0)
    radius = float((p64 - center).norm(dim=1).max())
    imgs = torch.zeros(img_num, height, width, 3, device=dev)
    deps = torch.zeros(img_num, h2, w2, device=dev)
    w2c = torch.zeros(img_num, 4, 4, device=dev)
    for i in range(img_num):
        direction = torch.randn(3, generator=gen, device=dev, dtype=torch.float64)
        eye = center + direction / direction.norm() * (2.2 * radius)
        m = _lookat_world2cam(eye, center)
        w2c[i] = m.float()
        cam = p64 @ m[:3, :3].T + m[:3, 3]
        img_h = torch.zeros(h2, w2, 3, device=dev)
        _splat(cam, intr, h2, w2, colors, img_h)
        imgs[i] = img_h.repeat_interleave(2, 0).repeat_interleave(2, 1)
        _splat(cam, intr, h2, w2, cam[:, 2].float(), deps[i])
    valid = (deps > 0).float()
    return imgs, deps, valid, w2c, torch.as_tensor(intr, dtype=torch.float32, device=dev)


def make_pool(params: dict, seed: int, device, images: bool = True) -> list:
    """``params['pairs']`` pairs: dicts of src_pcd, tgt_pcd (float32 numpy,
    the raw clouds ``make_pair_batch`` takes), rot, trans (float64 numpy,
    src -> tgt) and, with ``images``, the pair's image dict (device
    tensors; colors [2, I, H, W, 3], depths / valid_maps [2, I, H/2, W/2],
    world2cam [2, I, 4, 4], intrinsics [4, 4])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    src0, tgt0, rot0, trans0 = fragments()
    src0 = torch.as_tensor(src0, device=device)
    tgt0 = torch.as_tensor(tgt0, device=device)
    rot0 = torch.as_tensor(rot0, device=device)
    trans0 = torch.as_tensor(trans0, device=device)
    lo, hi = params["keep"]
    n_pairs = params["pairs"]
    # Every seed crops to the same set of shares, in its own order.
    order = torch.stack([torch.randperm(n_pairs, generator=gen, device=device)
                         for _ in range(2)]).double()
    pool = []
    for j in range(n_pairs):
        keeps = lo + (hi - lo) * (order[:, j] + 0.5) / n_pairs
        src = subsample(crop(src0, keeps[0], gen), params.get("max_points"), gen)
        tgt = subsample(crop(tgt0, keeps[1], gen), params.get("max_points"), gen)
        rand = random_rotation(gen, device)
        src_rot = (src.double() @ rand.T).float()
        # tgt = rot0 src + trans0 = (rot0 rand^T) src_rot + trans0.
        rot = rot0 @ rand.T
        sample = {"src_pcd": src_rot.cpu().numpy(), "tgt_pcd": tgt.cpu().numpy(),
                  "rot": rot.cpu().numpy(), "trans": trans0.cpu().numpy()}
        if images:
            # Colors of the source frame's coordinates: src as it was, tgt
            # mapped back through the GT pose.
            tgt_in_src = ((tgt.double() - trans0) @ rot0).float()
            views = [render_views(p, procedural_colors(c, torch.Generator(
                device=device).manual_seed(seed)), params["img_num"], gen, params["height"],
                params["width"]) for p, c in ((src_rot, src), (tgt, tgt_in_src))]
            sample["images"] = {
                "colors": torch.stack([v[0] for v in views]),
                "depths": torch.stack([v[1] for v in views]),
                "world2cam": torch.stack([v[3] for v in views]),
                "valid_maps": torch.stack([v[2] for v in views]),
                "intrinsics": views[0][4],
            }
        pool.append(sample)
    return pool
