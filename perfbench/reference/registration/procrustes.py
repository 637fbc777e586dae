"""Frozen plain copy of the port's ``registration/procrustes.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

Rigid fits (counterpart of ``pcrcg_tpu/registration/procrustes.py``):
weighted SVD Procrustes (reference lib/tester.py:210-245), Horn's
quaternion method by fixed-length power iteration, and the exact 3-point
frame fit used for RANSAC hypotheses.  All batched over leading dims.
"""
from __future__ import annotations

import torch

_EPS = 1e-6


def _centered(a, b, weights):
    w = weights[..., None]
    w = w / (w.sum(-2, keepdim=True) + _EPS)
    centroid_a = (a * w).sum(-2)
    centroid_b = (b * w).sum(-2)
    a_c = a - centroid_a[..., None, :]
    b_c = b - centroid_b[..., None, :]
    return centroid_a, centroid_b, a_c.transpose(-1, -2) @ (b_c * w)


def _with_translation(rot, centroid_a, centroid_b):
    trans = centroid_b[..., :, None] - rot @ centroid_a[..., :, None]
    return torch.cat([rot, trans], dim=-1)


def rigid_transform(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """a, b [...,M,3], weights [...,M] -> T [...,3,4] with T·a ≈ b (SVD with
    the det-flip of the last right-singular vector)."""
    centroid_a, centroid_b, cov = _centered(a, b, weights)
    u, _, vt = torch.linalg.svd(cov)
    v = vt.transpose(-1, -2)
    rot_pos = v @ u.transpose(-1, -2)
    v_neg = torch.cat([v[..., :2], -v[..., 2:]], dim=-1)
    rot_neg = v_neg @ u.transpose(-1, -2)
    det = torch.linalg.det(rot_pos)
    rot = torch.where((det > 0)[..., None, None], rot_pos, rot_neg)
    return _with_translation(rot, centroid_a, centroid_b)


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) [...,4] -> rotation matrix [...,3,3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rigid_transform_horn(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor,
                         iters: int = 30) -> torch.Tensor:
    """Weighted rigid fit via Horn's quaternion method: the dominant
    eigenvector of the 4x4 matrix K by a fixed-length power iteration."""
    centroid_a, centroid_b, m = _centered(a, b, weights)
    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    k = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], dim=-2)
    # Shift by a Gershgorin lower bound so the wanted eigenvalue dominates.
    diag = torch.diagonal(k, dim1=-2, dim2=-1)
    gersh = (diag - (k.abs().sum(-1) - diag.abs())).amin(-1)
    c = (-gersh).clamp_min(0.0) + _EPS
    k = k + c[..., None, None] * torch.eye(4, dtype=k.dtype, device=k.device)
    q = torch.full(k.shape[:-1], 0.5, dtype=k.dtype, device=k.device)
    for _ in range(iters):
        q = torch.einsum("...ij,...j->...i", k, q)
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)
    return _with_translation(_quat_to_rot(q), centroid_a, centroid_b)


def rigid_transform_3pt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact rigid transform from the first 3 correspondences of a, b
    [...,>=3,3] by orthonormal-frame construction."""

    def frame(p):
        e1 = p[..., 1, :] - p[..., 0, :]
        e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True).clamp_min(_EPS)
        u = p[..., 2, :] - p[..., 0, :]
        e2 = u - (u * e1).sum(-1, keepdim=True) * e1
        e2 = e2 / torch.linalg.norm(e2, dim=-1, keepdim=True).clamp_min(_EPS)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)  # columns

    rot = frame(b) @ frame(a).transpose(-1, -2)
    return _with_translation(rot, a[..., :3, :].mean(-2), b[..., :3, :].mean(-2))
