"""Frozen plain copy of the port's ``geom/so3.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

SO(3) helper the pose head's loss uses (counterpart of
``pcrcg_tpu/geom/so3.py::quaternion_from_matrix``)."""
from __future__ import annotations

import torch


def quaternion_from_matrix(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion (w, x, y, z), the
    branchless form: each magnitude from the diagonal, the signs of x, y, z
    from the off-diagonal differences."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt((1.0 + tr).clamp_min(0.0)) / 2
    qx = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(0.0)) / 2
    qy = torch.sqrt((1.0 - m00 + m11 - m22).clamp_min(0.0)) / 2
    qz = torch.sqrt((1.0 - m00 - m11 + m22).clamp_min(0.0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
