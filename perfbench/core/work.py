"""The algorithm's work in one unit (a pair or a step), counted from the
shapes one unit's modules see and the pyramid's real counts
(``perfbench/counts/work.py`` does the arithmetic).

Counted: every KPConv (forward; in a step also its backward), the dense
layers of the KPFCNN, its GCN and decoder (linear layers and 1x1
convolutions, over the real rows of the level they run on), the GCN's
attention products and the cross-cloud saliency product, the 2D
backbone's convolutions (forward only: the lift is detached), and for a
pair the feature matching and RANSAC's hypothesis scoring.  A step counts
the trained dense work three times (forward, and the two products of its
backward).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.counts import work as counts

PAD_LIMIT = 0.5e6


def real_rows(t: torch.Tensor) -> int:
    return int((t[..., 0].abs() < PAD_LIMIT).sum())


class DenseHooks:
    """Forward hooks on the dense layers (by class: linear layers, 1x1
    convolutions and 2D convolutions) and on the KPFCNN (its pyramid)."""

    DENSE = ("Linear", "Conv1x1")
    CONV2D = ("Conv", "Conv2d")

    def __init__(self, model: torch.nn.Module, kpfcnn: torch.nn.Module):
        self.dense: List[tuple] = []
        self.conv2d: List[tuple] = []
        self.pyramid = None
        self.handles = [kpfcnn.register_forward_pre_hook(self._pyr)]
        for m in model.modules():
            name = type(m).__name__
            if name in self.DENSE:
                self.handles.append(m.register_forward_hook(self._dense))
            elif name in self.CONV2D:
                self.handles.append(m.register_forward_hook(self._conv))

    def _pyr(self, module, args):
        self.pyramid = args[0]

    def _dense(self, module, args, out):
        w = module.weight
        self.dense.append((tuple(args[0].shape), w.shape[1], w.shape[0]))

    def _conv(self, module, args, out):
        w = module.weight
        self.conv2d.append((out.shape, w.shape[1], w.shape[0], w.shape[2], w.shape[3],
                            module.groups))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def kpconv_calls(calls: List[dict], train: bool) -> List[dict]:
    """Per KPConv call: real counts, and (ops, bytes) forward and backward."""
    out = []
    for c in calls:
        nq = real_rows(c["q_pts"])
        ns = real_rows(c["s_pts"])
        edges = int((c["neighb_inds"] < c["s_pts"].shape[1]).sum())
        fwd = counts.kpconv_forward(nq, ns, edges, c["c_in"], c["c_out"], c["k"])
        bwd = counts.kpconv_backward(nq, ns, edges, c["c_in"], c["c_out"], c["k"],
                                     c["input_grad"]) if train else (0, 0)
        out.append({"nq": nq, "ns": ns, "edges": edges, "fwd": fwd, "bwd": bwd})
    return out


def unit_flops(dense: DenseHooks, kp: List[dict], cfg, train: bool) -> Dict[str, float]:
    """The unit's operations, by part."""
    pyr = dense.pyramid
    budgets = cfg.budgets.points
    frac = {}
    for lvl, m in enumerate(pyr.masks):
        frac[budgets[lvl]] = float(m.sum()) / m.numel()
    point_dense = 0.0
    for shape, c_in, c_out in dense.dense:
        rows = 1
        for s in shape[:-1]:
            rows *= s
        share = next((frac[s] for s in shape[:-1] if s in frac), 1.0)
        point_dense += counts.dense(rows * share, c_in, c_out)
    backbone = sum(counts.conv2d(o[0], c_in, c_out, kh, kw, o[2], o[3], g)
                   for o, c_in, c_out, kh, kw, g in dense.conv2d)
    n0, n1 = (int(x) for x in pyr.masks[-1].sum(-1))
    d = cfg.gnn_feats_dim
    attention = sum(2 * counts.attention(n0, n1, d) for name in cfg.nets if name == "cross")
    attention += counts.matching(n0, n1, d)  # the cross-cloud saliency product
    kp_fwd = float(sum(c["fwd"][0] for c in kp))
    kp_bwd = float(sum(c["bwd"][0] for c in kp))
    parts = {"backbone": backbone, "kpconv": kp_fwd + kp_bwd}
    if train:
        parts["dense"] = 3.0 * (point_dense + attention)
    else:
        n_corr = min(5000, int(pyr.masks[0][0].sum()))
        parts["dense"] = point_dense + attention
        parts["registration"] = (counts.matching(n_corr, min(5000, int(pyr.masks[0][1].sum())),
                                                 cfg.final_feats_dim)
                                 + counts.ransac(n_corr, (50000 // 1024) * 1024))
    parts["total"] = sum(parts.values())
    return parts


def roofline_share(kp: List[dict], device_s: float, train: bool) -> Optional[float]:
    """The KPConv calls' least time over their device time, in %."""
    if device_s <= 0:
        return None
    least = sum(counts.least_seconds(*c["fwd"]) for c in kp)
    if train:
        least += sum(counts.least_seconds(*c["bwd"]) for c in kp)
    return 100.0 * least / device_s
