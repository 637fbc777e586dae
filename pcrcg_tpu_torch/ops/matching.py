"""Chunked feature-space nearest neighbor (counterpart of
``pcrcg_tpu/ops/matching.py``)."""
from __future__ import annotations

import torch


def nearest_feature_neighbor(query_feats: torch.Tensor, support_feats: torch.Tensor,
                             support_mask: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """argmax_j <query_i, support_j> over valid supports -> [Nq] int64 (the
    first maximum on ties; all-invalid supports give 0).  Scores are taken
    from bf16-rounded descriptors with fp32 accumulation, the precision the
    JAX package uses for this pick."""
    neg = torch.finfo(torch.float32).min
    sup_t = support_feats.to(torch.bfloat16).float().T
    out = []
    for q in torch.split(query_feats, chunk):
        scores = q.to(torch.bfloat16).float() @ sup_t
        scores = torch.where(support_mask[None, :], scores, neg)
        out.append(scores.argmax(-1))
    return torch.cat(out)
