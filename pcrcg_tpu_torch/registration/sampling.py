"""Interest-point sampling (counterpart of ``pcrcg_tpu/registration/sampling.py``).

Gumbel top-k: adding Gumbel noise to log-probabilities and taking the top-k
is a weighted sample without replacement (reference lib/tester.py:146-164
draws ``np.random.choice(..., replace=False, p=overlap*saliency)``).
"""
from __future__ import annotations

from typing import Optional

import torch


def weighted_sample_topk(scores: torch.Tensor, mask: torch.Tensor, n: int,
                         generator: Optional[torch.Generator] = None,
                         uniform: Optional[torch.Tensor] = None):
    """Sample ``n`` indices without replacement ∝ scores among valid rows.

    The uniforms in [1e-20, 1) come from ``generator`` (on the scores'
    device), or are passed in as ``uniform`` (same shape as scores) to
    replay another generator's draws.  Returns (idx [n] int64, valid [n]
    bool); when fewer than n rows are valid the tail is invalid."""
    if uniform is None:
        uniform = torch.rand(scores.shape, generator=generator, device=scores.device)
        uniform = uniform * (1.0 - 1e-20) + 1e-20
    logp = torch.log(scores.clamp_min(1e-12))
    gumbel = -torch.log(-torch.log(uniform))
    keys = torch.where(mask, logp + gumbel, -torch.inf)
    top, idx = torch.sort(keys, descending=True, stable=True)
    return idx[:n], torch.isfinite(top[:n])
