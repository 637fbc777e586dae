"""The cloud ('model') mesh axis: the two clouds of each pair on two ranks
(the port of ``make_mesh(n_data, n_model=2)`` in
``pcrcg_tpu/parallel/mesh.py``, where GSPMD inserts the exchanges).

A rank of the axis holds one cloud of each of its pairs.  It builds that
cloud's pyramid and runs the encoder, the decoder and every KPConv kernel
on it alone.  The clouds meet in three places, each an exchange over the
axis's group:

* every ``NormBlock`` normalizes over the joint src + tgt rows: its masked
  sums go through :meth:`CloudAxis.psum`;
* the bottleneck (GCN, projections, saliency, node-overlap head) runs on
  both clouds on every rank, from the features :meth:`CloudAxis.gather`
  assembles, and each rank keeps its own cloud for the decoder;
* the outputs are gathered, so the pose head and the loss run on both
  clouds on every rank.

Gradient rule.  Each rank back-propagates ``1 / size`` of the loss, and
the gradient of every parameter is the SUM of the ranks' gradients over
the axis.  The exchanges are written for that rule: ``psum``'s backward
sums the incoming gradients over the group, and so does ``gather``'s,
before each rank keeps the rows of its cloud.  A computation that every
rank repeats (the bottleneck, the heads, the loss) then adds ``1 / size``
of its gradient on each rank, and a per-cloud one (encoder, decoder) its
own cloud's whole gradient, so one sum is right for every parameter and
nothing is counted twice.

Every exchange is an ``all_reduce`` (a gather sums zero-filled slots), the
one collective that gloo also runs on CUDA tensors, where ranks share a
card.  ``EXCHANGES`` counts them by kind, forward and backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist

from pcrcg_tpu_torch.utils.profiling import counter_group

# The axis's all_reduce calls by kind (a process's own; reset_exchanges()):
# the group "exchanges" of the counter registry (utils/profiling.py).
EXCHANGES: Dict[str, int] = counter_group("exchanges", ("psum", "gather"))


def reset_exchanges() -> None:
    for key in EXCHANGES:
        EXCHANGES[key] = 0


def _sum(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``x`` summed over ``group`` in place (a contiguous tensor)."""
    EXCHANGES[kind] += 1
    dist.all_reduce(x, group=group)
    return x


class _PSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x.contiguous().clone(), group, "psum")

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad.contiguous().clone(), ctx.group, "psum"), None


class _Gather(torch.autograd.Function):
    """[n, ...] on each rank -> the ranks' rows stacked [size·n, ...] in
    rank order; the backward sums the gradients over the group and keeps
    this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.group, ctx.rows = group, slice(index * x.shape[0], (index + 1) * x.shape[0])
        out = x.new_zeros((size * x.shape[0],) + tuple(x.shape[1:]))
        out[ctx.rows] = x
        return _sum(out, group, "gather")

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad.contiguous().clone(), ctx.group, "gather")[ctx.rows], None, None, None


@dataclasses.dataclass(frozen=True)
class CloudAxis:
    """This rank's place on the cloud axis: ``index`` 0 holds the source
    cloud of each pair, 1 the target; ``group`` is the ``size`` ranks that
    hold one pair's clouds."""

    index: int
    size: int
    group: Any

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's cloud [1, ...] of both clouds' [size, ...]."""
        return x[self.index:self.index + 1]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis, differentiable."""
        return _PSum.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's cloud axis [1, ...] -> both clouds [size, ...];
        differentiable for floating tensors (bool and integer tensors
        travel as float32 and come back in their dtype)."""
        if x.is_floating_point():
            return _Gather.apply(x, self.group, self.index, self.size)
        with torch.no_grad():
            out = _Gather.apply(x.float(), self.group, self.index, self.size)
        return out > 0.5 if x.dtype == torch.bool else out.to(x.dtype)
