"""The KPConv W products on the tensor cores, in error-compensated TF32
(``csrc/tc_gemm.cuh``): K2's phase B, ``out = weighted @ W`` (entry
``pcrcg_tc_gemm`` of the K2 library ``csrc/kpconv_tiled.cu``), K6's and
K7's phase B, ``out = weighted_tᵀ @ W`` (``csrc/kpconv_fused.cu``, the
``trans_a`` layout), and K3's dW and gW, which ``csrc/kpconv_bwd.cu`` runs
in the transposed layouts (``trans_a``: A stored [K, M]; ``trans_b``: B
stored [N, K]).

``plan_gemm`` is the host-side planner: a pure function of the shape and
the device's SM count that picks the split-K factor for the kernel's
128 x 64 block tile, so that every call puts several waves of blocks in
flight, also where the output has few tiles and the reduction is long
(K3's dW).  The kernel sums the split-K partials in the plan's order,
which is fixed for a shape: the result is bit-identical run to run.
``tc_gemm`` runs ``op(a) @ op(b)`` (its plain version) for CPU tensors and
launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from pcrcg_tpu_torch import kernels

BM, BN = 128, 64  # block tile
BK = 32  # reduction rows per pipeline stage
MIN_K_TILES = 8  # reduction tiles a partial keeps, at least
MAX_SPLITS = 8  # partials of a short reduction, at most
TALL_SHARE = 4  # a tall reduction's partials hold at most 1 / TALL_SHARE of its operands
WAVES = 8  # blocks to aim for, per SM (four waves of two resident blocks)
H100_SMS = 132


class GemmPlan(NamedTuple):
    splits: int  # partial products, summed in order z = 0, 1, ...
    k_chunk: int  # reduction rows of each partial (a multiple of BK)

    def blocks(self, m: int, n: int) -> int:
        return -(-m // BM) * -(-n // BN) * self.splits

    def k_ranges(self, k: int):
        """The reduction rows of each partial, in summation order."""
        return tuple((z * self.k_chunk, min(k, (z + 1) * self.k_chunk))
                     for z in range(self.splits))


def max_splits(m: int, n: int, k: int) -> int:
    """The most partials ``plan_gemm`` cuts C[m, n] = A[m, k] @ B[k, n]
    into: ``MAX_SPLITS``, or more where their workspace (splits x m x n
    floats, written and read once more) stays within a ``TALL_SHARE``-th
    of the operands (k x (m + n) floats): the tall, narrow reductions of
    K3's dW ([960, 64] over 53,248 queries at level 0)."""
    return max(MAX_SPLITS, k * (m + n) // (TALL_SHARE * m * n))


def plan_gemm(m: int, n: int, k: int, n_sm: int = H100_SMS) -> GemmPlan:
    """Split-K for C[m, n] = A[m, k] @ B[k, n] on ``n_sm`` SMs: the kernel
    is bound by instruction throughput and latency with two blocks an SM
    resident, so the reduction is split until the 128 x 64 tiles give
    ``WAVES`` blocks an SM (the last, partial wave then costs little), at
    most ``max_splits`` partials of at least ``MIN_K_TILES`` tiles of
    ``BK`` rows each.  The layout (transposed operands) does not enter."""
    if min(m, n, k) <= 0:
        raise ValueError(f"empty GEMM {m} x {k} x {n}")
    tiles = -(-m // BM) * -(-n // BN)
    k_tiles = -(-k // BK)
    splits = min(-(-WAVES * n_sm // tiles), max_splits(m, n, k), k_tiles // MIN_K_TILES)
    per = -(-k_tiles // max(1, splits))
    return GemmPlan(-(-k_tiles // per), per * BK)  # no empty partial


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(m: int, n: int, k: int, device: torch.device) -> GemmPlan:
    """``plan_gemm`` for the SMs of ``device``."""
    return plan_gemm(m, n, k, sm_count(device.index))


def workspace(device: torch.device, *shaped_plans) -> Optional[torch.Tensor]:
    """Scratch for products run one after the other on one stream, each
    given as (plan, m, n): the largest splits x m x n of those that split,
    or None where none does."""
    floats = max((p.splits * m * n for p, m, n in shaped_plans if p.splits > 1), default=0)
    return torch.empty(floats, device=device, dtype=torch.float32) if floats else None


def tc_gemm(a: torch.Tensor, b: torch.Tensor, plan: Optional[GemmPlan] = None,
            trans_a: bool = False, trans_b: bool = False) -> torch.Tensor:
    """op(a) [M, K] f32 @ op(b) [K, N] f32 -> [M, N] f32, where op(a) is a
    [M, K], or its transpose for ``trans_a`` (a [K, M]), and op(b) is b
    [K, N], or its transpose for ``trans_b`` (b [N, K]); not both.  On the
    card: the 3xTF32 tensor-core kernel on ``plan`` (default ``plan_gemm``
    for the device); fp32-grade, deterministic.  On the CPU: the plain
    product."""
    if trans_a and trans_b:
        raise ValueError("tc_gemm transposes one operand at most")
    opa, opb = (a.T if trans_a else a), (b.T if trans_b else b)
    if a.device.type == "cpu":
        return opa @ opb
    dev = a.device
    m, k = opa.shape
    n = opb.shape[1]
    kernels.require(a, "a", torch.float32, dev)
    kernels.require(b, "b", torch.float32, dev, (n, k) if trans_b else (k, n))
    if plan is None:
        plan = plan_for(m, n, k, dev)
    out = torch.empty(m, n, device=dev, dtype=torch.float32)
    ws = workspace(dev, (plan, m, n))
    err = kernels.bind("kpconv_tiled", "pcrcg_tc_gemm", "pppiiiiiiipp")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(trans_a), int(trans_b),
        plan.splits, plan.k_chunk, None if ws is None else ws.data_ptr(),
        kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "tc_gemm")
    return out
