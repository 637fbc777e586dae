"""K2's phase B: the W contraction ``out = weighted @ W`` on the tensor
cores, in error-compensated TF32 (``csrc/tc_gemm.cuh``, entry
``pcrcg_tc_gemm`` of the K2 library ``csrc/kpconv_tiled.cu``).

``plan_gemm`` is the host-side planner: a pure function of the shape and
the device's SM count that picks the split-K factor for the kernel's
128 x 64 block tile, so that every call puts several waves of blocks in
flight.  The kernel sums the split-K partials in the plan's order, which
is fixed for a shape: the result is bit-identical run to run.  ``tc_gemm`` runs ``a @ b`` (its plain
version) for CPU tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from pcrcg_tpu_torch import kernels

BM, BN = 128, 64  # block tile
BK = 32  # reduction rows per pipeline stage
MIN_K_TILES = 8  # reduction tiles a partial keeps, at least
MAX_SPLITS = 8
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


def plan_gemm(m: int, n: int, k: int, n_sm: int = H100_SMS) -> GemmPlan:
    """Split-K for C[m, n] = A[m, k] @ B[k, n] on ``n_sm`` SMs: the kernel
    is bound by instruction throughput and latency with two blocks an SM
    resident, so the reduction is split until the 128 x 64 tiles give
    ``WAVES`` blocks an SM (the last, partial wave then costs little), at
    most ``MAX_SPLITS`` partials of at least ``MIN_K_TILES`` tiles of
    ``BK`` rows each."""
    if min(m, n, k) <= 0:
        raise ValueError(f"empty GEMM {m} x {k} x {n}")
    tiles = -(-m // BM) * -(-n // BN)
    k_tiles = -(-k // BK)
    splits = min(-(-WAVES * n_sm // tiles), MAX_SPLITS, k_tiles // MIN_K_TILES)
    per = -(-k_tiles // max(1, splits))
    return GemmPlan(-(-k_tiles // per), per * BK)  # no empty partial


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tc_gemm(a: torch.Tensor, b: torch.Tensor, plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """a [M, K] f32 @ b [K, N] f32 -> [M, N] f32.  On the card: the 3xTF32
    tensor-core kernel on ``plan`` (default ``plan_gemm`` for the device);
    fp32-grade, deterministic.  On the CPU: ``a @ b``."""
    if a.device.type == "cpu":
        return a @ b
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    kernels.require(a, "a", torch.float32, dev)
    kernels.require(b, "b", torch.float32, dev, (k, n))
    if plan is None:
        plan = plan_gemm(m, n, k, _sm_count(dev.index))
    out = torch.empty(m, n, device=dev, dtype=torch.float32)
    ws = (torch.empty(plan.splits, m, n, device=dev, dtype=torch.float32)
          if plan.splits > 1 else None)
    err = kernels.bind("kpconv_tiled", "pcrcg_tc_gemm", "pppiiiiipp")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, plan.splits, plan.k_chunk,
        None if ws is None else ws.data_ptr(), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "tc_gemm")
    return out
