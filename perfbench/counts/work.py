"""Operations and bytes of the algorithm, from shapes and real counts.

What is counted is the algorithm's work on real rows and real neighbors,
whatever implements it: a product counted once (2 operations a
multiply-add), each distinct input byte read once and each output byte
written once (float32 and int32, 4 bytes).  The peaks are NVIDIA's data
sheet's for one H100 SXM (``peaks.json``): the TF32 dense rate, the highest
at which the card multiplies float32 inputs, and the HBM bandwidth.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
FLOPS_PEAK = PEAKS["tf32_flops_per_s"]
BYTES_PEAK = PEAKS["hbm_bytes_per_s"]
F = 4  # bytes of a float32 or an int32

# One kernel point's influence on one (query, neighbor) pair: the offset
# from the kernel point (3), its squared norm (5), the square root, the
# scale, the subtraction and the clamp of the linear influence (4).
INFLUENCE_OPS = 12


def kpconv_forward(nq: int, ns: int, edges: int, c: int, d: int, k: int) -> Tuple[int, int]:
    """(operations, bytes) of one rigid KPConv forward: ``nq`` real
    queries, ``ns`` real supports, ``edges`` real (query, neighbor) pairs,
    C in, D out, K kernel points.  Influences, the weighted sum over the
    neighbors [Nq, K, C] and the W product [Nq, K C] x [K C, D]."""
    ops = edges * k * INFLUENCE_OPS + 2 * edges * k * c + 2 * nq * k * c * d
    # Reads: query and support points, support features, the neighbor
    # lists' real entries, kernel points, W; writes: the output.
    nbytes = F * (3 * nq + 3 * ns + ns * c + edges + 3 * k + k * c * d + nq * d)
    return ops, nbytes


def kpconv_backward(nq: int, ns: int, edges: int, c: int, d: int, k: int,
                    input_grad: bool) -> Tuple[int, int]:
    """(operations, bytes) of one rigid KPConv backward: dW = weighted^T g
    always; with ``input_grad`` also g W^T [Nq, K C] and its scatter onto
    the support features through the influences."""
    ops = 2 * nq * k * c * d
    # Reads: g, W, the weighted sum (kept or made again); writes: dW.
    nbytes = F * (nq * d + k * c * d + nq * k * c + k * c * d)
    if input_grad:
        ops += 2 * nq * k * c * d + edges * k * INFLUENCE_OPS + 2 * edges * k * c
        # Reads: the geometry and neighbor lists; writes: the features' gradient.
        nbytes += F * (3 * nq + 3 * ns + edges + ns * c)
    return ops, nbytes


def least_seconds(ops: int, nbytes: int) -> float:
    """The least time the card could take: bound by operations or bytes."""
    return max(ops / FLOPS_PEAK, nbytes / BYTES_PEAK)


def dense(rows: float, c_in: int, c_out: int) -> float:
    """A linear layer (or 1x1 convolution) over ``rows`` real rows."""
    return 2.0 * rows * c_in * c_out


def conv2d(batch: int, c_in: int, c_out: int, kh: int, kw: int, h_out: int, w_out: int,
           groups: int = 1) -> float:
    return 2.0 * batch * h_out * w_out * c_out * (c_in // groups) * kh * kw


def attention(n_q: int, n_k: int, d_model: int) -> float:
    """The two products of attention (scores q k^T and the weighted values),
    over all heads."""
    return 2.0 * (2.0 * n_q * n_k * d_model)


def matching(n: int, m: int, d: int) -> float:
    """Nearest neighbors in feature space by an [n, d] x [d, m] product."""
    return 2.0 * n * m * d


def ransac(n_corr: int, n_hyp: int) -> float:
    """Scoring every hypothesis on every correspondence: the squared
    residual as one [n, 16] x [16, H] product plus its compare."""
    return 2.0 * 16 * n_corr * n_hyp + n_corr * n_hyp
