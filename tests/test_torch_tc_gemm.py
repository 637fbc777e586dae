"""The KPConv W products on the tensor cores (``pcrcg_tpu_torch/ops/
tc_gemm.py``, ``csrc/tc_gemm.cuh``): K2's phase B and K3's dW and gW.  The
arithmetic of the error-compensated TF32 product, the host-side split-K
planner at K2's and K3's main-path shapes, and the layouts' CPU contract,
on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here a plain emulation of its arithmetic shows that three TF32 products of
the split operands are fp32-grade where one TF32 pass is not, at the
shapes of K2's W contraction (K = 15 kernel points).
"""
import numpy as np
import pytest
import torch

from pcrcg_tpu_torch.ops.kpconv_tiled import (
    kpconv_tiled,
    kpconv_tiled_plain,
    kpconv_tiled_reduce,
)
from pcrcg_tpu_torch.ops.tc_gemm import (
    BK,
    MAX_SPLITS,
    MIN_K_TILES,
    TALL_SHARE,
    WAVES,
    GemmPlan,
    max_splits,
    plan_gemm,
    tc_gemm,
)

K_POINTS = 15


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's product: big = tf32(x), small = tf32(x − big) for both
    operands, three TF32 products (the small ones first), fp32 sums.  A
    TF32 product is exact in fp32 (11 × 11 significant bits)."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _operands(nq, c, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(nq, K_POINTS * c)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(K_POINTS * c, d)).astype(np.float32)
    return a, b


def test_tf32_rounding_matches_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11),
                      1.0 + 2.0**-12, 3.0e-30], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9, -(1.0 + 2.0**-10), 1.0,
                         float(tf32(torch.tensor([3.0e-30]))[0])], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, want)  # ties go away from zero, below half rounds down
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0


# K2's (C, D) pairs on the main path, at a few query counts.
@pytest.mark.parametrize("c,d,nq", [(1, 128, 200), (64, 64, 160), (128, 128, 128),
                                    (256, 256, 96), (512, 512, 64)])
def test_split_tf32_product_is_fp32_grade(c, d, nq):
    a, b = _operands(nq, c, d, seed=c + d)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(exact).max())
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def err(got):
        return float(np.abs(got.double().numpy() - exact).max()) / scale

    # Within 1e-5 of the largest entry, as an fp32 product lands ...
    assert err(split_tf32_matmul(ta, tb)) <= 1e-5
    assert err(ta @ tb) <= 1e-5
    # ... where one TF32 pass does not: a kernel that dropped the small
    # terms would fail the bound.
    assert err(tf32(ta) @ tf32(tb)) > 1e-5


# The GEMMs of the 11 KPConvs of one serving forward at the default
# Config(): (M = queries of both clouds, K = 15 C, N = D).
MAIN_PATH_GEMMS = [
    (53248, 15, 128), (53248, 960, 64), (18432, 960, 64), (18432, 1920, 128),
    (18432, 1920, 128), (5120, 1920, 128), (5120, 3840, 256), (5120, 3840, 256),
    (1536, 3840, 256), (1536, 7680, 512), (1536, 7680, 512),
]


# The 11 K3 calls of one training step at the default Config(): (Nq, C, D)
# per conv, block 0 (C = 1, the ones column) with dW only.
K3_CALLS = [
    (53248, 1, 128), (53248, 64, 64), (18432, 64, 64), (18432, 128, 128), (18432, 128, 128),
    (5120, 128, 128), (5120, 256, 256), (5120, 256, 256), (1536, 256, 256), (1536, 512, 512),
    (1536, 512, 512),
]
# Their products as (M, K, N) of op(A) [M, K] x op(B) [K, N]: dW [15 C, D]
# over Nq (both entries), the tiled gW [Nq, 15 C] and the gathered gW_t
# [15 C, Nq] over D.
K3_GEMMS = sorted({(15 * c, nq, d) for nq, c, d in K3_CALLS}
                  | {(nq, d, 15 * c) for nq, c, d in K3_CALLS if c > 1}
                  | {(15 * c, d, nq) for nq, c, d in K3_CALLS if c > 1})


@pytest.mark.parametrize("m,k,n", sorted(set(MAIN_PATH_GEMMS)) + K3_GEMMS)
def test_plan_fills_the_card_on_the_main_path(m, k, n):
    plan = plan_gemm(m, n, k, n_sm=132)
    assert plan.blocks(m, n) >= 132


@pytest.mark.parametrize("m,k,n", K3_GEMMS)
def test_plan_bounds_the_workspace(m, k, n):
    """The partials hold at most MAX_SPLITS outputs, or a TALL_SHARE-th of
    the operands where that is more (K3's dW), and never more than 48 MiB
    at K3's shapes."""
    plan = plan_gemm(m, n, k, n_sm=132)
    floats = plan.splits * m * n if plan.splits > 1 else 0
    assert floats <= max(MAX_SPLITS * m * n, k * (m + n) // TALL_SHARE)
    assert floats * 4 <= 48 * 2**20


def test_plan_fills_the_card_for_the_level_0_dw():
    """dW [960, 64] over 53,248 queries has 8 output tiles: the planner cuts
    the reduction into more than MAX_SPLITS partials to put WAVES blocks on
    each SM, where MAX_SPLITS partials would give 64 blocks for 132 SMs."""
    plan = plan_gemm(960, 64, 53248, n_sm=132)
    assert plan.splits > MAX_SPLITS
    assert plan.blocks(960, 64) >= WAVES * 132 * 0.95
    assert plan.splits <= max_splits(960, 64, 53248)


@pytest.mark.parametrize("m,k,n", sorted(set(MAIN_PATH_GEMMS)) + K3_GEMMS + [(300, 15, 128),
                                                                  (500, 960, 64),
                                                                  (64, 7680, 512),
                                                                  (1, 1, 1)])
def test_plan_partials_are_fixed_and_cover_the_reduction(m, k, n):
    plan = plan_gemm(m, n, k)
    assert plan == plan_gemm(m, n, k)  # a pure function of the shape
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + ((k, k),)):
        assert lo < hi == nxt or (hi == k and nxt == k)  # in order, none empty
        assert lo % BK == 0
    assert plan.k_chunk % BK == 0


@pytest.mark.parametrize("m,k,n", sorted(set(MAIN_PATH_GEMMS)) + K3_GEMMS + [(128, 64, 64),
                                                                            (300, 15, 128)])
def test_plan_splits_only_while_the_tiles_do_not_fill_the_card(m, k, n):
    plan = plan_gemm(m, n, k, n_sm=132)
    tiles = plan.blocks(m, n) // plan.splits
    k_tiles = -(-k // BK)
    assert 1 <= plan.splits <= max_splits(m, n, k)
    if plan.splits > 1:  # still short of the target before the last split
        assert tiles * (plan.splits - 1) < WAVES * 132
        assert plan.k_chunk // BK >= MIN_K_TILES
    else:  # the tiles alone fill it, or the reduction is too short to cut
        assert tiles >= WAVES * 132 or k_tiles < 2 * MIN_K_TILES


# The W products of one untiled forward at the default Config(): K6's
# and K7's out [N, D] = weighted_tᵀ x W, weighted_t stored [K·C, N] (the
# TRANS_A layout), as (M = N, K = 15 C, N = D); K7 reduces over its C
# feature rows only.
K6_K7_GEMMS = {
    "K6 block 0 (ones column)": (53248, 15, 128), "K6 L0 resnetb": (53248, 960, 64),
    "K7 L0 strided": (18432, 960, 64), "K6 L1 a": (18432, 1920, 128),
    "K6 L1 b": (18432, 1920, 128), "K7 L1 strided": (5120, 1920, 128),
    "K6 L2 a": (5120, 3840, 256), "K6 L2 b": (5120, 3840, 256),
    "K7 L2 strided": (1536, 3840, 256), "K6 L3 a": (1536, 7680, 512),
    "K6 L3 b": (1536, 7680, 512),
}


@pytest.mark.parametrize("m,k,n", list(K6_K7_GEMMS.values()), ids=list(K6_K7_GEMMS))
def test_plan_at_the_k6_k7_trans_a_shapes(m, k, n):
    """At each of the 11 products: the blocks fill the 132 SMs, the partials
    cover the reduction in a fixed order with none empty, and the workspace
    stays within MAX_SPLITS outputs (48 MiB at most)."""
    plan = plan_gemm(m, n, k, n_sm=132)
    assert plan == plan_gemm(m, n, k, n_sm=132)
    assert plan.blocks(m, n) >= 132
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(hi == nxt for (_, hi), (nxt, _) in zip(ranges, ranges[1:]))
    floats = plan.splits * m * n if plan.splits > 1 else 0
    assert floats <= MAX_SPLITS * m * n and floats * 4 <= 48 * 2**20
    if k < BK:  # block 0: one k-tile, its rows past K zero-filled
        assert plan == GemmPlan(1, BK)


def test_tc_gemm_trans_a_on_the_cpu_at_a_short_reduction():
    """K6's block 0: weighted_t [15, N] (K·C = 15, shorter than one k-tile)
    -> op(a) = weighted_tᵀ; the CPU branch is a.T @ b."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(K_POINTS, 300)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(K_POINTS, 128)).astype(np.float32))
    got = tc_gemm(a, b, plan_gemm(300, 128, K_POINTS), trans_a=True)
    assert got.shape == (300, 128)
    assert torch.equal(got, a.T @ b)


def test_plan_rejects_an_empty_product():
    with pytest.raises(ValueError):
        plan_gemm(0, 64, 64)


@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True)])
def test_tc_gemm_on_the_cpu_is_the_plain_product(trans_a, trans_b):
    """op(a) @ op(b) for each layout: a given [K, M] with trans_a (K3's
    dW = weighted^T g), b given [N, K] with trans_b (gW = g W^T)."""
    a, b = (torch.from_numpy(x) for x in _operands(37, 3, 20, seed=1))  # [37, 45], [45, 20]
    a_in = a.T.contiguous() if trans_a else a
    b_in = b.T.contiguous() if trans_b else b
    for plan in (None, GemmPlan(2, 32)):
        got = tc_gemm(a_in, b_in, plan, trans_a=trans_a, trans_b=trans_b)
        assert got.shape == (37, 20)
        assert torch.equal(got, a @ b)


def test_tc_gemm_takes_one_transposed_operand_at_most():
    a = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        tc_gemm(a, a, trans_a=True, trans_b=True)


def test_k2_on_the_cpu_is_phase_a_then_the_product():
    """kpconv_tiled = kpconv_tiled_reduce (weighted, nn), then weighted @ W:
    the split the card times phase by phase."""
    from pcrcg_tpu_torch.ops.subsample import morton_sort
    from pcrcg_tpu_torch.ops.tiled_search import radius_search_tiled

    rng = np.random.default_rng(3)
    ns, nq, c, d = 256, 60, 5, 7
    pts = torch.from_numpy(rng.uniform(0, 1, size=(ns, 3)).astype(np.float32))
    sup, mask = morton_sort(pts, torch.ones(ns, dtype=torch.bool))[:2]
    q = sup[torch.from_numpy(rng.permutation(ns)[:nq])]
    _, lidx, tiles = radius_search_tiled(q, sup, mask, 0.2, 16, tile=32, m_tiles=4,
                                         return_local=True)
    feats = torch.from_numpy(rng.normal(size=(ns, c)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(scale=0.05, size=(K_POINTS, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K_POINTS, c, d)).astype(np.float32))
    out, nn, weighted = kpconv_tiled(q, sup, feats, lidx, tiles, kp, w, 0.1, tile=32,
                                     keep_weighted=True)
    a_weighted, a_nn = kpconv_tiled_reduce(q, sup, feats, lidx, tiles, kp, K_POINTS, 0.1,
                                           tile=32)
    assert torch.equal(weighted, a_weighted) and torch.equal(nn, a_nn)
    assert torch.equal(out, a_weighted @ w.reshape(K_POINTS * c, d))
    p_out, p_nn = kpconv_tiled_plain(q, sup, feats, lidx, tiles, kp, w, 0.1, tile=32)
    assert torch.equal(out, p_out) and torch.equal(nn, p_nn)
    assert float(nn.min()) >= 1.0 and bool((weighted != 0).any())
