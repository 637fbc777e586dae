"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device.  On a machine with a GPU and nvcc (``--noconftest``: the suite's
conftest imports JAX, which the port does not need):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

from pcrcg_tpu_torch.ops.kpconv_fused import (
    kpconv_fused,
    kpconv_fused_bwd,
    kpconv_fused_bwd_plain,
    kpconv_fused_merged,
    kpconv_fused_merged_plain,
    kpconv_fused_plain,
    kpconv_gathered_reduce,
    kpconv_gathered_reduce_plain,
)
from pcrcg_tpu_torch.ops.kpconv_pallas import (
    kpconv_weighted_reduce,
    kpconv_weighted_reduce_plain,
)
from pcrcg_tpu_torch.ops.kpconv_tiled import (
    kpconv_tiled,
    kpconv_tiled_ad,
    kpconv_tiled_bwd,
    kpconv_tiled_bwd_plain,
    kpconv_tiled_plain,
    kpconv_tiled_reduce,
    max_pool_tiled,
    maxpool_bwd,
    maxpool_bwd_plain,
)
from pcrcg_tpu_torch.ops.tc_gemm import BK, GemmPlan, plan_gemm, tc_gemm
from pcrcg_tpu_torch.ops.search_kernel import (
    tiled_min_dist_sq,
    tiled_min_dist_sq_plain,
    tiled_search,
    tiled_search_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cloud(rng, n, scale=3.0):
    from pcrcg_tpu_torch.ops.subsample import morton_sort

    pts = torch.from_numpy(rng.uniform(0, scale, size=(n, 3)).astype(np.float32))
    return morton_sort(pts, torch.ones(n, dtype=torch.bool))[:2]


def _search_clouds(case, ns, scale=3.0):
    """Two Z-ordered clouds, masks and 200 queries each (torch, CPU) for the
    tiled search: "ties" / "nearest" hold every point twice (exact ties),
    "dense" puts 300 points in a 3 cm ball (more candidates within the
    radius than the kernel's 128-entry survivor buffer), "pads" masks
    scattered supports; the queries are support points with a little noise
    ("ties": exactly on them), 200 a cloud (pad-query rows)."""
    from pcrcg_tpu_torch.ops.subsample import morton_sort

    clouds, masks, queries = [], [], []
    for seed in (11, 12):
        r = np.random.default_rng(seed)
        pts = r.uniform(0, scale, size=(ns, 3)).astype(np.float32)
        if case in ("ties", "nearest"):
            pts[1::2] = pts[::2]
        elif case == "dense":
            pts[:300] = (0.5 * scale + r.uniform(-0.015, 0.015, size=(300, 3))).astype(np.float32)
        sup, mask = morton_sort(torch.from_numpy(pts), torch.ones(ns, dtype=torch.bool))[:2]
        if case == "pads":
            mask[::13] = False
        q = sup[torch.from_numpy(r.permutation(ns)[:200])]
        if case != "ties":
            q = q + torch.from_numpy(r.normal(scale=0.01, size=q.shape).astype(np.float32))
        clouds.append(sup)
        masks.append(mask)
        queries.append(q)
    return torch.stack(queries), torch.stack(clouds), torch.stack(masks)


def _recorded(monkeypatch, module, name):
    """Record the arguments of ``module.name`` while calling it."""
    calls, real = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(a) or real(*a))
    return calls


# (case, k, tile, m_tiles, ns, scale): "random" at scale 1 m has ~100
# candidates within the radius (past the k = 40 buffer's first fill).
SEARCH_CASES = [
    ("random", 40, 128, 12, 2560, 1.0),
    ("random", 1, 128, 4, 2560, 1.0),
    ("ties", 9, 32, 6, 640, 3.0),
    ("dense", 40, 32, 8, 640, 3.0),
    ("dense", 100, 32, 8, 640, 3.0),
    ("nearest", 1, 32, 4, 640, 3.0),
    ("pads", 16, 32, 6, 640, 3.0),
]


@pytest.mark.parametrize("case,k,tile,m_tiles,ns,scale", SEARCH_CASES)
def test_k1_fused_search_matches_plain_chain(cuda, monkeypatch, case, k, tile, m_tiles, ns,
                                             scale):
    """The fused K1 (distances, top-k, cutoff, mapping in one launch)
    against its plain chain on the same card inputs: idx and lidx equal,
    and equal again on a second run; both clouds in one launch."""
    import pcrcg_tpu_torch.ops.tiled_search as tts

    qs, clouds, masks = _search_clouds(case, ns, scale)
    calls = _recorded(monkeypatch, tts, "tiled_search")
    idx, lidx, _ = tts.radius_search_tiled_batch(
        qs.to(cuda), clouds.to(cuda), masks.to(cuda), 0.33, k, tile=tile, m_tiles=m_tiles,
        return_local=True,
    )
    (args,) = calls
    want_idx, want_lidx = tiled_search_plain(*args)
    again_idx, again_lidx = tiled_search(*args)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int64 and lidx.dtype == torch.int32
    assert torch.equal(idx, want_idx) and torch.equal(lidx, want_lidx)
    assert torch.equal(again_idx, idx) and torch.equal(again_lidx, lidx)
    cand = m_tiles * tile
    in_radius = (tiled_search_plain(*args[:3], cand, *args[4:])[1] < cand).sum(-1)
    if case == "dense":
        assert int(in_radius.max()) > 128  # the survivor buffer overflowed
    if case == "random" and k > 1:
        assert int(in_radius.max()) > k


@pytest.mark.parametrize("case", ["random", "ties", "dense"])
def test_k1_value_mode_is_bit_equal_to_amin(cuda, monkeypatch, case):
    import pcrcg_tpu_torch.ops.tiled_search as tts

    qs, clouds, masks = _search_clouds(case, 640)
    calls = _recorded(monkeypatch, tts, "tiled_min_dist_sq")
    got = tts.min_dist_sq_tiled(qs[0].to(cuda), clouds[0].to(cuda), masks[0].to(cuda),
                                tile=32, m_tiles=6)
    (args,) = calls
    want = tiled_min_dist_sq_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (200,) and torch.equal(got, want)


CASES = [
    ("linear", "sum", 1, 128),
    ("linear", "sum", 64, 64),
    ("gaussian", "sum", 128, 128),
    ("constant", "sum", 8, 16),
    ("linear", "closest", 256, 256),
    ("linear", "sum", 512, 512),
]


def _conv_inputs(cuda, c, d, seed=1, ns=2048, nq=500, h=40, tile=128):
    """Geometry from the tiled search, features, kernel points and W, on
    the card: (q, sup, feats, lidx, tiles, kp, w, gidx)."""
    from pcrcg_tpu_torch.ops.tiled_search import radius_search_tiled

    rng = np.random.default_rng(seed)
    sup, mask = _cloud(rng, ns, scale=1.0)
    q = sup[torch.from_numpy(rng.permutation(ns)[:nq])]
    gidx, lidx, tiles = radius_search_tiled(q, sup, mask, 0.08, h, tile=tile, m_tiles=6,
                                            return_local=True)
    feats = torch.from_numpy(rng.normal(size=(ns, c)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(scale=0.05, size=(15, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(15, c, d)).astype(np.float32))
    return [t.to(cuda).contiguous() for t in (q, sup, feats, lidx, tiles, kp, w, gidx)]


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)


# Block 0 of the color model: C = in_feats_dim = 129 (a reduction of
# K·C = 1,935, not a multiple of 4: tc_gemm's scalar-load path), D = 128.
BLOCK0_IMAGES = [("linear", "sum", 129, 128)]


@pytest.mark.parametrize("influence,aggregation,c,d", CASES + BLOCK0_IMAGES)
def test_k2_kernel_matches_plain(cuda, influence, aggregation, c, d):
    args = _conv_inputs(cuda, c, d)[:7]
    got_out, got_nn = kpconv_tiled(*args, 0.06, influence, aggregation)
    want_out, want_nn = kpconv_tiled_plain(*args, 0.06, influence, aggregation)
    torch.cuda.synchronize()
    same = got_nn == want_nn
    assert float(same.float().mean()) >= 0.999
    got, want = (got_out / got_nn[:, None])[same], (want_out / want_nn[:, None])[same]
    # fp32 sums over H neighbors and K·C products in another order.
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("influence,aggregation,c,d", CASES + BLOCK0_IMAGES)
def test_k3_kernel_matches_plain(cuda, influence, aggregation, c, d):
    """K3's candidate-tile entry (with K4's scatter folded in) against K3's
    then K4's plain versions: dW, and ds unless ``need_ds`` is off."""
    q, sup, feats, lidx, tiles, kp, w, _ = _conv_inputs(cuda, c, d, seed=2)
    _, _, weighted = kpconv_tiled_plain(q, sup, feats, lidx, tiles, kp, w, 0.06, influence,
                                        aggregation, keep_weighted=True)
    g = torch.randn(q.shape[0], d, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    for need_ds in (True, False):
        args = (q, sup, lidx, tiles, kp, w, g, weighted, 0.06, influence, aggregation, 128)
        dw, ds = kpconv_tiled_bwd(*args, need_ds=need_ds)
        want_dw, want_ds = kpconv_tiled_bwd_plain(*args, need_ds=need_ds)
        torch.cuda.synchronize()
        # fp32 sums over Nq (dW, split into partials) and D (gW) in
        # another order than cuBLAS's; ds in atomics' order.
        assert _rel_err(dw, want_dw) <= 1e-4
        assert (ds is None) == (not need_ds)
        if need_ds:
            assert _rel_err(ds, want_ds) <= 1e-4


@pytest.mark.parametrize("c", [1, 64, 257])
def test_k4_fused_scatter_matches_plain(cuda, c):
    """K4's scatter inside K3's entry, at a width of one channel, a warp's
    multiple and a ragged one, with the influences of real geometry:
    ds against the plain K3 then K4, and no row gets a shadow's share."""
    q, sup, _, lidx, tiles, kp, _, _ = _conv_inputs(cuda, 4, 4, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.randn(15, c, 24, device=cuda, generator=gen)
    g = torch.randn(q.shape[0], 24, device=cuda, generator=gen)
    weighted = torch.randn(q.shape[0], 15 * c, device=cuda, generator=gen)
    args = (q, sup, lidx, tiles, kp, w, g, weighted, 0.06)
    _, got = kpconv_tiled_bwd(*args)
    _, want = kpconv_tiled_bwd_plain(*args)
    torch.cuda.synchronize()
    # Atomic sums over ~H terms per row; gW in 3xTF32.
    assert _rel_err(got, want) <= 1e-4
    from pcrcg_tpu_torch.ops.kpconv_common import support_rows

    row, valid = support_rows(lidx, tiles, q.shape[0], sup.shape[0], 128)
    unseen = torch.ones(sup.shape[0], dtype=torch.bool, device=cuda)
    unseen[row[valid]] = False
    assert not bool(got[unseen].any())


@pytest.mark.parametrize("c", [1, 64, 129, 257])
def test_k4_fused_scatter_matches_float64(cuda, c):
    """K4's scatter inside K3's entry against the plain K3 then K4 in
    float64: ds within 1e-5 of its largest entry (fp32 atomics, gW in
    3xTF32)."""
    q, sup, _, lidx, tiles, kp, _, _ = _conv_inputs(cuda, 4, 4, seed=5)
    gen = torch.Generator(device=cuda).manual_seed(2)
    w = torch.randn(15, c, 24, device=cuda, generator=gen)
    g = torch.randn(q.shape[0], 24, device=cuda, generator=gen)
    weighted = torch.randn(q.shape[0], 15 * c, device=cuda, generator=gen)
    _, got = kpconv_tiled_bwd(q, sup, lidx, tiles, kp, w, g, weighted, 0.06)
    f64 = [t.double() for t in (q, sup)] + [lidx, tiles] + [t.double() for t in
                                                            (kp, w, g, weighted)]
    _, want = kpconv_tiled_bwd_plain(*f64, 0.06)
    torch.cuda.synchronize()
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("dtype,denom", [(np.uint8, 255.0), (np.uint16, 1000.0)])
def test_exact_div_on_cuda_equals_numpy(cuda, dtype, denom):
    """The color branch's dequantization on the card, every value."""
    from pcrcg_tpu_torch.models.lift import _exact_div

    x = np.arange(np.iinfo(dtype).max + 1, dtype=dtype)
    got = _exact_div(torch.from_numpy(x).to(cuda), denom).cpu().numpy()
    np.testing.assert_array_equal(got, x.astype(np.float32) / np.float32(denom))


def test_backbone_convolutions_run_in_ieee_fp32(cuda):
    """With the process allowing TF32 for cuDNN and cuBLAS, the 2D backbone
    still convolves and resizes in IEEE fp32: its output is bit for bit the
    one with TF32 disallowed, within 1e-5 of the CPU's, and the process's
    flags are as they were after the call."""
    from pcrcg_tpu_torch.models.resunet import ResUNet

    model = ResUNet(32, 18)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 64, 80, 3))
                         .astype(np.float32))
    with torch.no_grad():
        want = model(x)
        model = model.to(cuda)
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            loose = model(x.to(cuda))
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            strict = model(x.to(cuda))
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(loose, strict)
    assert float((strict.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("c", [3, 128])
def test_k5_kernel_matches_plain(cuda, c):
    from pcrcg_tpu_torch.ops.masked import pad_gather

    _, sup, feats, _, _, _, _, gidx = _conv_inputs(cuda, c, 4, seed=4)
    out, amax = pad_gather(feats, gidx, 0.0).max(dim=1)
    g = torch.randn_like(out)
    got = maxpool_bwd(g, amax, gidx, sup.shape[0])
    want = maxpool_bwd_plain(g, amax, gidx, sup.shape[0])
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-5


def _forced_split(k, splits):
    """A plan cutting the reduction into ``splits`` partials."""
    k_tiles = -(-k // BK)
    per = -(-k_tiles // splits)
    return GemmPlan(-(-k_tiles // per), per * BK)


# Phase B's edges: ragged Nq (not a multiple of 128), K·C = 15 (60-byte
# rows: the 4-byte copy path), D not a multiple of 4 (the same), a forced
# split-K, and the widest main-path conv.
@pytest.mark.parametrize("nq,c,d,splits", [(300, 1, 128, None), (500, 64, 64, 3),
                                           (333, 8, 18, None), (1000, 512, 512, None)])
def test_k2_tensor_core_product_edges(cuda, nq, c, d, splits):
    q, sup, feats, lidx, tiles, kp, w, _ = _conv_inputs(cuda, c, d, seed=8, nq=nq)
    want_out, want_nn = kpconv_tiled_plain(q, sup, feats, lidx, tiles, kp, w, 0.06)
    weighted, nn = kpconv_tiled_reduce(q, sup, feats, lidx, tiles, kp, 15, 0.06)
    w2 = w.reshape(15 * c, d)
    plan = plan_gemm(nq, d, 15 * c) if splits is None else _forced_split(15 * c, splits)
    assert splits is None or plan.splits == splits
    out = tc_gemm(weighted, w2, plan)
    full_out, full_nn = kpconv_tiled(q, sup, feats, lidx, tiles, kp, w, 0.06)
    torch.cuda.synchronize()
    assert torch.equal(nn, full_nn)
    same = nn == want_nn
    assert float(same.float().mean()) >= 0.999
    for got in (out, full_out):
        assert _rel_err((got / nn[:, None])[same], (want_out / want_nn[:, None])[same]) <= 1e-4
    # fp32-grade: the three TF32 products keep the small terms.
    exact = weighted.double() @ w2.double()
    assert float((out.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


def test_k2_is_bit_identical_run_to_run(cuda):
    """Phase A has no atomics on floats and the split-K partials are summed
    in a fixed order, so two runs agree bit for bit."""
    args = _conv_inputs(cuda, 512, 512, seed=9, nq=1536)[:7]
    assert plan_gemm(1536, 512, 15 * 512).splits > 1
    first = kpconv_tiled(*args, 0.06, keep_weighted=True)
    second = kpconv_tiled(*args, 0.06, keep_weighted=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# Each layout K3 runs, at main-path shapes and ragged ones: (layout, M, N,
# K) of op(A) [M, K] x op(B) [K, N]; "ta": A stored [K, M], "tb": B stored
# [N, K].
LAYOUT_CASES = [
    ("ta", 960, 64, 53248),  # tiled dW at level 0: the longest reduction
    ("ta", 15, 128, 53248),  # block 0's dW: 60-byte rows (the 4-byte path)
    ("ta", 7680, 512, 1536),  # tiled dW at level 3
    ("tb", 53248, 960, 64),  # tiled gW at level 0
    ("tb", 1536, 7680, 512),  # tiled gW at level 3
    ("tb", 960, 5000, 64),  # gathered gW_t, ragged N
    ("nn", 960, 64, 53248),  # gathered dW at level 0
    ("tb", 333, 18, 21),  # ragged in every dimension (the 4-byte path)
    ("ta", 53248, 128, 15),  # K6's block 0: K·C = 15, less than one k-tile
    ("ta", 300, 128, 15),  # the same, ragged N (the 4-byte path)
    ("ta", 1536, 512, 7680),  # K6 at level 3: the longest W reduction
]


@pytest.mark.parametrize("layout,m,n,k", LAYOUT_CASES)
def test_tc_gemm_layouts_match_float64(cuda, layout, m, n, k):
    """fp32-grade in every layout: within 1e-5 of the largest entry of the
    float64 product.  In the dW cases (the reductions over queries, K >
    1000) A stands for K3's ``weighted`` and is nonnegative, so the long
    sums do not cancel."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    trans_a, trans_b = layout == "ta", layout == "tb"
    a = torch.randn(*((k, m) if trans_a else (m, k)), device=cuda, generator=gen)
    a = a.abs() if k > 1000 else a
    b = 0.1 * torch.randn(*((n, k) if trans_b else (k, n)), device=cuda, generator=gen)
    got = tc_gemm(a, b, trans_a=trans_a, trans_b=trans_b)
    exact = (a.double().T if trans_a else a.double()) @ (b.double().T if trans_b else b.double())
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    assert float((got.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


def test_k3_dw_is_bit_identical_run_to_run(cuda):
    """dW's split-K partials are summed in a fixed order, in both entries:
    two runs agree bit for bit (ds, by atomics, need not)."""
    q, sup, feats, lidx, tiles, kp, w, _ = _conv_inputs(cuda, 64, 64, seed=13, nq=2000)
    _, _, weighted = kpconv_tiled_plain(q, sup, feats, lidx, tiles, kp, w, 0.06,
                                        keep_weighted=True)
    g = torch.randn(q.shape[0], 64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    assert plan_gemm(15 * 64, 64, q.shape[0]).splits > 1
    args = (q, sup, lidx, tiles, kp, w, g, weighted, 0.06)
    assert torch.equal(kpconv_tiled_bwd(*args)[0], kpconv_tiled_bwd(*args)[0])
    rel, nx_t, _, _, kp, w, _ = _gathered_inputs(cuda, 64, 64, seed=13)
    g = g[:rel.shape[0]].contiguous()
    args = (rel, nx_t, g, kp, w, 0.06)
    assert torch.equal(kpconv_fused_bwd(*args)[1], kpconv_fused_bwd(*args)[1])


@pytest.mark.parametrize("c,merged", [(1, False), (64, False), (64, True)])
def test_k3_gathered_dw_is_bit_identical_with_the_new_phase_a(cuda, c, merged):
    """K3's gathered entry recomputes `weighted` with K6's phase A: at C = 1
    (256 queries a block), C = 64 (two channel blocks) and over the merged
    gather (rel from its coordinates, all 8 + C rows, as the merged
    backward runs it), dW is bit for bit the same on two runs."""
    from pcrcg_tpu_torch.ops.kpconv_fused import _merged_rel

    rel, nx_t, nxc_t, q, kp, w, w8 = _gathered_inputs(cuda, c, 32, seed=15)
    if merged:
        rel, nx_t, w = _merged_rel(q, nxc_t).contiguous(), nxc_t, w8
    g = torch.randn(rel.shape[0], 32, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    args = (rel, nx_t, g, kp, w, 0.06)
    first, second = kpconv_fused_bwd(*args)[1], kpconv_fused_bwd(*args)[1]
    want = kpconv_fused_bwd_plain(*args)[1]
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _rel_err(first, want) <= 1e-4


def test_tc_gemm_rejects_bad_arguments(cuda):
    a = torch.zeros(10, 8, device=cuda)
    with pytest.raises(ValueError):
        tc_gemm(a, torch.zeros(9, 4, device=cuda))
    with pytest.raises(ValueError):  # trans_b: b is [N, K]
        tc_gemm(a, torch.zeros(8, 4, device=cuda), trans_b=True)
    with pytest.raises(ValueError):
        tc_gemm(a, torch.zeros(10, 4, device=cuda), trans_a=True, trans_b=True)
    with pytest.raises(ValueError):
        tc_gemm(a, torch.zeros(8, 4, device=cuda, dtype=torch.float64))
    with pytest.raises(RuntimeError):  # a plan whose partials do not cover K
        tc_gemm(a, torch.zeros(8, 4, device=cuda), GemmPlan(1, 0))


def test_k5_routes_ties_to_the_first_maximum_and_drops_shadows(cuda):
    """Built ties (a row listed twice, two rows with equal features) and
    shadow slots, including queries whose maximum is a shadow's 0."""
    rng = np.random.default_rng(10)
    ns, nq, h, c = 96, 70, 40, 37
    x = torch.from_numpy(rng.normal(size=(ns, c)).astype(np.float32))
    x[1] = x[0]  # rows 0 and 1 tie everywhere
    x[80:] = -x[80:].abs() - 0.5  # all negative: a shadow (0.0) wins
    inds = torch.from_numpy(rng.integers(2, ns, size=(nq, h)))
    inds[:, 5:9] = ns  # shadow slots
    inds[:10, 0], inds[:10, 1] = 0, 1
    inds[10:20, 2], inds[10:20, 3] = 7, 7
    inds[20:30] = torch.from_numpy(rng.integers(80, ns, size=(10, h)))
    inds[20:30, 20:] = ns
    x, inds = x.to(cuda), inds.to(cuda)
    from pcrcg_tpu_torch.ops.masked import pad_gather

    _, amax = pad_gather(x, inds, 0.0).max(dim=1)
    assert bool((inds.gather(1, amax)[20:30] == ns).all())  # maxima on a shadow
    g = torch.randn(nq, c, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    got = maxpool_bwd(g, amax, inds, ns)
    want = maxpool_bwd_plain(g, amax, inds, ns)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-5
    assert float(got[1].abs().max()) == 0.0  # the tie went to row 0, listed first


def _ad_grads(args, influence="linear", aggregation="sum"):
    q, sup, feats, lidx, tiles, kp, w = args
    feats = feats.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    out, _ = kpconv_tiled_ad(q, sup, feats, lidx, tiles, kp, w, 0.06, influence, aggregation)
    g = torch.linspace(-1.0, 1.0, out.numel(), device=out.device).reshape(out.shape)
    (out * g).sum().backward()
    return feats.grad, w.grad


@pytest.mark.parametrize("influence,aggregation,c,d", CASES[1:5])
def test_kpconv_tiled_ad_grads_match_cpu(cuda, influence, aggregation, c, d):
    args = _conv_inputs(cuda, c, d, seed=5)[:7]
    from pcrcg_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    got_f, got_w = _ad_grads(args, influence, aggregation)
    assert kernels.LAUNCHES["K3"] == before["K3"] + 1
    assert kernels.LAUNCHES["K4"] == before["K4"] + 1
    want_f, want_w = _ad_grads([t.cpu() for t in args], influence, aggregation)
    assert _rel_err(got_f.cpu(), want_f) <= 1e-4
    assert _rel_err(got_w.cpu(), want_w) <= 1e-4


def test_max_pool_tiled_grads_match_cpu(cuda):
    _, sup, feats, _, _, _, _, gidx = _conv_inputs(cuda, 32, 4, seed=6)

    def grads(x, inds):
        x = x.clone().requires_grad_(True)
        out = max_pool_tiled(x, inds)
        g = torch.linspace(-1.0, 1.0, out.numel(), device=x.device).reshape(out.shape)
        (out * g).sum().backward()
        return out.detach(), x.grad

    out, g = grads(feats, gidx)
    want_out, want_g = grads(feats.cpu(), gidx.cpu())
    assert torch.equal(out.cpu(), want_out)
    assert _rel_err(g.cpu(), want_g) <= 1e-5


def test_kpconv_weights_get_a_gradient_on_cuda(cuda):
    """A KPConv layer on the card passes the gradient to its weights and
    its input (its output was once detached from autograd there)."""
    from pcrcg_tpu_torch.models.kpconv import KPConv

    q, sup, feats, lidx, tiles, kp, w, gidx = _conv_inputs(cuda, 16, 24, seed=7)
    conv = KPConv(16, 24, radius=0.08, kp_extent=0.06).to(cuda)
    with torch.no_grad():
        conv.weights.copy_(w)
        conv.kernel_points.copy_(kp)
    x = feats[None].clone().requires_grad_(True)
    out = conv(q[None], sup[None], gidx[None], x, tile_meta=(lidx[None], tiles[None]))
    out.square().sum().backward()
    assert conv.weights.grad is not None and float(conv.weights.grad.abs().sum()) > 0
    assert x.grad is not None and float(x.grad.abs().sum()) > 0


def test_wrappers_reject_bad_arguments(cuda):
    q = torch.zeros(128, 3, device=cuda)
    supa = torch.zeros(2, 4, 32, device=cuda)
    sel = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tiled_search(q, supa, sel.long(), 4, 0.1, 100, 64)
    with pytest.raises(ValueError):
        tiled_search(q.double(), supa, sel, 4, 0.1, 100, 64)
    with pytest.raises(ValueError):  # k past the 64 candidates
        tiled_search(q, supa, sel, 65, 0.1, 100, 64)
    with pytest.raises(ValueError):  # candidates past a block's shared memory
        big = torch.zeros(400, 4, 128, device=cuda)
        tiled_min_dist_sq(q, big, torch.zeros(1, 400, dtype=torch.int32, device=cuda), 100)


def _gathered_inputs(cuda, c, d, seed, apart=False):
    """The inputs of the gathered-feature kernels on the card: rel [Nq, H, 3]
    (shadow at PAD_COORD − q), nx_t [H, C, Nq], the merged gather nxc_t
    [H, 8 + C, Nq], q, kernel points, W and W8 = [0₈ | W].  ``apart``: each
    support's features shifted so their sum sits at least 0.5 from zero
    (neighbor counts then agree in any summation order)."""
    from pcrcg_tpu_torch.ops.masked import PAD_COORD, pad_gather

    q, sup, feats, _, _, kp, w, gidx = _conv_inputs(cuda, c, d, seed=seed)
    if apart:
        feats = feats + torch.sign(feats.sum(1, keepdim=True)) * 0.5 / c
    rel = (pad_gather(sup, gidx, PAD_COORD) - q[:, None, :]).contiguous()
    nx_t = pad_gather(feats, gidx, 0.0).permute(1, 2, 0).contiguous()
    base = torch.cat([sup, sup.new_zeros(sup.shape[0], 5), feats], 1)
    nxc_t = pad_gather(base, gidx, 0.0).permute(1, 2, 0).contiguous()
    w8 = torch.cat([w.new_zeros(w.shape[0], 8, d), w], 1).contiguous()
    return rel, nx_t, nxc_t, q, kp, w, w8


def _same_conv(got, want):
    """Outputs after the ÷nn agree where the neighbor counts do (a feature
    sum within rounding of 0 may count differently in another order)."""
    (got_out, got_nn), (want_out, want_nn) = got, want
    same = got_nn == want_nn
    assert float(same.float().mean()) >= 0.999
    got, want = (got_out / got_nn[:, None])[same], (want_out / want_nn[:, None])[same]
    # fp32 sums over H neighbors and K·C products in another order.
    assert float((got - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1.0)


# Phase A of K6 / K7 on each of its paths: C = 1 (the narrow kernel, four
# lanes a query: block 0's ones column), 6 and 12 (one 64-channel group,
# part empty), 64 (one full group), 257 (five groups, the last ragged, split
# over 5 blocks of the 32 query blocks, whose neighbor sums are added by
# count_neighbors_kernel); N = 500 queries (a ragged last block).  Layouts:
# K6's (rel, c_skip 0), K7's (rel from the merged gather's coordinate rows,
# c_skip 8) and K3's recompute over the merged gather (rel, c_skip 0).
@pytest.mark.parametrize("c", [1, 6, 12, 64, 257])
@pytest.mark.parametrize("layout", ["k6", "k7", "merged_rel"])
def test_k6_k7_phase_a_matches_plain(cuda, c, layout):
    from pcrcg_tpu_torch.ops.kpconv_fused import _merged_rel

    rel, nx_t, nxc_t, q, kp, _, _ = _gathered_inputs(cuda, c, 4, seed=14, apart=True)
    geom, feats, c_skip = {
        "k6": (rel, nx_t, 0),
        "k7": (q, nxc_t, 8),
        "merged_rel": (_merged_rel(q, nxc_t).contiguous(), nxc_t, 0),
    }[layout]
    for influence, aggregation in (("linear", "sum"), ("gaussian", "closest")):
        args = (geom, feats, c_skip, kp, 0.06, influence, aggregation)
        got_w, got_nn = kpconv_gathered_reduce(*args)
        again_w, again_nn = kpconv_gathered_reduce(*args)
        want_w, want_nn = kpconv_gathered_reduce_plain(*args)
        torch.cuda.synchronize()
        assert got_w.shape == (15 * (feats.shape[1] - c_skip), feats.shape[2])
        assert torch.equal(got_nn, want_nn)  # the sums sit far from zero
        # fp32 sums over H neighbors in another order than einsum's.
        assert _rel_err(got_w, want_w) <= 1e-5
        assert torch.equal(got_w, again_w) and torch.equal(got_nn, again_nn)


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k6_kernel_matches_plain(cuda, influence, aggregation, c, d):
    rel, nx_t, _, _, kp, w, _ = _gathered_inputs(cuda, c, d, seed=8)
    args = (rel, nx_t, kp, w, 0.06, influence, aggregation)
    got = kpconv_fused(*args)
    want = kpconv_fused_plain(*args)
    torch.cuda.synchronize()
    _same_conv(got, want)


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k7_kernel_matches_plain(cuda, influence, aggregation, c, d):
    _, _, nxc_t, q, kp, _, w8 = _gathered_inputs(cuda, c, d, seed=9)
    args = (q, nxc_t, kp, w8, 0.06, influence, aggregation)
    got = kpconv_fused_merged(*args)
    want = kpconv_fused_merged_plain(*args)
    torch.cuda.synchronize()
    _same_conv(got, want)


# C = 1 and 3 take the scalar tail, 136 a ragged last quad group (34 quads
# over 64 threads a query), 512 four warps a query.
@pytest.mark.parametrize("c", [1, 3, 64, 136, 512])
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
def test_k8_kernel_matches_plain(cuda, influence, c):
    rel, nx_t, _, _, kp, _, _ = _gathered_inputs(cuda, c, 4, seed=10, apart=True)
    nx = nx_t.permute(2, 0, 1).contiguous()
    got_w, got_nn = kpconv_weighted_reduce(rel, nx, kp, 0.06, influence)
    again_w, again_nn = kpconv_weighted_reduce(rel, nx, kp, 0.06, influence)
    want_w, want_nn = kpconv_weighted_reduce_plain(rel, nx, kp, 0.06, influence)
    torch.cuda.synchronize()
    assert torch.equal(got_nn, want_nn)  # the sums sit far from zero
    # fp32 sums over H neighbors in another order.
    assert _rel_err(got_w, want_w) <= 1e-5
    assert torch.equal(got_w, again_w) and torch.equal(got_nn, again_nn)


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k3_gathered_kernel_matches_plain(cuda, influence, aggregation, c, d):
    rel, nx_t, _, _, kp, w, _ = _gathered_inputs(cuda, c, d, seed=11)
    g = torch.randn(rel.shape[0], d, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    for need_dnx in (True, False):
        args = (rel, nx_t, g, kp, w, 0.06, influence, aggregation)
        dnx_t, dw = kpconv_fused_bwd(*args, need_dnx=need_dnx)
        want_dnx, want_dw = kpconv_fused_bwd_plain(*args, need_dnx=need_dnx)
        torch.cuda.synchronize()
        # fp32 sums over Nq (dW, split into partials) and D (gW) in
        # another order than cuBLAS's.
        assert _rel_err(dw, want_dw) <= 1e-4
        assert (dnx_t is None) == (not need_dnx)
        if need_dnx:
            assert _rel_err(dnx_t, want_dnx) <= 1e-4


@pytest.mark.parametrize("merged", [False, True])
def test_fused_route_grads_match_cpu(cuda, merged):
    """The fused route's conv (K6, or K7 with a shortcut) and its backward
    (K3's gathered entry, then the gather's index_add_) on the card against
    the CPU plain path: outputs and the gradients of x, W and the shortcut."""
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.models.kpconv import kpconv

    q, sup, feats, _, _, kp, w, gidx = _conv_inputs(cuda, 32, 48, seed=12)
    sx = torch.randn(sup.shape[0], 24, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(2))

    def run(dev):
        x = feats.to(dev).clone().requires_grad_(True)
        wt = w.to(dev).clone().requires_grad_(True)
        s = sx.to(dev).clone().requires_grad_(True) if merged else None
        res = kpconv(q.to(dev), sup.to(dev), gidx.to(dev), x, kp.to(dev), wt, 0.06,
                     impl="fused", shortcut_x=s)
        outs = res if merged else (res,)
        sum(torch.linspace(-1.0, 1.0, o.numel(), device=dev).reshape(o.shape).mul(o).sum()
            for o in outs).backward()
        return [o.detach().cpu() for o in outs] + [t.grad.cpu() for t in (x, wt, s)
                                                   if t is not None]

    key = "K7" if merged else "K6"
    before = dict(kernels.LAUNCHES)
    got = run(cuda)
    assert kernels.LAUNCHES[key] == before[key] + 1
    assert kernels.LAUNCHES["K3"] == before["K3"] + 1
    for a, b in zip(got, run(torch.device("cpu"))):
        assert _rel_err(a, b) <= 1e-4


def test_untiled_train_step_gives_every_kpconv_a_gradient(cuda):
    """One ``train_step`` on the untiled route (K6 / K7 forward, K3's
    gathered backward): all 11 KPConv weights get a non-zero gradient, and
    the candidate-tile kernels never launch."""
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
    from pcrcg_tpu_torch.config import Budgets, tiny_test_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.ops.neighbors import min_dist_sq
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import train_step

    budgets = Budgets(points=(1024, 512, 256, 128), neighbors=(16,) * 4, corr_k=8,
                      query_chunk=256, search_tile=32, search_m_tiles=4)
    cfg = tiny_test_config(budgets=budgets, kpconv_tiled=False)
    # The n nearest points of each cloud around one point of their overlap,
    # under the ground-truth pose, so the loss has correspondences.
    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    d2 = min_dist_sq(torch.from_numpy(src @ rot.T + trans).float().to(cuda),
                     torch.from_numpy(tgt).float().to(cuda),
                     torch.ones(len(tgt), dtype=torch.bool, device=cuda)).cpu().numpy()
    center = src[np.flatnonzero(d2 < 0.0375**2)[0]]

    def near(p, c, n):
        return p[np.argsort(((p - c) ** 2).sum(1), kind="stable")[:n]]

    sample = dict(src_pcd=near(src, center, 1024), tgt_pcd=near(tgt, center @ rot.T + trans, 1000),
                  rot=rot, trans=trans)
    batch = make_pair_batch([sample], 1024, device=cuda)
    state = TrainState(cfg, init_kpfcnn(cfg, seed=0, device=cuda))
    norms = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: norms.__setitem__(n, float(p.grad.norm())))
        for n, p in state.model.named_parameters() if n.endswith("KPConv.weights")]
    kernels.reset_launches()
    try:
        gen = torch.Generator(device=cuda).manual_seed(0)
        stats = train_step(state, cfg, batch, generator=gen)
    finally:
        for hk in hooks:
            hk.remove()
    assert np.isfinite(float(stats["total"]))
    assert len(norms) == 11 and all(v > 0 for v in norms.values()), norms
    assert kernels.LAUNCHES["K6"] == 8 and kernels.LAUNCHES["K7"] == 3
    assert kernels.LAUNCHES["K3"] == 11
    assert kernels.LAUNCHES["K2"] == kernels.LAUNCHES["K5"] == 0
