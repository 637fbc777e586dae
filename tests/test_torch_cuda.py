"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device.  On a machine with a GPU and nvcc (``--noconftest``: the suite's
conftest imports JAX, which the port does not need):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_bwd, kpconv_bwd_plain
from pcrcg_tpu_torch.ops.kpconv_tiled import (
    kpconv_tiled,
    kpconv_tiled_ad,
    kpconv_tiled_plain,
    max_pool_tiled,
    maxpool_bwd,
    maxpool_bwd_plain,
    scatter_ds_feats,
    scatter_ds_feats_plain,
)
from pcrcg_tpu_torch.ops.search_kernel import (
    pack_supports_tile_major,
    tiled_candidate_distances,
    tiled_candidate_distances_plain,
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


@pytest.mark.parametrize("tile,m_tiles,nq", [(128, 12, 300), (32, 5, 256), (128, 40, 128)])
def test_k1_kernel_matches_plain(cuda, tile, m_tiles, nq):
    rng = np.random.default_rng(0)
    ns = tile * max(m_tiles + 2, 8)
    sup, mask = _cloud(rng, ns)
    mask[::29] = False
    q = sup[torch.from_numpy(rng.permutation(ns)[:nq])]
    g = -(-nq // 128)
    sel = torch.from_numpy(rng.integers(0, ns // tile, size=(g, m_tiles)).astype(np.int32))
    supa = pack_supports_tile_major(sup, mask, tile)
    want = tiled_candidate_distances_plain(q.to(cuda), supa.to(cuda), sel.to(cuda))
    got = tiled_candidate_distances(q.to(cuda), supa.to(cuda), sel.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    # Same fp32 operations in the same order; fp64-emulated fmas in the
    # plain version may round a rare exact midpoint differently.
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-5


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


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
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


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k3_kernel_matches_plain(cuda, influence, aggregation, c, d):
    q, sup, feats, lidx, tiles, kp, w, _ = _conv_inputs(cuda, c, d, seed=2)
    _, _, weighted = kpconv_tiled_plain(q, sup, feats, lidx, tiles, kp, w, 0.06, influence,
                                        aggregation, keep_weighted=True)
    g = torch.randn(q.shape[0], d, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    for need_dnx in (True, False):
        args = (q, sup, lidx, tiles, kp, w, g, weighted, 0.06, influence, aggregation, 128)
        dw, dnx = kpconv_bwd(*args, need_dnx=need_dnx)
        want_dw, want_dnx = kpconv_bwd_plain(*args, need_dnx=need_dnx)
        torch.cuda.synchronize()
        # fp32 sums over Nq (dW, split into partials) and D (gW) in
        # another order than cuBLAS's.
        assert _rel_err(dw, want_dw) <= 1e-4
        assert (dnx is None) == (not need_dnx)
        if need_dnx:
            assert _rel_err(dnx, want_dnx) <= 1e-4


@pytest.mark.parametrize("c", [1, 64, 257])
def test_k4_kernel_matches_plain(cuda, c):
    q, sup, _, lidx, tiles, *_ = _conv_inputs(cuda, 4, 4, seed=3)
    dnx = torch.randn(q.shape[0], lidx.shape[1], c, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(1))
    got = scatter_ds_feats(dnx, lidx, tiles, sup.shape[0])
    want = scatter_ds_feats_plain(dnx, lidx, tiles, sup.shape[0])
    torch.cuda.synchronize()
    # Atomic sums: ~H terms per row, in an order that varies run to run.
    assert _rel_err(got, want) <= 1e-5


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

    q, sup, feats, lidx, tiles, kp, w, _ = _conv_inputs(cuda, 16, 24, seed=7)
    conv = KPConv(16, 24, radius=0.08, kp_extent=0.06).to(cuda)
    with torch.no_grad():
        conv.weights.copy_(w)
        conv.kernel_points.copy_(kp)
    x = feats[None].clone().requires_grad_(True)
    out = conv(q[None], sup[None], x, (lidx[None], tiles[None]))
    out.square().sum().backward()
    assert conv.weights.grad is not None and float(conv.weights.grad.abs().sum()) > 0
    assert x.grad is not None and float(x.grad.abs().sum()) > 0


def test_wrappers_reject_bad_arguments(cuda):
    q = torch.zeros(10, 3, device=cuda)
    supa = torch.zeros(2, 4, 32, device=cuda)
    with pytest.raises(ValueError):
        tiled_candidate_distances(q, supa, torch.zeros(1, 2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        tiled_candidate_distances(q.double(), supa, torch.zeros(1, 2, dtype=torch.int32,
                                                                device=cuda))
