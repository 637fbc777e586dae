"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device.  On a machine with a GPU and nvcc (``--noconftest``: the suite's
conftest imports JAX, which the port does not need):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled, kpconv_tiled_plain
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


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k2_kernel_matches_plain(cuda, influence, aggregation, c, d):
    from pcrcg_tpu_torch.ops.tiled_search import radius_search_tiled

    rng = np.random.default_rng(1)
    ns, nq, h, tile = 2048, 500, 40, 128
    sup, mask = _cloud(rng, ns, scale=1.0)
    q = sup[torch.from_numpy(rng.permutation(ns)[:nq])]
    _, lidx, tiles = radius_search_tiled(q, sup, mask, 0.08, h, tile=tile, m_tiles=6,
                                         return_local=True)
    feats = torch.from_numpy(rng.normal(size=(ns, c)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(scale=0.05, size=(15, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(15, c, d)).astype(np.float32))
    args = [t.to(cuda).contiguous() for t in (q, sup, feats, lidx, tiles, kp, w)]
    got_out, got_nn = kpconv_tiled(*args, 0.06, influence, aggregation, tile=tile)
    want_out, want_nn = kpconv_tiled_plain(*args, 0.06, influence, aggregation, tile=tile)
    torch.cuda.synchronize()
    same = got_nn == want_nn
    assert float(same.float().mean()) >= 0.999
    got, want = (got_out / got_nn[:, None])[same], (want_out / want_nn[:, None])[same]
    # fp32 sums over H neighbors and K·C products in another order.
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_wrappers_reject_bad_arguments(cuda):
    q = torch.zeros(10, 3, device=cuda)
    supa = torch.zeros(2, 4, 32, device=cuda)
    with pytest.raises(ValueError):
        tiled_candidate_distances(q, supa, torch.zeros(1, 2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        tiled_candidate_distances(q.double(), supa, torch.zeros(1, 2, dtype=torch.int32,
                                                                device=cuda))
