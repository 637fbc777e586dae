"""The port's pyramid (grid subsample + tiled searches through K1's plain
version) against the JAX package under ``tiny_test_config`` on a crop of
the in-repo assets pair: points, masks, neighbors, pools, upsamples and
the tile-local metadata, index for index."""
import jax
import numpy as np
import pytest
import torch

from pcrcg_tpu import config as jcfg
from pcrcg_tpu.assets import demo_cloud_pair
from pcrcg_tpu.data.pair import make_pair_batch
from pcrcg_tpu.ops.pyramid import build_pyramid_cfg as j_build_pyramid_cfg
from pcrcg_tpu_torch import config as tcfg
from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

# search_tile 32 and m_tiles 4 make levels 0-2 take the pruned route and
# level 3 the dense fallback at these budgets.
_BUDGETS = dict(points=(256, 192, 192, 96), neighbors=(16, 16, 16, 16), corr_k=8,
                query_chunk=64, search_tile=32, search_m_tiles=4)


def assets_crop(n_src=256, n_tgt=240):
    """The n nearest points to each cloud's median: a dense 3DMatch patch
    (~0.7 m across) small enough for tiny budgets."""
    def crop(p, n):
        d = ((p - np.median(p, 0)) ** 2).sum(1)
        return p[np.argsort(d, kind="stable")[:n]]

    src, tgt = demo_cloud_pair()
    return crop(src, n_src), crop(tgt, n_tgt)


@pytest.fixture(scope="module")
def pyramids():
    src, tgt = assets_crop()
    batch = make_pair_batch(
        [dict(src_pcd=src, tgt_pcd=tgt, rot=np.eye(3), trans=np.zeros(3))], 256
    )
    jc = jcfg.tiny_test_config(budgets=jcfg.Budgets(**_BUDGETS))
    tc = tcfg.tiny_test_config(budgets=tcfg.Budgets(**_BUDGETS))
    # Compiled, as the JAX package always runs it (XLA's rounding differs
    # from eager dispatch: fused multiply-adds, constant reciprocals).
    want, w_over = jax.jit(lambda p, m: j_build_pyramid_cfg(jc, p, m, with_overflow=True))(
        batch.points[0], batch.masks[0]
    )
    got, g_over = build_pyramid_cfg(
        tc, torch.from_numpy(np.asarray(batch.points[0])),
        torch.from_numpy(np.asarray(batch.masks[0])), with_overflow=True,
    )
    return jc, want, w_over, got, g_over


def _check_indices(got, want, queries, supports, r2, what):
    """Index-for-index agreement; each differing entry must be a distance
    tie or sit at the radius (both within f32 rounding of the |q|²+|s|²−2q·s
    expansion, 2⁻¹⁸ of the squared coordinates — ~1e-6·r² here is far
    below what fp32 resolves at metre-scale coordinates), and at most 0.1%
    of entries may differ."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    diff = np.argwhere(got != want)
    assert len(diff) <= 0.001 * got.size, (what, len(diff), got.size)
    q64, s64 = np.asarray(queries, np.float64), np.asarray(supports, np.float64)
    ns = s64.shape[0]
    for i, j in diff:
        scale = 2.0 ** -18 * (np.sum(q64[i] ** 2) + np.max(np.sum(s64 ** 2, -1)))
        d = [np.sum((q64[i] - s64[x]) ** 2) if x < ns else None for x in (got[i, j], want[i, j])]
        if None in d:
            real = d[0] if d[1] is None else d[1]
            assert abs(real - r2) <= scale, (what, i, j, real, r2)
        else:
            assert abs(d[0] - d[1]) <= scale, (what, i, j, d)


def test_pyramid_points_and_masks(pyramids):
    _, want, w_over, got, g_over = pyramids
    np.testing.assert_array_equal(g_over.numpy(), np.asarray(w_over))
    for lvl in range(len(want.points)):
        np.testing.assert_array_equal(got.masks[lvl].numpy(), np.asarray(want.masks[lvl]))
        np.testing.assert_allclose(got.points[lvl].numpy(), np.asarray(want.points[lvl]),
                                   rtol=0, atol=1e-6)


def test_pyramid_neighbors_pools_upsamples(pyramids):
    jc, want, _, got, _ = pyramids
    r = jc.first_subsampling_dl * jc.conv_radius
    for lvl in range(len(want.points)):
        pts = np.asarray(want.points[lvl])
        r2 = float(np.float32(r) ** 2)
        for c in range(2):
            _check_indices(got.neighbors[lvl][c], want.neighbors[lvl][c], pts[c], pts[c], r2,
                           f"neighbors[{lvl}][{c}]")
            if lvl + 1 < len(want.points):
                nxt = np.asarray(want.points[lvl + 1])
                _check_indices(got.pools[lvl][c], want.pools[lvl][c], nxt[c], pts[c], r2,
                               f"pools[{lvl}][{c}]")
                _check_indices(got.upsamples[lvl][c], want.upsamples[lvl][c], pts[c], nxt[c],
                               float(np.float32(2 * r) ** 2), f"upsamples[{lvl}][{c}]")
        r *= 2.0


def test_pyramid_tile_local_metadata(pyramids):
    _, want, _, got, _ = pyramids
    for name in ("conv_local", "pool_local"):
        for lvl, (w, g) in enumerate(zip(getattr(want, name), getattr(got, name))):
            w_lidx, w_tiles = (np.asarray(a) for a in w)
            g_lidx, g_tiles = (a.numpy() for a in g)
            np.testing.assert_array_equal(g_tiles, w_tiles, err_msg=f"{name}[{lvl}] tiles")
            assert g_lidx.shape == w_lidx.shape and g_lidx.dtype == np.int32
            assert (g_lidx != w_lidx).mean() <= 0.001, (name, lvl)
