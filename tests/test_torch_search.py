"""The port's subsample, neighbor searches and the plain version of K1 (the
tiled-search distance kernel) against the JAX package on the CPU (Pallas
kernels in interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu.ops import masked as jmasked
from pcrcg_tpu.ops import neighbors as jnb
from pcrcg_tpu.ops import subsample as jsub
from pcrcg_tpu.ops import tiled_search as jts
from pcrcg_tpu.ops.search_kernel import (
    pack_supports_tile_major as j_pack,
    tiled_candidate_distances as j_tiled_candidate_distances,
)
from pcrcg_tpu_torch.ops import masked as tmasked
from pcrcg_tpu_torch.ops import neighbors as tnb
from pcrcg_tpu_torch.ops import subsample as tsub
from pcrcg_tpu_torch.ops import tiled_search as tts
from pcrcg_tpu_torch.ops.search_kernel import (
    pack_supports_tile_major,
    tiled_candidate_distances_plain,
)

T = torch.from_numpy


def _sorted_cloud(rng, n, scale=3.0):
    """Z-ordered 3 m-scale cloud (numpy) and its all-valid mask."""
    pts = rng.uniform(0, scale, size=(n, 3)).astype(np.float32)
    sorted_pts, mask, _ = jsub.morton_sort(jnp.asarray(pts), jnp.ones(n, bool))
    return np.array(sorted_pts), np.array(mask)


@pytest.mark.parametrize("order", ["morton", "raster"])
@pytest.mark.parametrize("dl", [0.05, 0.2])
def test_grid_subsample_matches(order, dl):
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 3, size=(700, 3)).astype(np.float32)
    pts[::5] = pts[1::5] + 1e-3  # shared voxels
    mask = rng.uniform(size=700) > 0.1
    pts[~mask] = 1e6
    n_out = 300
    want = jax.jit(lambda p, m: jsub.grid_subsample(p, m, dl, n_out, return_count=True,
                                                    order=order))(pts, mask)
    got = tsub.grid_subsample(T(pts), T(mask), dl, n_out, return_count=True, order=order)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)


def test_morton_helpers_match():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 2, size=(257, 3)).astype(np.float32)
    mask = rng.uniform(size=257) > 0.2
    np.testing.assert_array_equal(
        tsub.morton_code(T(pts), T(mask)).numpy(),
        np.asarray(jsub.morton_code(jnp.asarray(pts), jnp.asarray(mask))),
    )
    got = tsub.morton_sort(T(pts), T(mask))
    want = jsub.morton_sort(jnp.asarray(pts), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for dl in (0.001, 0.01):
        assert bool(tsub.grid_fits_morton(T(pts), T(mask), dl)) == bool(
            jsub.grid_fits_morton(jnp.asarray(pts), jnp.asarray(mask), dl)
        )


def test_masked_ops_match():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 37, 5)).astype(np.float32)
    m = rng.uniform(size=(2, 37)) > 0.3
    np.testing.assert_allclose(
        tmasked.masked_instance_norm(T(x), T(m), dim=(0, 1)).numpy(),
        np.asarray(jmasked.masked_instance_norm(jnp.asarray(x), jnp.asarray(m), axis=(0, 1))),
        rtol=1e-5, atol=1e-6,
    )
    logits, lm = x[0], m[0][None, :].repeat(5, 0).T
    np.testing.assert_allclose(
        tmasked.masked_softmax(T(logits), T(lm), dim=0).numpy(),
        np.asarray(jmasked.masked_softmax(jnp.asarray(logits), jnp.asarray(lm), axis=0)),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        tmasked.masked_logsumexp(T(logits), T(lm), dim=0).numpy(),
        np.asarray(jmasked.masked_logsumexp(jnp.asarray(logits), jnp.asarray(lm), axis=0)),
        rtol=1e-5, atol=1e-5,
    )
    idx = rng.integers(0, 38, size=(11, 4))
    np.testing.assert_array_equal(
        tmasked.pad_gather(T(x[0]), T(idx), -2.0).numpy(),
        np.asarray(jmasked.pad_gather(jnp.asarray(x[0]), jnp.asarray(idx), -2.0)),
    )


def test_k1_plain_matches_pallas_interpret():
    """K1's plain version against ``tiled_candidate_distances(interpret=True)``
    on the same queries, supports and tile selection: rtol 1e-5, atol 2e-5.
    The JAX kernel's cross term is a 3-limb bf16 expansion whose dropped
    limb products leave up to ~1e-5 absolute error at 3 m scale (|q|² ≈ 27;
    1.14e-5 measured on 2 of 40,064 entries here), so atol 1e-5 alone would
    test the reference's rounding, not the port."""
    rng = np.random.default_rng(4)
    tile, ns, nq, m = 32, 512, 200, 5
    sup, smask = _sorted_cloud(rng, ns)
    smask[::37] = False
    q = sup[rng.permutation(ns)[:nq]]
    sel = rng.integers(0, ns // tile, size=(2, m)).astype(np.int32)
    want = np.asarray(j_tiled_candidate_distances(
        jnp.asarray(q), j_pack(jnp.asarray(sup), jnp.asarray(smask), tile),
        jnp.asarray(sel), tile=tile, interpret=True,
    ))
    got = tiled_candidate_distances_plain(
        T(q), pack_supports_tile_major(T(sup), T(smask), tile), T(sel)
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=2e-5)
    # And the port's fp32 expansion is within 1e-5 of the float64 truth.
    cand = np.concatenate([np.arange(s * tile, (s + 1) * tile) for s in sel.reshape(-1)])
    cand = cand.reshape(2, -1)
    q64 = np.zeros((256, 3))
    q64[:nq] = q
    exact = ((q64.reshape(2, 128, 1, 3) - sup[cand][:, None].astype(np.float64)) ** 2).sum(-1)
    exact = exact.reshape(256, -1)
    np.testing.assert_allclose(got[fin], exact[fin], rtol=1e-5, atol=1e-5)


def test_dense_searches_match():
    rng = np.random.default_rng(5)
    sup, smask = _sorted_cloud(rng, 300)
    smask[::7] = False
    q = rng.uniform(0, 3, size=(130, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tnb.radius_search(T(q), T(sup), T(smask), 0.4, 9, query_chunk=64).numpy(),
        np.asarray(jax.jit(lambda *a: jnb.radius_search(*a, 0.4, 9, query_chunk=64))(
            q, sup, smask)),
    )
    gi, gd = tnb.knn_search(T(q), T(sup), T(smask), 6)
    wi, wd = jax.jit(lambda *a: jnb.knn_search(*a, 6))(q, sup, smask)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tnb.min_dist_sq(T(q), T(sup), T(smask)).numpy(),
        np.asarray(jnb.min_dist_sq(jnp.asarray(q), jnp.asarray(sup), jnp.asarray(smask))),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("k,m_tiles", [(9, 6), (1, 4), (7, 30)])
def test_tiled_search_matches_per_cloud(k, m_tiles):
    """The port's batched tiled search (both clouds, one K1 call) against
    the compiled JAX per-cloud ``radius_search_tiled``: neighbor indices,
    lidx and tiles are equal (m_tiles=30 takes the dense fallback)."""
    tile, ns, nq, radius = 32, 640, 256, 0.33
    clouds, masks, queries = [], [], []
    for seed in (3, 4):
        r = np.random.default_rng(seed)
        sup, smask = _sorted_cloud(r, ns)
        smask[-5:] = False
        clouds.append(sup)
        masks.append(smask)
        queries.append(sup[r.permutation(ns)[:nq]])
    idx, lidx, tiles = tts.radius_search_tiled_batch(
        T(np.stack(queries)), T(np.stack(clouds)), T(np.stack(masks)), radius, k,
        tile=tile, m_tiles=m_tiles, return_local=True,
    )
    search = jax.jit(lambda *a: jts.radius_search_tiled(
        *a, radius, k, tile=tile, m_tiles=m_tiles, return_local=True))
    for b in range(2):
        w_idx, w_lidx, w_tiles = search(queries[b], clouds[b], masks[b])
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(w_idx))
        np.testing.assert_array_equal(tiles[b].numpy(), np.asarray(w_tiles))
        np.testing.assert_array_equal(lidx[b].numpy(), np.asarray(w_lidx))
    assert idx.dtype == torch.int64 and lidx.dtype == torch.int32 and tiles.dtype == torch.int32


def test_min_dist_sq_tiled_matches():
    rng = np.random.default_rng(6)
    sup, smask = _sorted_cloud(rng, 640)
    q = rng.uniform(0, 3, size=(300, 3)).astype(np.float32)
    got = tts.min_dist_sq_tiled(T(q), T(sup), T(smask), tile=32, m_tiles=6).numpy()
    want = np.asarray(jts.min_dist_sq_tiled(jnp.asarray(q), jnp.asarray(sup),
                                            jnp.asarray(smask), tile=32, m_tiles=6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def _edge_clouds(case, ns=640):
    """Two Z-ordered clouds (numpy) for the edge cases of the tiled search:
    "ties" and "nearest" hold every support point twice (exact distance
    ties, so the lower candidate position must win); "dense" puts 300 of
    the points in a 3 cm ball (its queries have more candidates within the
    radius than k, and than the kernel's 128-entry survivor buffer);
    "pads" masks scattered supports.  Queries are support points with a
    little noise, nq not a multiple of 128 (pad-query rows)."""
    clouds, masks, queries = [], [], []
    for seed in (11, 12):
        r = np.random.default_rng(seed)
        pts = r.uniform(0, 3, size=(ns, 3)).astype(np.float32)
        if case in ("ties", "nearest"):
            pts[1::2] = pts[::2]
        elif case == "dense":
            pts[:300] = (1.5 + r.uniform(-0.015, 0.015, size=(300, 3))).astype(np.float32)
        sup, smask = (np.array(a) for a in jsub.morton_sort(jnp.asarray(pts),
                                                            jnp.ones(ns, bool))[:2])
        if case == "pads":
            smask[::13] = False
        q = sup[r.permutation(ns)[:200]]
        if case != "ties":
            q = q + r.normal(scale=0.01, size=q.shape).astype(np.float32)
        clouds.append(sup)
        masks.append(smask)
        queries.append(q.astype(np.float32))
    return np.stack(queries), np.stack(clouds), np.stack(masks)


@pytest.mark.parametrize("case,k,m_tiles", [("ties", 9, 6), ("dense", 40, 8), ("nearest", 1, 4),
                                            ("pads", 16, 6)])
def test_tiled_search_edge_cases_match_per_cloud(case, k, m_tiles):
    """The port's batched tiled search (plain chain on the CPU; the same
    chain the card's fused K1 is held to) against the compiled JAX
    per-cloud ``radius_search_tiled(exact=True, return_local=True)``,
    whose distances round as the port's: idx, lidx and tiles equal index
    for index, pad-query rows included."""
    tile, radius = 32, 0.33
    qs, clouds, masks = _edge_clouds(case)
    idx, lidx, tiles = tts.radius_search_tiled_batch(
        T(qs), T(clouds), T(masks), radius, k, tile=tile, m_tiles=m_tiles, return_local=True,
    )
    search = jax.jit(lambda *a: jts.radius_search_tiled(
        *a, radius, k, tile=tile, m_tiles=m_tiles, exact=True, return_local=True))
    for b in range(2):
        w_idx, w_lidx, w_tiles = search(qs[b], clouds[b], masks[b])
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(w_idx))
        np.testing.assert_array_equal(lidx[b].numpy(), np.asarray(w_lidx))
        np.testing.assert_array_equal(tiles[b].numpy(), np.asarray(w_tiles))
    assert lidx.shape == (2, 256, k)
    cand = m_tiles * tile
    assert bool((lidx[:, 200:] == cand).all())  # pad-query rows: all shadow
    if case in ("ties", "nearest"):
        # Equal distances decided the order: consecutive kept neighbors at
        # the same support point (k > 1).
        assert bool((lidx[:, :200] < cand).any())
        if k > 1:
            sup = T(clouds)[torch.arange(2)[:, None, None], idx.clamp(max=clouds.shape[1] - 1)]
            kept = idx < clouds.shape[1]
            tied = (sup[:, :, :-1] == sup[:, :, 1:]).all(-1) & kept[..., 1:]
            assert bool(tied.any())
    if case == "dense":
        # More in-radius candidates than the survivor buffer holds.
        full = tts.radius_search_tiled_batch(T(qs), T(clouds), T(masks), radius, cand,
                                             tile=tile, m_tiles=m_tiles)
        assert int((full < clouds.shape[1]).sum(-1).max()) > 128
