"""The plain version of K2 (candidate-tile KPConv) and the port's KPConv
module against the JAX package: ``kpconv_tiled(interpret=True,
feat_limbs=2)`` and the JAX ``kpconv`` xla path, rtol/atol 2e-4 (the
tolerance of the JAX package's own kernel test)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu.models.kpconv import kpconv as j_kpconv
from pcrcg_tpu.ops.kpconv_tiled import kpconv_tiled as j_kpconv_tiled
from pcrcg_tpu.ops.subsample import morton_sort
from pcrcg_tpu.ops.tiled_search import radius_search_tiled
from pcrcg_tpu_torch.models.kpconv import KPConv, kpconv
from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled

T = torch.from_numpy
TILE = 32


def _setup(seed, nq=200, ns=600, c=12, d=16, k=15, h=9, radius=0.33, m_tiles=6, scale=3.0):
    """A 3 m-scale Z-ordered cloud, queries drawn from it, and the JAX tiled
    search's global and tile-local neighbors (numpy arrays)."""
    rng = np.random.default_rng(seed)
    sup = rng.uniform(0, scale, size=(ns, 3)).astype(np.float32)
    sup_j, mask_j, _ = morton_sort(jnp.asarray(sup), jnp.ones(ns, bool))
    sup = np.asarray(sup_j)
    q = sup[rng.permutation(ns)[:nq]]
    gidx, lidx, tiles = radius_search_tiled(
        jnp.asarray(q), sup_j, mask_j, radius, h, tile=TILE, m_tiles=m_tiles,
        return_local=True,
    )
    feats = rng.normal(size=(ns, c)).astype(np.float32)
    feats[::4] = np.abs(feats[::4])  # some positive feature sums for nn
    kp = rng.normal(scale=0.12, size=(k, 3)).astype(np.float32)
    w = rng.normal(size=(k, c, d)).astype(np.float32)
    return dict(q=q, sup=sup, feats=feats, gidx=np.asarray(gidx), lidx=np.asarray(lidx),
                tiles=np.asarray(tiles), kp=kp, w=w)


CASES = [
    ("linear", "sum", 12, 16),
    ("gaussian", "sum", 12, 16),
    ("constant", "sum", 12, 16),
    ("linear", "closest", 12, 16),
    ("linear", "sum", 1, 32),
    ("linear", "sum", 200, 40),
]


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k2_plain_matches_jax(influence, aggregation, c, d):
    s = _setup(0, c=c, d=d)
    extent = 0.24
    got_out, got_nn = kpconv_tiled(
        T(s["q"]), T(s["sup"]), T(s["feats"]), T(s["lidx"]), T(s["tiles"]),
        T(s["kp"]), T(s["w"]), extent, influence, aggregation, tile=TILE,
    )
    got = (got_out / got_nn[:, None]).numpy()
    want_out, want_nn = j_kpconv_tiled(
        jnp.asarray(s["q"]), jnp.asarray(s["sup"]), jnp.asarray(s["feats"]),
        jnp.asarray(s["lidx"]), jnp.asarray(s["tiles"]), jnp.asarray(s["kp"]),
        jnp.asarray(s["w"]), extent, influence, aggregation, interpret=True,
        tile=TILE, feat_limbs=2,
    )
    np.testing.assert_array_equal(got_nn.numpy(), np.asarray(want_nn))
    scale = max(float(np.abs(got).max()), 1.0)
    np.testing.assert_allclose(
        got_out.numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4 * scale
    )
    # The JAX xla path takes one kernel point per neighbor under 'closest'
    # (argmin); the kernels keep every kernel point at the minimum.  Random
    # kernel points never tie, so both agree here.
    want_xla = np.asarray(j_kpconv(
        jnp.asarray(s["q"]), jnp.asarray(s["sup"]), jnp.asarray(s["gidx"]),
        jnp.asarray(s["feats"]), jnp.asarray(s["kp"]), jnp.asarray(s["w"]), extent,
        influence, aggregation,
    ))
    np.testing.assert_allclose(got, want_xla, rtol=2e-4, atol=2e-4 * scale)
    # The port's own dense reference agrees as well.
    ref = kpconv(T(s["q"]), T(s["sup"]), T(s["gidx"]), T(s["feats"]), T(s["kp"]),
                 T(s["w"]), extent, influence, aggregation).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * scale)


def test_kpconv_ones_fast_path_matches_jax():
    s = _setup(1, c=1, d=8)
    ones = np.ones_like(s["feats"])
    want = np.asarray(j_kpconv(
        jnp.asarray(s["q"]), jnp.asarray(s["sup"]), jnp.asarray(s["gidx"]),
        jnp.asarray(ones), jnp.asarray(s["kp"]), jnp.asarray(s["w"]), 0.24,
        ones_features=True,
    ))
    got = kpconv(T(s["q"]), T(s["sup"]), T(s["gidx"]), T(ones), T(s["kp"]), T(s["w"]),
                 0.24, ones_features=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_kpconv_module_stacks_clouds():
    """The module stacks both clouds (per-cloud supports padded to whole
    tiles, tile ids offset, queries padded to whole groups) and matches the
    JAX xla path per cloud."""
    per = [_setup(seed, nq=150, ns=590, c=6, d=10) for seed in (5, 6)]
    conv = KPConv(6, 10, radius=0.2, kp_extent=0.24, tile=TILE)
    with torch.no_grad():
        conv.weights.copy_(T(per[0]["w"][:, :6, :10]))
        conv.kernel_points.copy_(T(per[0]["kp"]))
    lidx = T(np.stack([p["lidx"] for p in per]))
    tiles = T(np.stack([p["tiles"] for p in per]))
    got = conv(T(np.stack([p["q"] for p in per])), T(np.stack([p["sup"] for p in per])),
               T(np.stack([p["gidx"] for p in per])).long(),
               T(np.stack([p["feats"] for p in per])), tiled_meta=(lidx, tiles)).detach().numpy()
    for b, p in enumerate(per):
        want = np.asarray(j_kpconv(
            jnp.asarray(p["q"]), jnp.asarray(p["sup"]), jnp.asarray(p["gidx"]),
            jnp.asarray(p["feats"]), jnp.asarray(per[0]["kp"]),
            jnp.asarray(per[0]["w"][:, :6, :10]), 0.24,
        ))
        np.testing.assert_allclose(got[b], want, rtol=2e-4, atol=2e-4)
