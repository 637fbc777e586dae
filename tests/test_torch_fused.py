"""The untiled KPConv routes of the port against the JAX package, on the CPU:
the plain versions of K6 (``kpconv_fused_plain``), K7
(``kpconv_fused_merged_plain``), K8 (``kpconv_weighted_reduce_plain``) and
K3's gathered entry (``kpconv_fused_bwd_plain``), the gradients of the
autograd functions that run them (``kpconv_fused_ad``,
``kpconv_fused_merged_ad``, through the port's ``kpconv(impl='fused')``),
and the tie rule of the untiled strided shortcut.

References: the Pallas kernels in interpret mode (``kpconv_fused``,
``kpconv_fused_merged``, ``kpconv_weighted_reduce``, ``kpconv_fused_bwd``)
and ``jax.grad`` through the JAX ``kpconv(impl='fused', interpret=True)``.
Both sides compute in fp32 in other summation orders (the TPU kernels block
C by 128 and D by 256, and add per kernel point), which lands near 1e-6
relative; every output, dW and dnx is held to 1e-5 of its largest entry,
and the neighbor counts exactly (the features' row sums are far from zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrcg_tpu.models.blocks import max_pool as j_max_pool
from pcrcg_tpu.models.kpconv import kpconv as j_kpconv
from pcrcg_tpu.ops.kpconv_fused import kpconv_fused as j_kpconv_fused
from pcrcg_tpu.ops.kpconv_fused import kpconv_fused_bwd as j_kpconv_fused_bwd
from pcrcg_tpu.ops.kpconv_fused import kpconv_fused_merged as j_kpconv_fused_merged
from pcrcg_tpu.ops.kpconv_pallas import kpconv_weighted_reduce as j_kpconv_weighted_reduce
from pcrcg_tpu_torch.models.kpconv import kpconv, max_pool
from pcrcg_tpu_torch.ops.kpconv_fused import (
    kpconv_fused,
    kpconv_fused_bwd,
    kpconv_fused_merged,
    kpconv_fused_merged_plain,
    kpconv_fused_plain,
    kpconv_gathered_fused,
    kpconv_gathered_reduce,
    phase_a_split,
)
from pcrcg_tpu_torch.ops.kpconv_pallas import kpconv_weighted_reduce
from pcrcg_tpu_torch.ops.kpconv_tiled import max_pool_tiled
from pcrcg_tpu_torch.ops.masked import PAD_COORD

T = torch.from_numpy
J = jnp.asarray
EXTENT = 0.24
CASES = [
    ("linear", "sum", 12, 16),
    ("gaussian", "sum", 12, 16),
    ("constant", "sum", 12, 16),
    ("linear", "closest", 12, 16),
    ("linear", "sum", 1, 32),
    ("linear", "sum", 136, 40),
]


def _setup(seed, nq=120, ns=360, c=12, d=16, k=15, h=9, radius=0.33, scale=2.0, c2=0):
    """A 2 m-scale cloud, queries drawn from it, each query's h nearest
    supports within ``radius`` (pad = Ns), features whose row sums sit far
    from zero, kernel points, W [K, C, D], shortcut features [Ns, c2] and
    cotangents g [Nq, D], g2 [Nq, c2] (numpy)."""
    rng = np.random.default_rng(seed)
    sup = rng.uniform(0, scale, size=(ns, 3)).astype(np.float32)
    q = sup[rng.permutation(ns)[:nq]]
    d2 = ((q[:, None, :] - sup[None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :h]
    inds = np.where(np.take_along_axis(d2, order, 1) <= radius**2, order, ns)
    feats = rng.normal(size=(ns, c)).astype(np.float32)
    feats += np.sign(feats.sum(1, keepdims=True)) * 0.5 / c
    return dict(
        q=q, sup=sup, inds=inds.astype(np.int32), feats=feats,
        kp=rng.normal(scale=0.12, size=(k, 3)).astype(np.float32),
        w=rng.normal(size=(k, c, d)).astype(np.float32),
        sx=rng.normal(size=(ns, c2)).astype(np.float32),
        g=rng.normal(size=(nq, d)).astype(np.float32),
        g2=rng.normal(size=(nq, c2)).astype(np.float32),
    )


def _gathered(s):
    """rel [Nq, H, 3] (shadow at PAD_COORD − q) and nx_t [H, C, Nq]."""
    ns = s["sup"].shape[0]
    real = (s["inds"] < ns)[..., None]
    rows = np.minimum(s["inds"], ns - 1)
    rel = np.where(real, s["sup"][rows], np.float32(PAD_COORD)) - s["q"][:, None, :]
    nx = np.where(real, s["feats"][rows], 0.0).astype(np.float32)
    return rel.astype(np.float32), np.ascontiguousarray(nx.transpose(1, 2, 0))


def _merged_gather(s):
    """nxc_t [H, 8 + C, Nq]: the gathered [coords | 0 | features], shadow
    rows all zero."""
    ns = s["sup"].shape[0]
    base = np.concatenate([s["sup"], np.zeros((ns, 5), np.float32), s["feats"]], 1)
    real = (s["inds"] < ns)[..., None]
    nxc = np.where(real, base[np.minimum(s["inds"], ns - 1)], 0.0).astype(np.float32)
    return np.ascontiguousarray(nxc.transpose(1, 2, 0))


def _close(got, want, what=""):
    """|got − want| ≤ 1e-5 · max |want|."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= 1e-5 * scale, f"{what}: max |diff| {err:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k6_plain_matches_pallas(influence, aggregation, c, d):
    s = _setup(0, c=c, d=d)
    rel, nx_t = _gathered(s)
    out, nn = kpconv_fused(T(rel), T(nx_t), T(s["kp"]), T(s["w"]), EXTENT, influence,
                           aggregation)
    want_out, want_nn = j_kpconv_fused(J(rel), J(nx_t), J(s["kp"]), J(s["w"]), EXTENT,
                                       influence, aggregation, interpret=True)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(want_nn))
    _close(out.numpy(), want_out, "out")
    # The whole conv through K6 equals the dense reference of the JAX package.
    got = kpconv_gathered_fused(T(s["q"]), T(s["sup"]), T(s["inds"]).long(), T(s["feats"]),
                                T(s["kp"]), T(s["w"]), EXTENT, influence, aggregation)
    want = j_kpconv(J(s["q"]), J(s["sup"]), J(s["inds"]), J(s["feats"]), J(s["kp"]),
                    J(s["w"]), EXTENT, influence, aggregation)
    _close(got.numpy(), want, "kpconv_gathered_fused vs the JAX xla kpconv")


@pytest.mark.parametrize("influence,aggregation,c,d", [CASES[0], CASES[1], CASES[3], CASES[5]])
def test_k7_plain_matches_pallas(influence, aggregation, c, d):
    s = _setup(1, c=c, d=d)
    nxc_t = _merged_gather(s)
    w8 = np.concatenate([np.zeros((s["w"].shape[0], 8, d), np.float32), s["w"]], 1)
    out, nn = kpconv_fused_merged(T(s["q"]), T(nxc_t), T(s["kp"]), T(w8), EXTENT, influence,
                                  aggregation)
    want_out, want_nn = j_kpconv_fused_merged(J(s["q"]), J(nxc_t), J(s["kp"]), J(w8), EXTENT,
                                              influence, aggregation, interpret=True)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(want_nn))
    _close(out.numpy(), want_out, "out")


@pytest.mark.parametrize("influence,aggregation,c,d", [CASES[0], CASES[3], CASES[4], CASES[5]])
def test_k7_wrapper_takes_w8_and_skips_the_coordinate_rows(influence, aggregation, c, d):
    """K7's wrapper keeps its W8 [K, 8 + C, D] contract: on the CPU it gives
    the merged plain version's output (all 8 + C rows against W8, as the
    TPU kernel contracts them), and that equals what the card computes --
    phase A over the C feature rows only (c_skip = 8), then their product
    with W8's feature rows -- because W8's first 8 rows are zero."""
    s = _setup(4, c=c, d=d)
    nxc_t = T(_merged_gather(s))
    w8 = T(np.concatenate([np.zeros((s["w"].shape[0], 8, d), np.float32), s["w"]], 1))
    args = (T(s["q"]), nxc_t, T(s["kp"]), w8, EXTENT, influence, aggregation)
    out, nn = kpconv_fused_merged(*args)
    want_out, want_nn = kpconv_fused_merged_plain(*args)
    assert torch.equal(out, want_out) and torch.equal(nn, want_nn)
    weighted_t, skip_nn = kpconv_gathered_reduce(T(s["q"]), nxc_t, 8, T(s["kp"]), EXTENT,
                                                 influence, aggregation)
    assert weighted_t.shape == (s["kp"].shape[0] * c, s["q"].shape[0])
    assert torch.equal(skip_nn, nn)
    skip_out = weighted_t.T @ w8[:, 8:, :].reshape(-1, d)
    _close(skip_out.numpy(), out.numpy(), "feature rows only vs all 8 + C rows")


def test_k6_phase_a_is_k7_phase_a_on_the_feature_rows():
    """Phase A of K7 (rel from the merged gather's coordinate rows, c_skip 8)
    gives K6's phase A over the feature rows with the gathered rel: the
    shadow slots differ only in their rel (−q against PAD_COORD − q), and
    their features are zero."""
    s = _setup(5, c=20, d=8)
    rel, nx_t = _gathered(s)
    nxc_t = _merged_gather(s)
    k6 = kpconv_gathered_reduce(T(rel), T(nx_t), 0, T(s["kp"]), EXTENT)
    k7 = kpconv_gathered_reduce(T(s["q"]), T(nxc_t), 8, T(s["kp"]), EXTENT)
    assert torch.equal(k6[1], k7[1])
    _close(k7[0].numpy(), k6[0].numpy(), "weighted_t")
    out, nn = kpconv_fused_plain(T(rel), T(nx_t), T(s["kp"]), T(s["w"]), EXTENT)
    assert torch.equal(nn, k6[1])
    assert torch.equal(out, k6[0].T @ T(s["w"]).reshape(-1, 8))


# Phase A's calls in one untiled forward and step at the default Config():
# (C feature rows, N) of K6, K7 (feature rows only) and K3's recompute
# (K7's calls over all 8 + C rows).
PHASE_A_CALLS = sorted({(1, 53248), (64, 53248), (64, 18432), (128, 18432), (128, 5120),
                        (256, 5120), (256, 1536), (512, 1536), (72, 18432), (136, 5120),
                        (264, 1536)})


@pytest.mark.parametrize("c_feat,n", PHASE_A_CALLS)
def test_phase_a_split_fills_the_card_with_no_empty_block(c_feat, n):
    """The channel-group split is a pure function of the shape, covers the
    groups in whole blocks with none empty, and splits only where the
    16-query blocks alone leave the 132 SMs short of two blocks each."""
    split = phase_a_split(c_feat, n, 132)
    assert split == phase_a_split(c_feat, n, 132) >= 1
    if c_feat <= 4:
        assert split == 1
        return
    groups = -(-c_feat // 64)
    per = -(-groups // split)
    assert split <= groups and (split - 1) * per < groups <= split * per
    blocks = -(-n // 16)
    if split > 1:
        assert blocks * (split - 1) < 2 * 132
    else:
        assert blocks >= 2 * 132 or groups == 1


@pytest.mark.parametrize("influence,c", [("linear", 12), ("gaussian", 12), ("constant", 8),
                                         ("linear", 136)])
def test_k8_plain_matches_pallas(influence, c):
    s = _setup(2, c=c)
    rel, nx_t = _gathered(s)
    nx = np.ascontiguousarray(nx_t.transpose(2, 0, 1))
    weighted, nn = kpconv_weighted_reduce(T(rel), T(nx), T(s["kp"]), EXTENT, influence)
    want_w, want_nn = j_kpconv_weighted_reduce(J(rel), J(nx), J(s["kp"]), EXTENT, influence,
                                               interpret=True)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(want_nn))
    _close(weighted.numpy(), want_w, "weighted")


@pytest.mark.parametrize("influence,aggregation,c,d", CASES)
def test_k3_gathered_plain_matches_pallas(influence, aggregation, c, d):
    s = _setup(3, c=c, d=d)
    rel, nx_t = _gathered(s)
    args = (T(rel), T(nx_t), T(s["g"]), T(s["kp"]), T(s["w"]), EXTENT, influence, aggregation)
    dnx_t, dw = kpconv_fused_bwd(*args)
    want_dnx, want_dw = j_kpconv_fused_bwd(J(rel), J(nx_t), J(s["g"]), J(s["kp"]), J(s["w"]),
                                           EXTENT, influence, aggregation, interpret=True)
    _close(dw.numpy(), want_dw, "dW")
    _close(dnx_t.numpy(), want_dnx, "dnx_t")
    none, dw_only = kpconv_fused_bwd(*args, need_dnx=False)
    assert none is None
    np.testing.assert_array_equal(dw_only.numpy(), dw.numpy())


def _port_grads(s, merged, ones):
    """Outputs and d Σ(out·g [+ shortcut·g2]) / d(x, W, shortcut_x) through
    the port's ``kpconv(impl='fused')``."""
    x = T(np.ones_like(s["feats"][:, :1]) if ones else s["feats"]).requires_grad_(True)
    w = T(s["w"][:, : x.shape[1]]).clone().requires_grad_(True)
    sx = T(s["sx"]).requires_grad_(True) if merged else None
    res = kpconv(T(s["q"]), T(s["sup"]), T(s["inds"]).long(), x, T(s["kp"]), w, EXTENT,
                 impl="fused", ones_features=ones, shortcut_x=sx)
    out, short = res if merged else (res, None)
    loss = (out * T(s["g"])).sum()
    if merged:
        loss = loss + (short * T(s["g2"])).sum()
    loss.backward()
    outs = [out.detach().numpy()] + ([short.detach().numpy()] if merged else [])
    grads = [None if ones else x.grad.numpy(), w.grad.numpy()]
    return outs, grads + ([sx.grad.numpy()] if merged else [])


def _jax_grads(s, merged, ones):
    x0 = np.ones_like(s["feats"][:, :1]) if ones else s["feats"]
    w0 = s["w"][:, : x0.shape[1]]

    def run(x, w, sx):
        res = j_kpconv(J(s["q"]), J(s["sup"]), J(s["inds"]), x, J(s["kp"]), w, EXTENT,
                       ones_features=ones, impl="fused", interpret=True,
                       shortcut_x=sx if merged else None)
        return res if merged else (res, None)

    def loss(x, w, sx):
        out, short = run(x, w, sx)
        total = jnp.sum(out * J(s["g"]))
        if merged:
            total = total + jnp.sum(short * J(s["g2"]))
        return total, (out, short)

    grad_fn = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
    (_, (out, short)), grads = grad_fn(J(x0), J(w0), J(s["sx"]))
    outs = [np.asarray(out)] + ([np.asarray(short)] if merged else [])
    return outs, [None if ones else np.asarray(grads[0]), np.asarray(grads[1])] + (
        [np.asarray(grads[2])] if merged else [])


@pytest.mark.parametrize("merged,ones", [(False, False), (False, True), (True, False),
                                         (True, True)])
def test_fused_ad_grads_match_jax(merged, ones):
    """Outputs and gradients (features, W, shortcut features) of the fused
    route — K6 + K3 without ``shortcut_x``, the merged K7 + K3 with it — and
    of their ones-column variants (no feature gradient)."""
    s = _setup(4, c=12, d=16, c2=10)
    got_outs, got_grads = _port_grads(s, merged, ones)
    want_outs, want_grads = _jax_grads(s, merged, ones)
    for i, (got, want) in enumerate(zip(got_outs, want_outs)):
        _close(got, want, f"output {i}")
    for name, got, want in zip(("d x", "d W", "d shortcut_x"), got_grads, want_grads):
        if want is not None:
            _close(got, want, name)


@pytest.mark.parametrize("route", ["merged", "dense"])
def test_untiled_shortcut_splits_ties_evenly(route):
    """The untiled routes' strided shortcut (the max over the merged gather,
    or the dense ``max_pool``) against the JAX ``jnp.max`` VJP, with a tie
    built on purpose: two neighbors of one query carry the same row, so
    only an even split matches; the tiled route's first-maximum rule
    (``max_pool_tiled``) does not."""
    s = _setup(5, c=4, d=8, c2=6)
    ns, inds = s["sup"].shape[0], s["inds"]
    qi = int(np.argmax((inds < ns).sum(1) >= 2))
    a, b = (int(r) for r in inds[qi][:2])
    sx = s["sx"].copy()
    sx[a] = sx[b] = 10.0 + np.arange(sx.shape[1], dtype=np.float32)
    g = np.random.default_rng(6).normal(size=(inds.shape[0], sx.shape[1])).astype(np.float32)

    x = T(sx).requires_grad_(True)
    if route == "merged":
        _, short = kpconv(T(s["q"]), T(s["sup"]), T(inds).long(), T(s["feats"]), T(s["kp"]),
                          T(s["w"]), EXTENT, impl="fused", shortcut_x=x)
    else:
        short = max_pool(x, T(inds).long())
    (short * T(g)).sum().backward()

    def loss(f_):
        if route == "merged":
            _, sc = j_kpconv(J(s["q"]), J(s["sup"]), J(inds), J(s["feats"]), J(s["kp"]),
                             J(s["w"]), EXTENT, impl="fused", interpret=True, shortcut_x=f_)
        else:
            sc = j_max_pool(f_[None], J(inds)[None])[0]
        return jnp.sum(sc * J(g))

    want = np.asarray(jax.grad(loss)(J(sx)))
    _close(x.grad.numpy(), want, "shortcut gradient")
    assert np.all(want[a] != 0.0) and np.all(want[b] != 0.0)
    x2 = T(sx).requires_grad_(True)
    (max_pool_tiled(x2, T(inds).long()) * T(g)).sum().backward()
    assert not np.allclose(x2.grad.numpy(), want, rtol=1e-5, atol=1e-5)
