#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pcrcg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it completes:

1. build    — compile every CUDA kernel from ``pcrcg_tpu_torch/csrc`` (one
               ``nvcc`` per source, all at once) and print ptxas's report.
2. kernels  — record the inputs each kernel gets on the real paths (the
               assets pair at ``Config()`` budgets, seeded random weights):
               K1 / K2 in a serving forward, K3 / K4 / K5 in the backward
               of one ``train_step``.  Hold every recorded call against the
               kernel's plain PyTorch version on the card (relative error
               <= 1e-4), and time kernel, plain version and, where one
               exists, the single PyTorch call for the same function with
               CUDA events, beside the least time the card could take
               (bytes / 3.35 TB/s or fp32 flops / 67 TFLOP/s).
3. path     — ``register_pair`` on the assets pair at full width: one warm
               call, then the launch counters are zeroed and 3 timed calls
               run; K1 and K2 must have launched.  The transform must be
               finite with an orthonormal rotation.
4. agree    — at a small size, the CUDA path and the CPU plain path give
               the same transform (RMSE <= 0.2 m on the source cloud) and
               descriptors, with the same weights and the same draws.
5. train    — ``train_step`` at full width on the assets pair under its
               ground-truth pose (3DLoMatch kitchen 21 -> 34): one warm
               step, then the counters are zeroed and 3 timed steps run.
               Loss and gradients finite, all 11 KPConv weights with a
               non-zero gradient, parameters moved, K1-K5 all launched.
6. agree-train — at the small size, the CUDA path and the CPU plain path
               give the same loss terms, gradients and parameters after two
               SGD steps, with the same weights and the same draws.

Then it prints the card's ``name, power.limit``, one JSON line with every
kernel's numbers (launches: the [train] run's), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, without CUDA or without the
package beside it, and on any failed check.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
KERNELS = {
    "K1": dict(
        name="tiled_candidate_distances", route="cuda",
        source="pcrcg_tpu_torch/csrc/search_distances.cu",
        replaces="pcrcg_tpu/ops/search_kernel.py:41",
    ),
    "K2": dict(
        name="kpconv_tiled", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_tiled.cu",
        replaces="pcrcg_tpu/ops/kpconv_tiled.py:62",
    ),
    "K3": dict(
        name="kpconv_bwd", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_bwd.cu",
        replaces="pcrcg_tpu/ops/kpconv_fused.py:450",
    ),
    "K4": dict(
        name="scatter_ds_feats", route="cuda",
        source="pcrcg_tpu_torch/csrc/tile_scatter.cu",
        replaces="pcrcg_tpu/ops/kpconv_tiled.py:507",
    ),
    "K5": dict(
        name="maxpool_bwd", route="cuda",
        source="pcrcg_tpu_torch/csrc/tile_scatter.cu",
        replaces="pcrcg_tpu/ops/kpconv_tiled.py:595",
    ),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, iters=10, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_build():
    from pcrcg_tpu_torch import kernels

    t0 = time.perf_counter()
    seconds = kernels.build_all()
    wall = time.perf_counter() - t0
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[build] {len(seconds)} sources in {wall:.1f} s wall "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()), flush=True)


def record_calls(run, targets):
    """Call ``run()`` with recorders around the kernel wrappers
    ``targets`` = {kernel id: (module, attribute)}; return the argument
    lists each wrapper received, per kernel id."""
    import torch

    calls = {key: [] for key in targets}
    real = {key: getattr(mod, attr) for key, (mod, attr) in targets.items()}

    def recorder(key):
        def fn(*args, **kw):
            calls[key].append((args, kw))
            return real[key](*args, **kw)
        return fn

    for key, (mod, attr) in targets.items():
        setattr(mod, attr, recorder(key))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for key, (mod, attr) in targets.items():
            setattr(mod, attr, real[key])
    return calls


def record_kernel_inputs(cfg, batch, model):
    """K1 / K2 arguments of one serving forward (pyramid + KPFCNN)."""
    import torch
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    import pcrcg_tpu_torch.ops.tiled_search as search_mod
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

    def run():
        with torch.no_grad():
            pyramid = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
            model(pyramid, batch.features[0])

    return record_calls(run, {"K1": (search_mod, "tiled_candidate_distances"),
                              "K2": (kt_mod, "kpconv_tiled")})


def record_backward_inputs(cfg, batch, state, generator):
    """K3 / K4 / K5 arguments of one full-width ``train_step``."""
    import pcrcg_tpu_torch.ops.kpconv_fused as kf_mod
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    from pcrcg_tpu_torch.train.step import train_step

    return record_calls(lambda: train_step(state, cfg, batch, generator=generator),
                        {"K3": (kf_mod, "kpconv_bwd"), "K4": (kt_mod, "scatter_ds_feats"),
                         "K5": (kt_mod, "maxpool_bwd")})


def phase_k1(calls):
    import torch
    from pcrcg_tpu_torch.ops.neighbors import _smallest_k
    from pcrcg_tpu_torch.ops.search_kernel import (
        tiled_candidate_distances, tiled_candidate_distances_plain,
    )

    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0.0, nbytes=0.0)
    for i, (args, kw) in enumerate(calls):
        q, supa, sel = args
        got = tiled_candidate_distances(q, supa, sel)
        want = tiled_candidate_distances_plain(q, supa, sel)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(got), torch.isinf(want)), "K1: +inf pattern differs")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
        res["max_abs_err"] = max(res["max_abs_err"], err)
        g_count, m_tiles = sel.shape
        cand = m_tiles * supa.shape[2]
        entries = g_count * 128 * cand
        nbytes = 4 * (q.numel() + supa.numel() + sel.numel() + entries)
        flops = 8.0 * entries
        ms = time_ms(lambda: tiled_candidate_distances(q, supa, sel))
        plain_ms = time_ms(lambda: tiled_candidate_distances_plain(q, supa, sel), iters=3)
        b_ms, b_by = bound(nbytes, flops)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["nbytes"] += nbytes
        res["flops"] += flops
        if i == 0:
            # The level-0 conv search: neighbor agreement after the top-k.
            k = 40
            gi, wi = _smallest_k(got, k)[1], _smallest_k(want, k)[1]
            agree = float((gi == wi).float().mean())
            print(f"  K1 level-0 conv search: d2 [{g_count * 128}, {cand}], "
                  f"top-{k} index agreement {agree:.6f}")
            check(agree >= 0.999, f"K1: top-k agreement {agree}")
        print(f"  K1 call {i}: G={g_count} M={m_tiles} max|dd2|={err:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})",
              flush=True)
    check(res["max_abs_err"] <= 1e-4, f"K1: max |dd2| {res['max_abs_err']}")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    res["library_ms"] = None  # no single PyTorch call gathers tiles and takes distances
    return res


def phase_k2(calls):
    import torch
    from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled, kpconv_tiled_plain

    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0)
    shapes = set()
    for i, (args, kw) in enumerate(calls):
        q, s, feats, lidx, tiles, kp, w = args[:7]
        # The path keeps phase A's ``weighted`` (the backward's input); the
        # check is on out and nn.
        out, nn = kpconv_tiled(*args, **kw)[:2]
        p_out, p_nn = kpconv_tiled_plain(*args, **kw)[:2]
        torch.cuda.synchronize()
        # nn counts neighbors whose feature sum is > 0; a sum within rounding
        # of 0 may count differently in the two summation orders.
        same = nn == p_nn
        check(float(same.float().mean()) >= 1 - 1e-4, f"K2 call {i}: neighbor counts differ")
        got, want = (out / nn[:, None])[same], (p_out / p_nn[:, None])[same]
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-12)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel <= 1e-4, f"K2 call {i}: max relative error {rel}")
        k_count, c_in, d = w.shape
        nq, h = q.shape[0], lidx.shape[1]
        m_tiles, tile = tiles.shape[1], kw.get("tile", 128)
        n_real = int((lidx[:nq] < m_tiles * tile).sum())
        flops = 2.0 * n_real * k_count * (c_in + 12) + 2.0 * nq * k_count * c_in * d
        nbytes = 4 * sum(t.numel() for t in (q, s, feats, lidx, tiles, kp, w)) + 4 * nq * (d + 1)
        ms = time_ms(lambda: kpconv_tiled(*args, **kw))
        plain_ms = time_ms(lambda: kpconv_tiled_plain(*args, **kw), iters=3)
        b_ms, b_by = bound(nbytes, flops)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["nbytes"] += nbytes
        res["flops"] += flops
        shapes.add((c_in, d))
        print(f"  K2 call {i}: Nq={nq} H={h} (C,D)=({c_in},{d}) max|d|={err:.3e} rel={rel:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})",
              flush=True)
    for need in ((1, 128), (64, 64), (256, 256), (512, 512)):
        check(need in shapes, f"K2: shape {need} not exercised")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    res["library_ms"] = None  # no single PyTorch call computes a KPConv
    return res


def rel_err(got, want):
    """(max |got − want|, that over max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-12)


def phase_k3(calls):
    import torch
    from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_bwd, kpconv_bwd_plain

    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0)
    for i, (args, kw) in enumerate(calls):
        q, s, lidx, tiles, kp, w, g, weighted = args[:8]
        dw, dnx = kpconv_bwd(*args, **kw)
        p_dw, p_dnx = kpconv_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        pairs = [(dw, p_dw)] + ([] if dnx is None else [(dnx, p_dnx)])
        errs = [rel_err(a, b) for a, b in pairs]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel <= 1e-4, f"K3 call {i}: max relative error {rel}")
        k_count, c_in, d = w.shape
        nq, h = q.shape[0], lidx.shape[1]
        flops = 2.0 * nq * k_count * c_in * d  # dW
        nbytes = 4 * sum(t.numel() for t in (q, s, lidx, tiles, kp, w, g, weighted, dw))
        need_dnx = dnx is not None
        if need_dnx:  # gW, the influences, dnx
            flops += 2.0 * nq * k_count * c_in * d + 2.0 * nq * h * k_count * (c_in + 6)
            nbytes += 4 * dnx.numel()
        del dw, dnx, p_dw, p_dnx
        ms = time_ms(lambda: kpconv_bwd(*args, **kw))
        plain_ms = time_ms(lambda: kpconv_bwd_plain(*args, **kw), iters=3)
        b_ms, b_by = bound(nbytes, flops)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("nbytes", nbytes), ("flops", flops)):
            res[key] += val
        print(f"  K3 call {i}: Nq={nq} H={h} (C,D)=({c_in},{d}) dnx={need_dnx} max|d|={err:.3e}"
              f" rel={rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    # No single PyTorch call computes dW, gW and the recomputed influences.
    res["library_ms"] = None
    return res


def _scatter_phase(key, calls, kernel, plain, library, count):
    """Shared K4 / K5 check: kernel vs plain version, then kernel, plain and
    the single index_add_ over pre-resolved rows timed."""
    import torch

    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    for i, (args, kw) in enumerate(calls):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        # Atomic sums in an order that varies run to run.
        err, rel = rel_err(got, want)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel <= 1e-4, f"{key} call {i}: max relative error {rel}")
        nbytes, flops = count(args)
        lib_fn = library(args)
        ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3)
        lib_ms = time_ms(lib_fn)
        b_ms, b_by = bound(nbytes, flops)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("nbytes", nbytes), ("flops", flops)):
            res[k] += val
        print(f"  {key} call {i}: {tuple(args[0].shape)} max|d|={err:.3e} rel={rel:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms index_add_ {lib_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    return res


def phase_k4(calls):
    import torch
    from pcrcg_tpu_torch.ops.kpconv_common import support_rows
    from pcrcg_tpu_torch.ops.kpconv_tiled import scatter_ds_feats, scatter_ds_feats_plain

    def resolved(args):
        dnx, lidx, tiles, ns = args[:4]
        tile = args[4] if len(args) > 4 else 128
        row, valid = support_rows(lidx, tiles, dnx.shape[0], ns, tile)
        return row, valid, ns

    def count(args):
        dnx, lidx, tiles = args[:3]
        _, valid, ns = resolved(args)
        n_real = int(valid.sum())
        c_in = dnx.shape[2]
        return 4 * (n_real * c_in + lidx.numel() + tiles.numel() + ns * c_in), float(n_real * c_in)

    def library(args):
        # The real (query, neighbor) rows only, resolved outside the timing:
        # the kernel skips shadows, and so does this index_add_.
        dnx = args[0]
        row, valid, ns = resolved(args)
        rows, src = row[valid], dnx[valid]
        out = torch.zeros(ns, dnx.shape[2], device=dnx.device)
        return lambda: out.index_add_(0, rows, src)

    return _scatter_phase("K4", calls, scatter_ds_feats, scatter_ds_feats_plain, library, count)


def phase_k5(calls):
    import torch
    from pcrcg_tpu_torch.ops.kpconv_tiled import maxpool_bwd, maxpool_bwd_plain

    def count(args):
        # Each index at the narrowest width the function needs: the
        # neighbor slot amax in the fewest bytes that hold H - 1 (one for
        # H <= 256), the global row in 4 bytes (the path passes both as
        # int64).
        g, amax, inds, ns = args[:4]
        slot_bytes = max(1, -(-(inds.shape[1] - 1).bit_length() // 8))
        return (4 * g.numel() + slot_bytes * amax.numel() + 4 * inds.numel()
                + 4 * ns * g.shape[1], float(g.numel()))

    def library(args):
        # The non-shadow (query, channel) entries only, resolved outside the
        # timing: the kernel skips shadows, and so does this index_add_.
        g, amax, inds, ns = args[:4]
        c_in = g.shape[1]
        rows = inds.gather(1, amax)
        valid = rows < ns
        flat = (rows * c_in + torch.arange(c_in, device=g.device))[valid]
        src = g[valid]
        out = torch.zeros(ns * c_in, device=g.device)
        return lambda: out.index_add_(0, flat, src)

    return _scatter_phase("K5", calls, maxpool_bwd, maxpool_bwd_plain, library, count)


def phase_path(cfg, batch, model):
    import torch
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.eval.tester import register_pair

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (model, cfg, batch.points[0], batch.masks[0], batch.features[0], gen)
    t0 = time.perf_counter()
    register_pair(*args)
    torch.cuda.synchronize()
    print(f"  warm call {time.perf_counter() - t0:.3f} s", flush=True)

    n_pairs = 3
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n_pairs):
        res = register_pair(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in ("K1", "K2")}
    T = res["transform"].double().cpu()
    rot = T[:, :3]
    ortho = float((rot.T @ rot - torch.eye(3, dtype=torch.float64)).abs().max())
    det = float(torch.linalg.det(rot))
    fitness = float(res["fitness"])
    out = res["outputs"]
    n0 = cfg.budgets.points[0]
    print(f"[path] {n_pairs / wall:.3f} pairs/s ({wall / n_pairs * 1e3:.1f} ms/pair), "
          f"launches per pair K1 {launches['K1'] / n_pairs:g} K2 {launches['K2'] / n_pairs:g}, "
          f"fitness {fitness:.4f}, transform finite {bool(torch.isfinite(T).all())}, "
          f"|R^T R - I| {ortho:.2e}, det {det:.6f}", flush=True)
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    check(bool(torch.isfinite(T).all()) and ortho < 1e-4 and abs(det - 1.0) < 1e-4,
          "transform is not a finite rigid motion")
    check(0.0 <= fitness <= 1.0, f"fitness {fitness}")
    check(tuple(out["feats_f"].shape) == (2, n0, cfg.final_feats_dim), "feats_f shape")
    check(bool(torch.isfinite(out["feats_f"]).all()), "feats_f not finite")
    for key in ("scores_overlap", "scores_saliency"):
        check(tuple(out[key].shape) == (2, n0), f"{key} shape")
        check(bool(((out[key] >= 0) & (out[key] <= 1)).all()), f"{key} outside [0, 1]")


def phase_agree():
    """CUDA path vs CPU plain path on a small crop, same weights, same draws."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair
    from pcrcg_tpu_torch.config import Budgets, tiny_test_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.eval.tester import register_pair
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn

    budgets = Budgets(points=(2048, 1024, 512, 256), neighbors=(40,) * 4, corr_k=8,
                      query_chunk=512, search_tile=128, search_m_tiles=4)
    cfg = tiny_test_config(budgets=budgets)
    src, tgt = demo_cloud_pair()

    def crop(p, n):
        d = ((p - np.median(p, 0)) ** 2).sum(1)
        return p[np.argsort(d, kind="stable")[:n]]

    sample = dict(src_pcd=crop(src, 2048), tgt_pcd=crop(tgt, 2000), rot=np.eye(3),
                  trans=np.zeros(3))
    n_points, iters, chunk = 512, 8192, 1024
    gen = torch.Generator().manual_seed(1)
    uniforms = (torch.rand(2048, generator=gen), torch.rand(2048, generator=gen))
    picks = torch.randint(0, n_points, (iters // chunk, chunk, 3), generator=gen)
    results = {}
    for dev in ("cpu", "cuda"):
        batch = make_pair_batch([sample], 2048, device=dev)
        model = init_kpfcnn(cfg, seed=2, device=dev)
        res = register_pair(
            model, cfg, batch.points[0], batch.masks[0], batch.features[0], device=dev,
            n_points=n_points, num_iterations=iters, hypothesis_chunk=chunk,
            uniforms=tuple(u.to(dev) for u in uniforms), picks=picks.to(dev),
        )
        results[dev] = (res, batch.points[0][0][batch.masks[0][0]].double().cpu())
    (rc, pts), (rg, _) = results["cpu"], results["cuda"]

    def move(T):
        T = T.double().cpu()
        return pts @ T[:, :3].T + T[:, 3]

    rmse = float(((move(rc["transform"]) - move(rg["transform"])) ** 2).sum(-1).mean().sqrt())
    fc = rc["outputs"]["feats_f"]
    fg = rg["outputs"]["feats_f"].cpu()
    mask = make_pair_batch([sample], 2048).masks[0]
    cos = (fc * fg).sum(-1)[mask]
    print(f"[agree] CUDA vs CPU plain path (N0=2048): transform RMSE {rmse:.3e} m, "
          f"descriptor cosine min {float(cos.min()):.7f}, fitness "
          f"{float(rg['fitness']):.4f} vs {float(rc['fitness']):.4f}", flush=True)
    check(rmse <= 0.2, f"CUDA and CPU transforms differ: RMSE {rmse}")
    check(float(cos.min()) > 0.999, "CUDA and CPU descriptors differ")


def phase_train(cfg, batch, state):
    """``train_step`` at full width: one warm step, then 3 timed steps with
    the launch counters zeroed just before them."""
    import torch
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.ops.neighbors import min_dist_sq, radius_sq
    from pcrcg_tpu_torch.train.step import train_step

    pts, msk = batch.points[0], batch.masks[0]
    warped = pts[0][msk[0]] @ batch.rot[0].T + batch.trans[0]
    share = float((min_dist_sq(warped, pts[1], msk[1]) <= radius_sq(cfg.overlap_radius))
                  .float().mean())
    print(f"  source points with a target point within {cfg.overlap_radius} m after the "
          f"GT pose: {share:.4f}", flush=True)
    check(share >= 0.02, f"overlap share {share}: the GT pose maps the wrong way")

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    train_step(state, cfg, batch, generator=gen)
    torch.cuda.synchronize()
    print(f"  warm step {time.perf_counter() - t0:.3f} s", flush=True)

    named = dict(state.model.named_parameters())
    grad_norms = {n: [] for n in named}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grad_norms[n].append(p.grad.detach().norm())) for n, p in named.items()]
    before = {n: p.detach().clone() for n, p in named.items()}
    n_steps = 3
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        totals = []
        for _ in range(n_steps):
            stats = train_step(state, cfg, batch, generator=gen)
            totals.append(stats["total"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for hk in hooks:
            hk.remove()
    launches = dict(kernels.LAUNCHES)
    kp_weights = [n for n in named if n.endswith("KPConv.weights")]
    zero_kp = [n for n in kp_weights if not all(float(v) > 0 for v in grad_norms[n])]
    bad = [n for n, v in grad_norms.items() if not all(bool(torch.isfinite(x)) for x in v)]
    static = [n for n, p in named.items() if torch.equal(p.detach(), before[n])]
    moved = len(named) - len(static)
    # A parameter may stay put only where its update is below its fp32
    # spacing (the saliency temperature, 5.0, takes updates of ~1e-8): its
    # momentum must still have moved.
    buffers = {n: state.optimizer.state[named[n]].get("momentum_buffer") for n in static}
    unmoved = [n for n, b in buffers.items() if b is None or not bool((b != 0).any())]
    print(f"[train] {wall / n_steps * 1e3:.1f} ms/step ({n_steps} steps, N0="
          f"{cfg.budgets.points[0]}, batch 1), launches per step "
          + " ".join(f"{k} {v / n_steps:g}" for k, v in launches.items())
          + f", {moved}/{len(named)} parameters moved, {len(kp_weights)} KPConv weights, "
          f"{len(kp_weights) - len(zero_kp)} with a non-zero gradient", flush=True)
    print("  loss terms (last step): " + ", ".join(
        f"{k} {float(v):.6f}" for k, v in sorted(stats.items())), flush=True)
    check(all(bool(torch.isfinite(t)) for t in totals), "train loss not finite")
    check(not bad, f"non-finite gradients: {bad[:5]}")
    check(len(kp_weights) == 11 and not zero_kp, f"KPConv weights without a gradient: {zero_kp}")
    check(all(len(grad_norms[n]) == n_steps for n in kp_weights), "a KPConv gradient is missing")
    if static:
        print(f"  unchanged in fp32 (update below the spacing, momentum non-zero): {static}",
              flush=True)
    check(not unmoved, f"parameters without an update: {unmoved}")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    return launches


def _overlap_crop(n_src, n_tgt):
    """The assets pair cut to the n nearest points of each cloud around one
    point of their overlap, with the GT pose."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
    from pcrcg_tpu_torch.ops.neighbors import min_dist_sq

    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    warped = src @ rot.T + trans
    d2 = min_dist_sq(torch.from_numpy(warped).cuda(), torch.from_numpy(tgt).cuda(),
                     torch.ones(len(tgt), dtype=torch.bool, device="cuda")).cpu().numpy()
    overlap = np.flatnonzero(d2 < 0.0375**2)
    center = src[overlap[len(overlap) // 2]]

    def near(p, c, n):
        return p[np.argsort(((p - c) ** 2).sum(1), kind="stable")[:n]]

    return dict(src_pcd=near(src, center, n_src), tgt_pcd=near(tgt, center @ rot.T + trans, n_tgt),
                rot=rot, trans=trans)


def phase_agree_train():
    """CUDA path vs CPU plain path of the training slice on a small crop,
    same weights, same draws: loss terms (relative 1e-4), each parameter's
    gradient (‖Δg‖ ≤ 1e-3·‖g‖ + 1e-6·max ‖g‖: atomics and cuBLAS sum in
    another order; the floor covers the biases whose gradient is zero in
    exact arithmetic) and its update over two SGD steps (‖Δu‖ ≤ 1e-2·‖u‖ +
    1e-5·max ‖u‖).  The second step's gradient is taken at weights that
    already differ by rounding, and this model amplifies that: the
    descriptor-space choices (the saliency labels' nearest-feature
    matches, the GCN's kNN) flip between near-tied candidates.  For scale
    the phase also runs the CPU path from weights perturbed by 1e-7
    relative and prints how far its updates land from the unperturbed
    ones under the same bound."""
    import torch
    from pcrcg_tpu_torch.config import Budgets, tiny_test_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import pair_loss, train_step

    budgets = Budgets(points=(2048, 1024, 512, 256), neighbors=(40,) * 4, corr_k=8,
                      query_chunk=512, search_tile=128, search_m_tiles=4)
    cfg = tiny_test_config(budgets=budgets, node_overlap=True, quaternion=True)
    sample = _overlap_crop(2048, 2000)
    gen = torch.Generator().manual_seed(3)
    draws = torch.rand(3, 1, 2048 * budgets.corr_k, generator=gen)
    res = {}
    for dev, eps in (("cpu", 0.0), ("cuda", 0.0), ("cpu", 1e-7)):
        batch = make_pair_batch([sample], 2048, device=dev)
        state = TrainState(cfg, init_kpfcnn(cfg, seed=2, device=dev), steps_per_epoch=1)
        if eps:
            noise = torch.Generator().manual_seed(4)
            with torch.no_grad():
                for p in state.model.parameters():
                    p.mul_(1.0 + eps * torch.randn(p.shape, generator=noise))
        with torch.enable_grad():
            stats = pair_loss(state.model, cfg, batch.points[0], batch.masks[0],
                              batch.features[0], batch.rot[0], batch.trans[0],
                              uniforms=draws[0, 0].to(dev))
            stats["total"].backward()
        grads = {n: p.grad.double().cpu() for n, p in state.model.named_parameters()}
        state.zero_grad()
        start = {n: p.detach().double().cpu() for n, p in state.model.named_parameters()}
        totals = [float(train_step(state, cfg, batch, uniforms=u.to(dev))["total"])
                  for u in draws[1:]]
        updates = {n: p.detach().double().cpu() - start[n]
                   for n, p in state.model.named_parameters()}
        res[dev, eps] = ({k: float(v) for k, v in stats.items()}, grads, updates, totals)
    (sc, gc, uc, tc), (sg, gg, ug, tg) = res["cpu", 0.0], res["cuda", 0.0]
    up = res["cpu", 1e-7][2]
    stat_rel = max(abs(sg[k] - v) / max(abs(v), 1e-6) for k, v in sc.items())

    def ranked(got, want, rtol, floor_rtol):
        """Per parameter: ‖got − want‖ over its bound rtol·‖want‖ +
        floor_rtol·max ‖want‖, the worst first."""
        floor = floor_rtol * max(float(w.norm()) for w in want.values())
        return sorted(((float((got[n] - w).norm()) / (rtol * float(w.norm()) + floor), n,
                        float(w.norm())) for n, w in want.items()), reverse=True)

    def show(rank):
        return "; ".join(f"{n} {r:.3f} (norm {w:.2e})" for r, n, w in rank[:2])

    grad_rank = ranked(gg, gc, 1e-3, 1e-6)
    step_rank, noise_rank = ranked(ug, uc, 1e-2, 1e-5), ranked(up, uc, 1e-2, 1e-5)
    print("  step totals CUDA " + ", ".join(f"{t:.6f}" for t in tg) + " vs CPU "
          + ", ".join(f"{t:.6f}" for t in tc) + "; worst share of the bound: gradients "
          + show(grad_rank) + "; two-step updates " + show(step_rank)
          + "; CPU from weights perturbed by 1e-7 " + show(noise_rank), flush=True)
    print(f"[agree-train] CUDA vs CPU plain path (N0=2048, both heads): loss terms max "
          f"relative difference {stat_rel:.3e} (total {sg['total']:.6f} vs {sc['total']:.6f}, "
          f"circle {sg['circle_loss']:.6f}), gradients at {grad_rank[0][0]:.3f} and two-step "
          f"updates at {step_rank[0][0]:.3f} of their bounds (a 1e-7 weight perturbation "
          f"of the CPU path: {noise_rank[0][0]:.3f})", flush=True)
    check(sc["circle_loss"] > 0, "the agree-train crop has no circle-loss pairs")
    check(stat_rel <= 1e-4, f"loss terms differ: {stat_rel}")
    check(grad_rank[0][0] <= 1.0, f"gradients differ: {grad_rank[0]}")
    check(step_rank[0][0] <= 1.0, f"updates after two steps differ: {step_rank[0]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "pcrcg_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the pcrcg_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.set_grad_enabled(False)

    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
    from pcrcg_tpu_torch.config import Config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.train.state import TrainState

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    try:
        phase_build()

        cfg = Config()
        src, tgt = demo_cloud_pair()
        rot, trans = demo_pair_gt_pose()
        batch = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)],
                                cfg.budgets.points[0], device="cuda")
        model = init_kpfcnn(cfg, seed=0, device="cuda")
        calls = record_kernel_inputs(cfg, batch, model)
        print(f"[kernels] recorded {len(calls['K1'])} K1 and {len(calls['K2'])} K2 calls "
              "on the full-width path", flush=True)
        results = {"K1": phase_k1(calls["K1"]), "K2": phase_k2(calls["K2"])}
        del calls
        torch.cuda.empty_cache()

        phase_path(cfg, batch, model)
        phase_agree()

        state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(1)
        calls = record_backward_inputs(cfg, batch, state, gen)
        print(f"[kernels] recorded {len(calls['K3'])} K3, {len(calls['K4'])} K4 and "
              f"{len(calls['K5'])} K5 calls in the backward of one full-width train_step",
              flush=True)
        results.update(K3=phase_k3(calls["K3"]), K4=phase_k4(calls["K4"]),
                       K5=phase_k5(calls["K5"]))
        del calls
        torch.cuda.empty_cache()

        launches = phase_train(cfg, batch, state)
        phase_agree_train()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    entries = []
    for key, meta in KERNELS.items():
        r = results[key]
        entries.append(dict(
            meta, launches=launches[key], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
