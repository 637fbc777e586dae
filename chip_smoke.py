#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pcrcg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it completes:

1. build    — compile every CUDA kernel from ``pcrcg_tpu_torch/csrc`` (one
               ``nvcc`` per source, all at once) and print ptxas's report.
2. kernels  — record the inputs each kernel gets on the real path (the
               assets pair at ``Config()`` budgets, seeded random weights),
               then hold every recorded call of the kernel against its plain
               PyTorch version on the card, and time kernel and plain
               version with CUDA events beside the least time the card could
               take (bytes / 3.35 TB/s or fp32 flops / 67 TFLOP/s).
3. path     — ``register_pair`` on the assets pair at full width: one warm
               call, then the launch counters are zeroed and 3 timed calls
               run; every kernel must have launched.  The transform must be
               finite with an orthonormal rotation.
4. agree    — at a small size, the CUDA path and the CPU plain path give
               the same transform (RMSE <= 0.2 m on the source cloud) and
               descriptors, with the same weights and the same draws.

Then it prints the card's ``name, power.limit``, one JSON line with every
kernel's numbers, and as its last line
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


def record_kernel_inputs(cfg, batch, model):
    """Run the pyramid and the forward once with recorders around both
    kernel wrappers; return the argument lists each call received."""
    import torch
    import pcrcg_tpu_torch.models.kpconv as kpconv_mod
    import pcrcg_tpu_torch.ops.tiled_search as search_mod
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

    calls = {"K1": [], "K2": []}
    real = {"K1": search_mod.tiled_candidate_distances, "K2": kpconv_mod.kpconv_tiled}

    def recorder(key):
        def fn(*args, **kw):
            calls[key].append((args, kw))
            return real[key](*args, **kw)
        return fn

    search_mod.tiled_candidate_distances = recorder("K1")
    kpconv_mod.kpconv_tiled = recorder("K2")
    try:
        with torch.no_grad():
            pyramid = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
            model(pyramid, batch.features[0])
        torch.cuda.synchronize()
    finally:
        search_mod.tiled_candidate_distances = real["K1"]
        kpconv_mod.kpconv_tiled = real["K2"]
    return calls


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
        out, nn = kpconv_tiled(*args, **kw)
        p_out, p_nn = kpconv_tiled_plain(*args, **kw)
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


def phase_path(cfg, batch, model):
    import torch
    from pcrcg_tpu_torch.eval.tester import register_pair
    from pcrcg_tpu_torch.ops import kpconv_tiled, search_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (model, cfg, batch.points[0], batch.masks[0], batch.features[0], gen)
    t0 = time.perf_counter()
    register_pair(*args)
    torch.cuda.synchronize()
    print(f"  warm call {time.perf_counter() - t0:.3f} s", flush=True)

    n_pairs = 3
    search_kernel.LAUNCHES = 0
    kpconv_tiled.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(n_pairs):
        res = register_pair(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": search_kernel.LAUNCHES, "K2": kpconv_tiled.LAUNCHES}
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
    return launches


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

    import numpy as np
    from pcrcg_tpu_torch.assets import demo_cloud_pair
    from pcrcg_tpu_torch.config import Config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    try:
        phase_build()

        cfg = Config()
        src, tgt = demo_cloud_pair()
        batch = make_pair_batch(
            [dict(src_pcd=src, tgt_pcd=tgt, rot=np.eye(3), trans=np.zeros(3))],
            cfg.budgets.points[0], device="cuda",
        )
        model = init_kpfcnn(cfg, seed=0, device="cuda")
        calls = record_kernel_inputs(cfg, batch, model)
        print(f"[kernels] recorded {len(calls['K1'])} K1 and {len(calls['K2'])} K2 calls "
              "on the full-width path", flush=True)
        results = {"K1": phase_k1(calls["K1"]), "K2": phase_k2(calls["K2"])}
        del calls
        torch.cuda.empty_cache()

        launches = phase_path(cfg, batch, model)
        phase_agree()
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
