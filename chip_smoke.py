#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pcrcg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it completes:

1. build    — compile every CUDA kernel from ``pcrcg_tpu_torch/csrc`` (one
               ``nvcc`` per source, all at once) and print ptxas's report.
2. kernels  — record the inputs each kernel gets on the real paths (the
               assets pair at ``Config()`` budgets, seeded random weights):
               K1 / K2 in a serving forward, K3 (with K4's scatter folded
               in) / K5 in the backward of one ``train_step``.  Hold every
               recorded call against the kernel's plain PyTorch version on
               the card (relative error <= 1e-4), and time kernel, plain
               version and, where one exists, the single PyTorch call for
               the same function (``time_ms``: device time, the calls back
               to back behind a sleep that covers their enqueueing), beside
               the least time the card could take (bytes / 3.35 TB/s or
               flops at the card's peak for their type: fp32 67 TFLOP/s;
               the W products of K2 and K3 as three TF32 passes at 495
               TFLOP/s).  K2 also shows its two phases apart, beside
               ``torch.matmul`` in fp32 on phase B's operands; K3 its two
               products apart, beside ``torch.matmul`` in fp32 on theirs
               (diagnostics; the port never calls it), with dW bit for bit
               the same on two runs and each product within 1e-5 of its
               largest entry against float64.
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
7. kernels-untiled — as 2, for the untiled routes: K6 / K7 in a serving
               forward under ``Config(kpconv_tiled=False)``, K8 under
               ``Config(kpconv_impl="reduce")``, K3's gathered entry (its
               products apart, as K3's tiled entry) in the backward of one
               untiled ``train_step`` (nn equal on >= 1 - 1e-4 of the
               queries, as for K2).
8. path-untiled, path-reduce — 3 on those routes: K6 8 and K7 3 launches
               per pair and K2 none; K8 10 per pair.
9. routes   — the same weights and pyramid through the tiled, untiled and
               reduce routes at full width: descriptor cosine > 0.999,
               scores within 1e-3 (one function in three summation orders).
10. train-untiled — 5 under ``kpconv_tiled=False``: K6, K7 and K3 launched,
               K2 and K5 not; the gathers' feature gradient is a plain
               ``index_add_`` (the backward of ``index_select``).
11. agree-untiled — 4 and 6 once more under ``kpconv_tiled=False``.

Then it prints the card's ``name, power.limit``, one JSON line with every
kernel's numbers (launches: K1-K5 from [train], K6 / K7 and K3's gathered
entry from [train-untiled], K8 from [path-reduce]; K4 runs inside K3's
tiled entry, so its row gives that entry's time and bound), and as its
last line ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
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
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
TF32_PASSES = 3  # the W products (K2, K3): error-compensated TF32, three products
# torch.cuda._sleep spins for a number of SM cycles; the H100's top SM clock
# is 1.98 GHz, so n cycles last at least n / 2e9 s.
SLEEP_CYCLES_PER_S = 2.0e9
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
        name="kpconv_tiled_bwd", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_bwd.cu",
        replaces="pcrcg_tpu/ops/kpconv_fused.py:450",
    ),
    # K4's scatter runs inside K3's candidate-tile entry: its row gives the
    # pair's time and bound, its own error (ds) and index_add_'s time.
    "K4": dict(
        name="kpconv_tiled_bwd (scatter fused into K3)", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_bwd.cu",
        replaces="pcrcg_tpu/ops/kpconv_tiled.py:507",
    ),
    "K5": dict(
        name="maxpool_bwd", route="cuda",
        source="pcrcg_tpu_torch/csrc/tile_scatter.cu",
        replaces="pcrcg_tpu/ops/kpconv_tiled.py:595",
    ),
    "K3g": dict(
        name="kpconv_fused_bwd", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_bwd.cu",
        replaces="pcrcg_tpu/ops/kpconv_fused.py:450",
    ),
    "K6": dict(
        name="kpconv_fused", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_fused.cu",
        replaces="pcrcg_tpu/ops/kpconv_fused.py:86",
    ),
    "K7": dict(
        name="kpconv_fused_merged", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_fused.cu",
        replaces="pcrcg_tpu/ops/kpconv_fused.py:162",
    ),
    "K8": dict(
        name="kpconv_weighted_reduce", route="cuda",
        source="pcrcg_tpu_torch/csrc/kpconv_reduce.cu",
        replaces="pcrcg_tpu/ops/kpconv_pallas.py:37",
    ),
}
FULL_SHAPES = ((1, 128), (64, 64), (128, 128), (256, 256), (512, 512))


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, iters=10, warmup=2):
    """Mean device milliseconds per call of ``fn``: ``iters`` calls back to
    back on the card between two CUDA events.  Before the start event the
    stream sleeps for longer than the host takes to enqueue all the calls
    (twice the host-clock time of one call, times ``iters``), so the host
    work of a call (argument checks, allocations, the launch) does not
    show as device time.  A call that synchronizes inside still waits on
    the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep_s = min(2.0 * iters * host_s + 1e-3, 5.0)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, tf32_flops=0.0):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over their peak rate (fp32 ``flops`` on the CUDA
    cores, ``tf32_flops`` on the tensor cores, one after the other)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S + tf32_flops / TF32_FLOPS_PER_S
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
    """K3 / K4 / K5 arguments of one full-width ``train_step``: K3's
    candidate-tile entry with K4 folded in (``kpconv_tiled_bwd``) or, on a
    tree from before the fold (timed for comparison), K3 and K4 apart."""
    import pcrcg_tpu_torch.ops.kpconv_fused as kf_mod
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    from pcrcg_tpu_torch.train.step import train_step

    targets = {"K5": (kt_mod, "maxpool_bwd")}
    if hasattr(kt_mod, "kpconv_tiled_bwd"):
        targets["K3"] = (kt_mod, "kpconv_tiled_bwd")
    else:
        targets.update(K3=(kf_mod, "kpconv_bwd"), K4=(kt_mod, "scatter_ds_feats"))
    return record_calls(lambda: train_step(state, cfg, batch, generator=generator), targets)


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
    """K2 against its plain version on every recorded call, and timed: the
    whole kernel, its phase A (influence + reduce) and phase B (the 3xTF32
    W product) apart, ``torch.matmul`` in fp32 on phase B's operands, the
    plain version; bound with the W product as three TF32 passes (and, for
    comparison, all in fp32 on the CUDA cores)."""
    import torch
    from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled, kpconv_tiled_plain

    try:
        from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled_reduce
        from pcrcg_tpu_torch.ops.tc_gemm import plan_gemm, tc_gemm
    except ImportError:  # a tree from before the phase split: K2 is one C entry
        kpconv_tiled_reduce = None

    torch.backends.cuda.matmul.allow_tf32 = False  # the diagnostic matmul in full fp32
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0.0, a_flops=0.0, w_flops=0.0,
               a_ms=0.0, b_ms=0.0, matmul_ms=0.0)
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
        del out, nn, p_out, p_nn, got, want, same
        k_count, c_in, d = w.shape
        nq, h = q.shape[0], lidx.shape[1]
        m_tiles, tile = tiles.shape[1], kw.get("tile", args[10] if len(args) > 10 else 128)
        conf = dict(zip(("kp_extent", "influence", "aggregation", "tile"), args[7:11]))
        conf.update((k, v) for k, v in kw.items() if k != "keep_weighted")
        n_real = int((lidx[:nq] < m_tiles * tile).sum())
        a_flops = 2.0 * n_real * k_count * (c_in + 12)
        w_flops = 2.0 * nq * k_count * c_in * d
        nbytes = 4 * sum(t.numel() for t in (q, s, feats, lidx, tiles, kp, w)) + 4 * nq * (d + 1)
        ms = time_ms(lambda: kpconv_tiled(*args, **kw))
        plain_ms = time_ms(lambda: kpconv_tiled_plain(*args, **kw), iters=3)
        split = ""
        if kpconv_tiled_reduce is not None:
            w2 = w.reshape(k_count * c_in, d)
            weighted = kpconv_tiled_reduce(q, s, feats, lidx, tiles, kp, k_count, **conf)[0]
            b_err = rel_err(tc_gemm(weighted, w2), weighted @ w2)[1]
            a_ms = time_ms(lambda: kpconv_tiled_reduce(q, s, feats, lidx, tiles, kp, k_count,
                                                       **conf))
            b_ms = time_ms(lambda: tc_gemm(weighted, w2))
            mm_ms = time_ms(lambda: torch.matmul(weighted, w2))
            del weighted
            plan = plan_gemm(nq, d, k_count * c_in,
                             torch.cuda.get_device_properties(0).multi_processor_count)
            split = (f" (phase A {a_ms:.4f}, phase B {b_ms:.4f} [split-K {plan.splits}, "
                     f"rel {b_err:.1e} vs fp32 matmul], torch.matmul fp32 {mm_ms:.4f})")
            for key, val in (("a_ms", a_ms), ("b_ms", b_ms), ("matmul_ms", mm_ms)):
                res[key] += val
        b3, b3_by = bound(nbytes, a_flops, TF32_PASSES * w_flops)
        b32 = bound(nbytes, a_flops + w_flops)[0]
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("nbytes", nbytes),
                         ("a_flops", a_flops), ("w_flops", w_flops)):
            res[key] += val
        shapes.add((c_in, d))
        print(f"  K2 call {i}: Nq={nq} H={h} (C,D)=({c_in},{d}) max|d|={err:.3e} rel={rel:.3e} "
              f"kernel {ms:.4f} ms{split} plain {plain_ms:.4f} ms bound {b3:.4f} ms "
              f"({b3_by}; all fp32: {b32:.4f})", flush=True)
    for need in ((1, 128), (64, 64), (256, 256), (512, 512)):
        check(need in shapes, f"K2: shape {need} not exercised")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["a_flops"],
                                             TF32_PASSES * res["w_flops"])
    bound_fp32 = bound(res["nbytes"], res["a_flops"] + res["w_flops"])[0]
    split = ""
    if res["b_ms"] > 0:
        w_tflops = TF32_PASSES * res["w_flops"] / (res["b_ms"] * 1e-3) / 1e12
        split = (f" = phase A {res['a_ms']:.4f} + phase B {res['b_ms']:.4f} ms "
                 f"({w_tflops:.1f} TFLOP/s of TF32 product, {res['w_flops'] / 1e9:.1f} GFLOP x "
                 f"{TF32_PASSES}; torch.matmul fp32 {res['matmul_ms']:.4f} ms)")
    print(f"[kernels] K2 over {len(calls)} calls: {res['ms']:.4f} ms{split}; bound "
          f"{res['bound_ms']:.4f} ms (W as 3xTF32) / {bound_fp32:.4f} ms (all fp32)", flush=True)
    res["library_ms"] = None  # no single PyTorch call computes a KPConv
    return res


def rel_err(got, want):
    """(max |got − want|, that over max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-12)


def fp64_err(got, a, b):
    """max |got − a @ b| over the largest entry of a @ b, both in float64."""
    exact = a.double() @ b.double()
    return float((got.double() - exact).abs().max()) / max(float(exact.abs().max()), 1e-300)


def phase_k3_k4(calls):
    """K3's candidate-tile entry with K4's scatter folded in, on every
    recorded call: dW and ds against K3's then K4's plain versions
    (relative 1e-4; ds is summed by atomics), dW bit for bit against a
    second run and within 1e-5 of its largest entry against float64, as is
    gW's product.  Timed: the entry; its two products apart (``tc_gemm`` on
    the same operands and plans; the rest is the difference) beside
    ``torch.matmul`` in fp32 on the same operands (a diagnostic, cuBLAS);
    the plain version; ``index_add_`` for K4's scatter alone.  Bound: the
    products as three TF32 passes, the rest fp32, against the bytes read
    and written once (dnx is not written); the unfused rule (all fp32, dnx
    written by K3 and read by K4) beside it.  -> (K3's result, K4's)."""
    import torch
    from pcrcg_tpu_torch.ops.kpconv_common import support_rows
    from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_bwd_plain
    from pcrcg_tpu_torch.ops.kpconv_tiled import (
        kpconv_tiled_bwd, kpconv_tiled_bwd_plain, scatter_ds_feats_plain,
    )
    from pcrcg_tpu_torch.ops.tc_gemm import tc_gemm

    torch.backends.cuda.matmul.allow_tf32 = False  # the diagnostic matmuls in full fp32
    k3 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0.0, flops=0.0, prod_flops=0.0,
              dw_ms=0.0, gw_ms=0.0, matmul_ms=0.0, library_ms=None)
    # Sums under the unfused rule, bytes and fp32 flops: K3 and K4 apart.
    old = dict(k3_bytes=0.0, k3_flops=0.0, k4_bytes=0.0, k4_flops=0.0)
    k4 = dict(max_abs_err=0.0, library_ms=0.0)
    n_ds = 0
    for i, (args, kw) in enumerate(calls):
        q, s, lidx, tiles, kp, w, g, weighted = args[:8]
        conf = args[8:12]  # kp_extent, influence, aggregation, tile
        tile = conf[3]
        need_ds = kw.get("need_ds", True)
        k_count, c_in, d = w.shape
        kc, nq, ns, h = k_count * c_in, q.shape[0], s.shape[0], lidx.shape[1]
        w2 = w.reshape(kc, d)
        dw, ds = kpconv_tiled_bwd(*args, **kw)
        dw_again = kpconv_tiled_bwd(*args, **kw)[0]
        p_dw, p_dnx = kpconv_bwd_plain(*args[:8], *conf, need_dnx=need_ds)
        torch.cuda.synchronize()
        check(torch.equal(dw, dw_again), f"K3 call {i}: dW differs between two runs")
        del dw_again
        err, rel = rel_err(dw, p_dw)
        check(rel <= 1e-4, f"K3 call {i}: dW max relative error {rel}")
        dw64 = fp64_err(dw.reshape(kc, d), weighted.T, g)
        check(dw64 <= 1e-5, f"K3 call {i}: dW vs float64 {dw64}")
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        row, valid = support_rows(lidx, tiles, nq, ns, tile)
        n_real = int(valid.sum())
        prod = 2.0 * nq * kc * d  # dW
        rest = 0.0
        nbytes = 4 * sum(t.numel() for t in (q, s, lidx, tiles, kp, w, g, weighted, dw))
        # The unfused rule: all fp32, dnx written by K3 (and read by K4).
        old_flops, old_bytes = prod, nbytes
        extra = ""
        if need_ds:
            n_ds += 1
            p_ds = scatter_ds_feats_plain(p_dnx, lidx, tiles, ns, tile)
            torch.cuda.synchronize()
            ds_err, ds_rel = rel_err(ds, p_ds)
            check(ds_rel <= 1e-4, f"K4 (in K3) call {i}: ds max relative error {ds_rel}")
            k4["max_abs_err"] = max(k4["max_abs_err"], ds_err)
            gw = tc_gemm(g, w2, trans_b=True)
            gw64 = fp64_err(gw, g, w2.T)
            check(gw64 <= 1e-5, f"K3 call {i}: gW vs float64 {gw64}")
            del gw, p_ds
            prod += 2.0 * nq * kc * d  # gW
            # Influences and dnx over the real neighbors, and the scatter's adds.
            rest = 2.0 * n_real * k_count * (c_in + 12) + n_real * c_in
            nbytes += 4 * ns * c_in
            old_flops += 2.0 * nq * kc * d + 2.0 * nq * h * k_count * (c_in + 6)
            old_bytes += 4 * nq * h * c_in
            rows, src = row[valid], p_dnx[valid]
            lib_ms = time_ms(lambda: torch.zeros(ns, c_in, device=g.device)
                             .index_add_(0, rows, src))
            k4["library_ms"] += lib_ms
            old["k4_bytes"] += 4 * (n_real * c_in + lidx.numel() + tiles.numel() + ns * c_in)
            old["k4_flops"] += n_real * c_in
            gw_ms = time_ms(lambda: tc_gemm(g, w2, trans_b=True))
            mm_gw = time_ms(lambda: torch.matmul(g, w2.T))
            del rows, src
            extra = (f" ds max|d|={ds_err:.3e} rel={ds_rel:.3e} gW vs f64 {gw64:.1e};"
                     f" index_add_ {lib_ms:.4f} ms")
        else:
            gw_ms = mm_gw = 0.0
        del dw, ds, p_dw, p_dnx
        ms = time_ms(lambda: kpconv_tiled_bwd(*args, **kw))
        plain_ms = time_ms(lambda: kpconv_tiled_bwd_plain(*args, **kw), iters=3)
        dw_ms = time_ms(lambda: tc_gemm(weighted, g, trans_a=True))
        mm_ms = time_ms(lambda: torch.matmul(weighted.T, g)) + mm_gw
        b_ms, b_by = bound(nbytes, rest, TF32_PASSES * prod)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("nbytes", nbytes), ("flops", rest),
                         ("prod_flops", prod), ("dw_ms", dw_ms), ("gw_ms", gw_ms),
                         ("matmul_ms", mm_ms)):
            k3[key] += val
        old["k3_bytes"] += old_bytes
        old["k3_flops"] += old_flops
        print(f"  K3 call {i}: Nq={nq} H={h} (C,D)=({c_in},{d}) ds={need_ds} max|d|={err:.3e} "
              f"rel={rel:.3e} dW vs f64 {dw64:.1e};{extra} kernel {ms:.4f} ms (products dW "
              f"{dw_ms:.4f} + gW {gw_ms:.4f}; torch.matmul fp32 {mm_ms:.4f}) plain "
              f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})", flush=True)
    k3["bound_ms"], k3["bound_by"] = bound(k3["nbytes"], k3["flops"],
                                           TF32_PASSES * k3["prod_flops"])
    products = k3["dw_ms"] + k3["gw_ms"]
    rate = TF32_PASSES * k3["prod_flops"] / (products * 1e-3) / 1e12
    print(f"[kernels] K3 (tiled, K4's scatter folded in) over {len(calls)} calls: "
          f"{k3['ms']:.4f} ms = products {products:.4f} (dW {k3['dw_ms']:.4f} + gW "
          f"{k3['gw_ms']:.4f}; {rate:.1f} TFLOP/s of TF32 product, "
          f"{k3['prod_flops'] / 1e9:.1f} GFLOP x {TF32_PASSES}; torch.matmul fp32 on the same "
          f"operands, allow_tf32=False: {k3['matmul_ms']:.4f}) + rest "
          f"{k3['ms'] - products:.4f}; bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}; "
          f"products as 3xTF32, dnx not written); unfused rule (all fp32, dnx written and read):"
          f" K3 {bound(old['k3_bytes'], old['k3_flops'])[0]:.4f} + K4 "
          f"{bound(old['k4_bytes'], old['k4_flops'])[0]:.4f} ms", flush=True)
    print(f"[kernels] K4: its scatter runs inside K3's entry ({n_ds} of the {len(calls)} calls),"
          f" no time of its own; index_add_ over the real rows of the plain dnx, with its zero "
          f"fill: {k4['library_ms']:.4f} ms", flush=True)
    for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
        k4[key] = k3[key]
    return k3, k4


def phase_k3_unfused(calls):
    """K3's candidate-tile entry on a tree from before K4 was folded into
    it (dW and dnx written): checked and timed as that tree's kernel, for
    the comparison of K3 + K4 with the fused entry."""
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
    the single index_add_ over pre-resolved rows (with its output's zero
    fill, as the kernels make theirs) timed."""
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


def phase_k4_unfused(calls):
    """K4 on a tree from before it was folded into K3 (see
    ``phase_k3_unfused``)."""
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
        # The zero fill is timed, as the kernel's wrapper makes it.
        row, valid, ns = resolved(args)
        rows, src = row[valid], dnx[valid]
        c_in = dnx.shape[2]
        return lambda: torch.zeros(ns, c_in, device=dnx.device).index_add_(0, rows, src)

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
        # The zero fill is timed, as the kernel makes it.
        g, amax, inds, ns = args[:4]
        c_in = g.shape[1]
        rows = inds.gather(1, amax)
        valid = rows < ns
        flat = (rows * c_in + torch.arange(c_in, device=g.device))[valid]
        src = g[valid]
        return lambda: torch.zeros(ns * c_in, device=g.device).index_add_(0, flat, src)

    res = _scatter_phase("K5", calls, maxpool_bwd, maxpool_bwd_plain, library, count)
    # The kernel reads every entry; the yardstick only those with a real row.
    real = sum(int((a[2].gather(1, a[1]) < a[3]).sum()) for a, _ in calls)
    total = sum(a[1].numel() for a, _ in calls)
    verdict = "no slower than" if res["ms"] <= res["library_ms"] else "slower than"
    print(f"[kernels] K5 {res['ms']:.4f} ms over {len(calls)} calls: {verdict} its yardstick "
          f"(index_add_ with its zero fill, {res['library_ms']:.4f} ms, over the {real / total:.3f}"
          f" of the entries with a real row); {res['bound_ms'] / res['ms']:.2f} of its bound "
          f"({res['bound_ms']:.4f} ms)", flush=True)
    return res


def record_untiled_inputs(batch, model_untiled, cfg_untiled, model_reduce, cfg_reduce):
    """K6 / K7 arguments of one untiled serving forward, K8's of one on the
    reduce route."""
    import torch
    import pcrcg_tpu_torch.ops.kpconv_fused as kf_mod
    import pcrcg_tpu_torch.ops.kpconv_pallas as kr_mod
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

    def forward(model, cfg):
        def run():
            with torch.no_grad():
                model(build_pyramid_cfg(cfg, batch.points[0], batch.masks[0]),
                      batch.features[0])
        return run

    calls = record_calls(forward(model_untiled, cfg_untiled),
                         {"K6": (kf_mod, "kpconv_fused"), "K7": (kf_mod, "kpconv_fused_merged")})
    calls.update(record_calls(forward(model_reduce, cfg_reduce),
                              {"K8": (kr_mod, "kpconv_weighted_reduce")}))
    return calls


def real_slots(gathered, channel_dim):
    """(query, neighbor) slots whose gathered row is not all zero: the real
    neighbors (a shadow gathers zeros; the merged gather's real rows carry
    their coordinates)."""
    return int((gathered != 0).any(channel_dim).sum())


def _gathered_conv_phase(key, calls, kernel, plain, shapes):
    """K6 / K7: each recorded call against its plain version (outputs after
    the ÷nn on the queries whose counts agree, which must be >= 1 - 1e-4 of
    them), then kernel and plain version timed beside the bound."""
    import torch

    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0)
    seen = set()
    for i, (args, kw) in enumerate(calls):
        feats_t, kp, w = args[1], args[2], args[3]
        out, nn = kernel(*args, **kw)
        p_out, p_nn = plain(*args, **kw)
        torch.cuda.synchronize()
        same = nn == p_nn
        check(float(same.float().mean()) >= 1 - 1e-4, f"{key} call {i}: neighbor counts differ")
        err, rel = rel_err((out / nn[:, None])[same], (p_out / p_nn[:, None])[same])
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel <= 1e-4, f"{key} call {i}: max relative error {rel}")
        k_count, c_w, d = w.shape
        h, _, n = feats_t.shape
        n_real = real_slots(feats_t, 1)
        # K7's merged gather carries 8 rows before the C features: only the
        # 3 coordinate rows are needed, and W8's 8 zero rows add no work.
        c_in, rows = (c_w - 8, c_w - 5) if key == "K7" else (c_w, c_w)
        flops = 2.0 * n_real * k_count * (c_in + 12) + 2.0 * n * k_count * c_in * d
        nbytes = 4 * (args[0].numel() + h * rows * n + kp.numel() + k_count * c_in * d
                      + n * (d + 1))
        ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3)
        b_ms, b_by = bound(nbytes, flops)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("nbytes", nbytes), ("flops", flops)):
            res[k] += val
        seen.add((c_in, d))
        print(f"  {key} call {i}: N={n} H={h} (C,D)=({c_in},{d}) max|d|={err:.3e} rel={rel:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})",
              flush=True)
    for need in shapes:
        check(need in seen, f"{key}: shape {need} not exercised")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    # No single PyTorch call computes the influences, the reduce and the W product.
    res["library_ms"] = None
    return res


def phase_k6(calls):
    from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_fused, kpconv_fused_plain

    return _gathered_conv_phase("K6", calls, kpconv_fused, kpconv_fused_plain, FULL_SHAPES)


def phase_k7(calls):
    from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_fused_merged, kpconv_fused_merged_plain

    return _gathered_conv_phase("K7", calls, kpconv_fused_merged, kpconv_fused_merged_plain,
                                FULL_SHAPES[1:4])


def phase_k8(calls):
    import torch
    from pcrcg_tpu_torch.ops.kpconv_pallas import (
        kpconv_weighted_reduce, kpconv_weighted_reduce_plain,
    )

    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0)
    seen = set()
    for i, (args, kw) in enumerate(calls):
        rel, nx, kp = args[:3]
        weighted, nn = kpconv_weighted_reduce(*args, **kw)
        p_weighted, p_nn = kpconv_weighted_reduce_plain(*args, **kw)
        torch.cuda.synchronize()
        check(float((nn == p_nn).float().mean()) >= 1 - 1e-4, f"K8 call {i}: counts differ")
        err, rel_e = rel_err(weighted, p_weighted)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel_e <= 1e-4, f"K8 call {i}: max relative error {rel_e}")
        n, h, c_in = nx.shape
        k_count = kp.shape[0]
        flops = 2.0 * real_slots(nx, 2) * k_count * (c_in + 12)
        nbytes = 4 * (rel.numel() + nx.numel() + kp.numel() + weighted.numel() + n)
        del weighted, p_weighted
        ms = time_ms(lambda: kpconv_weighted_reduce(*args, **kw))
        plain_ms = time_ms(lambda: kpconv_weighted_reduce_plain(*args, **kw), iters=3)
        b_ms, b_by = bound(nbytes, flops)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("nbytes", nbytes), ("flops", flops)):
            res[k] += val
        seen.add(c_in)
        print(f"  K8 call {i}: N={n} H={h} C={c_in} max|d|={err:.3e} rel={rel_e:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})",
              flush=True)
    for need in (64, 128, 256, 512):
        check(need in seen, f"K8: width {need} not exercised")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    # No single PyTorch call computes the influences and the weighted reduce.
    res["library_ms"] = None
    return res


def record_gathered_backward_inputs(cfg, batch, state, generator):
    """K3's gathered-entry arguments in one untiled ``train_step``."""
    import pcrcg_tpu_torch.ops.kpconv_fused as kf_mod
    from pcrcg_tpu_torch.train.step import train_step

    return record_calls(lambda: train_step(state, cfg, batch, generator=generator),
                        {"K3g": (kf_mod, "kpconv_fused_bwd")})


def phase_k3g(calls):
    """K3's gathered entry on every recorded call against its plain version
    (relative 1e-4), dW bit for bit against a second run and within 1e-5 of
    its largest entry against float64, as is gW_t's product; timed with
    its products apart and ``torch.matmul`` in fp32 on their operands (a
    diagnostic), as ``phase_k3_k4``.  On a tree whose products are not on
    the tensor cores (``tc_gemm`` without the transposed layouts) only the
    entry and its plain version are timed."""
    import inspect
    import torch
    from pcrcg_tpu_torch.ops.kpconv_fused import (
        _gathered_weighted, kpconv_fused_bwd, kpconv_fused_bwd_plain,
    )
    from pcrcg_tpu_torch.ops.tc_gemm import tc_gemm

    split = "trans_b" in inspect.signature(tc_gemm).parameters
    torch.backends.cuda.matmul.allow_tf32 = False  # the diagnostic matmuls in full fp32
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, prod_flops=0.0, nbytes=0.0,
               dw_ms=0.0, gw_ms=0.0, matmul_ms=0.0, old_flops=0.0)
    for i, (args, kw) in enumerate(calls):
        rel, nx_t, g, kp, w = args[:5]
        dnx_t, dw = kpconv_fused_bwd(*args, **kw)
        dw_again = kpconv_fused_bwd(*args, **kw)[1]
        p_dnx, p_dw = kpconv_fused_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(dw, dw_again), f"K3 gathered call {i}: dW differs between two runs")
        pairs = [(dw, p_dw)] + ([] if dnx_t is None else [(dnx_t, p_dnx)])
        errs = [rel_err(a, b) for a, b in pairs]
        err, rel_e = max(e[0] for e in errs), max(e[1] for e in errs)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel_e <= 1e-4, f"K3 gathered call {i}: max relative error {rel_e}")
        k_count, c_w, d = w.shape
        h, _, n = nx_t.shape
        kc = k_count * c_w
        w2 = w.reshape(kc, d)
        n_real = real_slots(nx_t, 1)
        need_dnx = dnx_t is not None
        weighted_t = _gathered_weighted(rel, nx_t, kp, *args[5:8])[1].T.contiguous()
        dw64 = fp64_err(dw.reshape(kc, d), weighted_t, g)
        check(dw64 <= 1e-5, f"K3 gathered call {i}: dW vs float64 {dw64}")
        # A merged call (W8's 8 zero rows first) needs only the C feature
        # rows: rel is given, and autograd drops the dW and dnx rows over
        # the coordinates and pad.
        c_in = c_w - 8 if c_w > 8 and not bool(w[:, :8].any()) else c_w
        prod = 2.0 * n * k_count * c_in * d  # dW
        rest = 2.0 * n_real * k_count * (c_in + 12)  # weighted recomputed
        nbytes = 4 * (rel.numel() + h * c_in * n + g.numel() + kp.numel()
                      + 2 * k_count * c_in * d)
        if need_dnx:  # gW and dnx
            prod += 2.0 * n * k_count * c_in * d
            rest += 2.0 * n_real * k_count * c_in
            nbytes += 4 * h * c_in * n
        del dnx_t, dw, dw_again, p_dnx, p_dw
        ms = time_ms(lambda: kpconv_fused_bwd(*args, **kw))
        plain_ms = time_ms(lambda: kpconv_fused_bwd_plain(*args, **kw), iters=3)
        products = ""
        if split:
            dw_ms = time_ms(lambda: tc_gemm(weighted_t, g))
            mm_ms = time_ms(lambda: torch.matmul(weighted_t, g))
            gw_ms = gw64 = 0.0
            if need_dnx:
                gw64 = fp64_err(tc_gemm(w2, g, trans_b=True), w2, g.T)
                check(gw64 <= 1e-5, f"K3 gathered call {i}: gW_t vs float64 {gw64}")
                gw_ms = time_ms(lambda: tc_gemm(w2, g, trans_b=True))
                mm_ms += time_ms(lambda: torch.matmul(w2, g.T))
            for key, val in (("dw_ms", dw_ms), ("gw_ms", gw_ms), ("matmul_ms", mm_ms)):
                res[key] += val
            products = (f" (products dW {dw_ms:.4f} + gW {gw_ms:.4f}; torch.matmul fp32 "
                        f"{mm_ms:.4f}; vs f64 dW {dw64:.1e} gW {gw64:.1e})")
        del weighted_t
        b_ms, b_by = bound(nbytes, rest, TF32_PASSES * prod)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("nbytes", nbytes), ("flops", rest),
                         ("prod_flops", prod), ("old_flops", rest + prod)):
            res[key] += val
        print(f"  K3 gathered call {i}: N={n} H={h} (C,D)=({c_in},{d}) dnx={need_dnx} "
              f"max|d|={err:.3e} rel={rel_e:.3e} kernel {ms:.4f} ms{products} plain "
              f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})", flush=True)
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"],
                                             TF32_PASSES * res["prod_flops"])
    summary = ""
    if split:
        products = res["dw_ms"] + res["gw_ms"]
        rate = TF32_PASSES * res["prod_flops"] / (products * 1e-3) / 1e12
        summary = (f" = products {products:.4f} (dW {res['dw_ms']:.4f} + gW {res['gw_ms']:.4f};"
                   f" {rate:.1f} TFLOP/s of TF32 product; torch.matmul fp32 on the same "
                   f"operands, allow_tf32=False: {res['matmul_ms']:.4f}) + rest "
                   f"{res['ms'] - products:.4f}")
    print(f"[kernels-untiled] K3 gathered over {len(calls)} calls: {res['ms']:.4f} ms{summary}; "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}; products as 3xTF32); all-fp32 "
          f"rule {bound(res['nbytes'], res['old_flops'])[0]:.4f} ms", flush=True)
    # No single PyTorch call computes dW, gW and the recomputed influences.
    res["library_ms"] = None
    return res


def phase_path(cfg, batch, model, tag="path", expect=None):
    """``register_pair`` at full width: one warm call, then 3 timed calls
    with the counters zeroed just before them.  ``expect`` maps a kernel id
    to its launches per pair (None: at least one)."""
    import torch
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.eval.tester import register_pair

    expect = {"K1": None, "K2": None} if expect is None else expect
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
    launches = dict(kernels.LAUNCHES)
    T = res["transform"].double().cpu()
    rot = T[:, :3]
    ortho = float((rot.T @ rot - torch.eye(3, dtype=torch.float64)).abs().max())
    det = float(torch.linalg.det(rot))
    fitness = float(res["fitness"])
    out = res["outputs"]
    n0 = cfg.budgets.points[0]
    print(f"[{tag}] {n_pairs / wall:.3f} pairs/s ({wall / n_pairs * 1e3:.1f} ms/pair), "
          "launches per pair " + " ".join(f"{k} {launches[k] / n_pairs:g}" for k in expect)
          + f", fitness {fitness:.4f}, transform finite {bool(torch.isfinite(T).all())}, "
          f"|R^T R - I| {ortho:.2e}, det {det:.6f}", flush=True)
    for key, per_pair in expect.items():
        if per_pair is None:
            check(launches[key] > 0, f"[{tag}] {key} never launched: {launches}")
        else:
            check(launches[key] == per_pair * n_pairs,
                  f"[{tag}] {key}: {launches[key]} launches, expected {per_pair} per pair")
    check(bool(torch.isfinite(T).all()) and ortho < 1e-4 and abs(det - 1.0) < 1e-4,
          "transform is not a finite rigid motion")
    check(0.0 <= fitness <= 1.0, f"fitness {fitness}")
    check(tuple(out["feats_f"].shape) == (2, n0, cfg.final_feats_dim), "feats_f shape")
    check(bool(torch.isfinite(out["feats_f"]).all()), "feats_f not finite")
    for key in ("scores_overlap", "scores_saliency"):
        check(tuple(out[key].shape) == (2, n0), f"{key} shape")
        check(bool(((out[key] >= 0) & (out[key] <= 1)).all()), f"{key} outside [0, 1]")
    return launches


def phase_routes(batch, configs):
    """The same seeded weights and the same pyramid through every route of
    ``configs`` (name -> Config, the first the reference) at full width:
    descriptor cosine over the real points > 0.999, scores within 1e-3."""
    import torch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

    names = list(configs)
    with torch.no_grad():
        pyramid = build_pyramid_cfg(configs[names[0]], batch.points[0], batch.masks[0])
        outs = {name: init_kpfcnn(cfg, seed=0, device=batch.points.device)(pyramid,
                                                                          batch.features[0])
                for name, cfg in configs.items()}
    torch.cuda.synchronize()
    mask = batch.masks[0]
    ref = outs[names[0]]
    for name in names[1:]:
        out = outs[name]
        cos = float((out["feats_f"] * ref["feats_f"]).sum(-1)[mask].min())
        diffs = {k: float((out[k] - ref[k]).abs().max())
                 for k in ("scores_overlap", "scores_saliency")}
        print(f"[routes] {name} vs {names[0]}: descriptor cosine min {cos:.7f}, max |d| "
              + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
        check(cos > 0.999, f"[routes] {name}: descriptor cosine {cos}")
        check(all(v <= 1e-3 for v in diffs.values()), f"[routes] {name}: scores {diffs}")


def phase_agree(tag="agree", **overrides):
    """CUDA path vs CPU plain path on a small crop, same weights, same draws
    (``overrides``: Config fields, the KPConv route)."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair
    from pcrcg_tpu_torch.config import Budgets, tiny_test_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.eval.tester import register_pair
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn

    budgets = Budgets(points=(2048, 1024, 512, 256), neighbors=(40,) * 4, corr_k=8,
                      query_chunk=512, search_tile=128, search_m_tiles=4)
    cfg = tiny_test_config(budgets=budgets, **overrides)
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
    print(f"[{tag}] CUDA vs CPU plain path (N0=2048): transform RMSE {rmse:.3e} m, "
          f"descriptor cosine min {float(cos.min()):.7f}, fitness "
          f"{float(rg['fitness']):.4f} vs {float(rc['fitness']):.4f}", flush=True)
    check(rmse <= 0.2, f"CUDA and CPU transforms differ: RMSE {rmse}")
    check(float(cos.min()) > 0.999, "CUDA and CPU descriptors differ")


def phase_train(cfg, batch, state, tag="train", launched=("K1", "K2", "K3", "K4", "K5"),
                idle=()):
    """``train_step`` at full width: one warm step, then 3 timed steps with
    the launch counters zeroed just before them; the kernels ``launched``
    must have run, those in ``idle`` not."""
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
    torch.cuda.reset_peak_memory_stats()
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] {wall / n_steps * 1e3:.1f} ms/step ({n_steps} steps, N0="
          f"{cfg.budgets.points[0]}, batch 1), launches per step "
          + " ".join(f"{k} {v / n_steps:g}" for k, v in launches.items())
          + f", {moved}/{len(named)} parameters moved, {len(kp_weights)} KPConv weights, "
          f"{len(kp_weights) - len(zero_kp)} with a non-zero gradient, peak {peak:.2f} GiB",
          flush=True)
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
    check(all(launches[k] > 0 for k in launched), f"[{tag}] a kernel never launched: {launches}")
    check(all(launches[k] == 0 for k in idle), f"[{tag}] an off-route kernel ran: {launches}")
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


def phase_agree_train(tag="agree-train", **overrides):
    """CUDA path vs CPU plain path of the training slice on a small crop
    (``overrides``: Config fields, the KPConv route),
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
    cfg = tiny_test_config(budgets=budgets, node_overlap=True, quaternion=True, **overrides)
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
    print(f"[{tag}] CUDA vs CPU plain path (N0=2048, both heads): loss terms max "
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

        phase_path(cfg, batch, model, expect={"K1": None, "K2": None, "K6": 0, "K7": 0, "K8": 0})
        phase_agree()

        state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(1)
        calls = record_backward_inputs(cfg, batch, state, gen)
        print(f"[kernels] recorded {len(calls['K3'])} K3 and {len(calls['K5'])} K5 calls in "
              "the backward of one full-width train_step", flush=True)
        if "K4" in calls:  # a tree from before K4 was folded into K3
            results.update(K3=phase_k3_unfused(calls["K3"]), K4=phase_k4_unfused(calls["K4"]))
            k3_ms, k4_ms = results["K3"]["ms"], results["K4"]["ms"]
            print(f"[kernels] K3 + K4 unfused: {k3_ms:.4f} + {k4_ms:.4f} = {k3_ms + k4_ms:.4f} ms",
                  flush=True)
        else:
            results["K3"], results["K4"] = phase_k3_k4(calls["K3"])
        results["K5"] = phase_k5(calls["K5"])
        del calls
        torch.cuda.empty_cache()

        launches = phase_train(cfg, batch, state, idle=("K6", "K7", "K8"))
        phase_agree_train()
        del state
        torch.cuda.empty_cache()

        # The untiled routes: gathered features (K6 / K7, backward K3's
        # gathered entry) and influence + reduce (K8, serving only).
        cfg_u, cfg_r = cfg.replace(kpconv_tiled=False), cfg.replace(kpconv_impl="reduce")
        model_u = init_kpfcnn(cfg_u, seed=0, device="cuda")
        model_r = init_kpfcnn(cfg_r, seed=0, device="cuda")
        calls = record_untiled_inputs(batch, model_u, cfg_u, model_r, cfg_r)
        print(f"[kernels-untiled] recorded {len(calls['K6'])} K6 and {len(calls['K7'])} K7 "
              f"calls in one untiled serving forward, {len(calls['K8'])} K8 calls in one on "
              "the reduce route", flush=True)
        results.update(K6=phase_k6(calls["K6"]), K7=phase_k7(calls["K7"]),
                       K8=phase_k8(calls["K8"]))
        del calls
        torch.cuda.empty_cache()
        phase_path(cfg_u, batch, model_u, "path-untiled",
                   {"K1": None, "K6": 8, "K7": 3, "K2": 0, "K8": 0})
        reduce_launches = phase_path(cfg_r, batch, model_r, "path-reduce",
                                     {"K1": None, "K8": 10, "K2": 0, "K6": 0, "K7": 0})
        del model_u, model_r
        phase_routes(batch, {"tiled": cfg, "untiled": cfg_u, "reduce": cfg_r})
        torch.cuda.empty_cache()

        state_u = TrainState(cfg_u, init_kpfcnn(cfg_u, seed=1, device="cuda"))
        calls = record_gathered_backward_inputs(cfg_u, batch, state_u, gen)
        print(f"[kernels-untiled] recorded {len(calls['K3g'])} calls of K3's gathered entry in "
              "the backward of one full-width untiled train_step", flush=True)
        results["K3g"] = phase_k3g(calls["K3g"])
        del calls
        torch.cuda.empty_cache()
        untiled_launches = phase_train(cfg_u, batch, state_u, "train-untiled",
                                       launched=("K1", "K3", "K6", "K7"),
                                       idle=("K2", "K4", "K5", "K8"))
        del state_u
        torch.cuda.empty_cache()
        phase_agree("agree-untiled", kpconv_tiled=False)
        phase_agree_train("agree-train-untiled", kpconv_tiled=False)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    # Launches on each kernel's route: [train] (K1-K5), [train-untiled] (K6,
    # K7, K3's gathered entry), [path-reduce] (K8).
    launches.update(K3g=untiled_launches["K3"], K6=untiled_launches["K6"],
                    K7=untiled_launches["K7"], K8=reduce_launches["K8"])
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
