#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pcrcg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it completes:

1. build    — compile every CUDA kernel from ``pcrcg_tpu_torch/csrc`` (one
               ``nvcc`` per source, all at once) and print ptxas's report.
2. kernels  — record the inputs each kernel gets on the real paths (the
               assets pair at ``Config()`` budgets, seeded random weights):
               K1 in the 9 searches of a serving pyramid and the loss's 3
               of a ``train_step``, K2 in a serving forward, K3 (with K4's
               scatter folded in) / K5 in the backward of one
               ``train_step``.  K1's idx and lidx must equal its plain
               chain (distances, stable sort, mapping, cutoff) and its
               value mode the plain ``amin``, on every call; the level-0
               conv search also times ``torch.sort(d2, stable=True)``
               alone.  Every other recorded call is held against the
               kernel's plain PyTorch version on the card (relative error
               <= 1e-4).  Each kernel is timed with its plain
               version and, where one exists, the single PyTorch call for
               the same function (``time_ms``: device time, the calls back
               to back behind a sleep that covers their enqueueing), beside
               the least time the card could take (bytes / 3.35 TB/s or
               flops at the card's peak for their type: fp32 67 TFLOP/s;
               the W products of K2, K3, K6 and K7 as three TF32 passes at
               495 TFLOP/s).  K2 also shows its two phases apart, beside
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
               forward under ``Config(kpconv_tiled=False)`` (phase A and
               phase B apart, as K2; nn equal on >= 1 - 1e-4 of the
               queries; for K7 the count of queries whose nn differs
               under the TPU kernel's s_all - s_coord rule), K8 under
               ``Config(kpconv_impl="reduce")`` (within 1e-5 relative of
               its plain version, nn equal, both bit-identical on a second
               run), K3's gathered entry (its
               products and its recompute of ``weighted`` apart) in the
               backward of one untiled ``train_step``.
8. path-untiled, path-reduce — 3 on those routes: K6 8 and K7 3 launches
               per pair and K2 none; K8 10 per pair.
9. routes   — the same weights and pyramid through the tiled, untiled and
               reduce routes at full width: descriptor cosine > 0.999,
               scores within 1e-3 (one function in three summation orders).
10. train-untiled — 5 under ``kpconv_tiled=False``: K6, K7 and K3 launched,
               K2 and K5 not; the gathers' feature gradient is a plain
               ``index_add_`` (the backward of ``index_select``).
11. agree-untiled — 4 and 6 once more under ``kpconv_tiled=False``.
12. exact-div — the color branch's dequantization on the card, over every
               uint8 (÷255) and uint16 (÷1000) value, equal to numpy's
               correctly rounded quotient.
13. kernels-images, path-images — the color model of
               ``configs/train/indoor.yaml`` (``PCRCG``: ResNet-50 UNet, 2
               images a cloud at 240×320, in_feats_dim 129, the [path]
               widths and budgets; seeded random weights) on renders of the
               pair: K2's block-0 call at C = 129 as in 2; the backbone +
               lift's device time and the share of points lifted from an
               image; then 3 with the images (K1 and K2 launched).
14. train-images — K3's block-0 call at C = 129 from the backward of one
               image ``train_step``, as in 2; then 5 with the images, and
               every backbone2d tensor (buffers too) bit-identical after it.
15. agree-images — 4 for the color model (ResNet-50 UNet, 120×160
               renders of the crop): transform RMSE <= 0.2 m, descriptors,
               and the lifted features within ``LIFT_AGREE_BOUND``.
16. main     — ``python -m pcrcg_tpu_torch.main``'s ``main`` on a split in
               the 3DMatch layout (``assets.py::write_indoor_fixture``, one
               scene, 16 train and 2 val pairs, 240×320 color and depth PNGs,
               poses, SuperGlue dumps) under ``configs/train/indoor.yaml``
               changed only in its data paths, exp_dir, ``max_epoch: 1``,
               ``init_mode: random``, ``verbose_freq: 1`` and
               ``num_workers: 2``: the counters zeroed before it, K1-K5
               launched; every logged loss finite; the epoch, best_loss and
               best_recall checkpoints written.  Then a resume from the
               epoch checkpoint (start epoch 1, every tensor equal to the
               saved one), and the host and device ms of a training step
               (an epoch of 16 steps timed, with the loader's waits; then
               one profiled, with the host's launches and stream syncs).
17. tester   — ``IndoorTester`` over a 4-pair test split of the fixture
               against its gt folder: every pair scored, est.log parses,
               recall, inlier ratios and FMR in [0, 1]; pairs/s.
18. accuracy — ``python -m pcrcg_tpu_torch.accuracy --images --steps 20
               --eval-every 10 --n-eval 2``: every step's loss finite, K1-K5
               launched, the JSONL start / eval / final events well formed.

Then it prints the card's ``name, power.limit``, one JSON line with every
kernel's numbers (launches: K1-K5 from [train], K6 / K7 and K3's gathered
entry from [train-untiled], K8 from [path-reduce]; K4 runs inside K3's
tiled entry, so its row gives that entry's time and bound), and as its
last line ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, without CUDA or without the
package beside it, and on any failed check.  On an older tree (timed
beside this one) whose K1 writes the distance matrix, [kernels] K1 times
the chain the fused kernel replaced: that K1, then the stable sort, the
mapping and the cutoff.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
TF32_PASSES = 3  # the W products (K2, K3, K6, K7): error-compensated TF32, three products
# torch.cuda._sleep spins for a number of SM cycles; the H100's top SM clock
# is 1.98 GHz, so n cycles last at least n / 2e9 s.
SLEEP_CYCLES_PER_S = 2.0e9
KERNELS = {
    "K1": dict(
        name="tiled_search", route="cuda",
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


def record_kernel_inputs(cfg, batch, model, images=None):
    """K2 arguments of one serving forward (pyramid + KPFCNN, or PCRCG with
    ``images``)."""
    import torch
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

    def run():
        with torch.no_grad():
            pyramid = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
            if images is None:
                model(pyramid, batch.features[0])
            else:
                model(pyramid, batch.features[0], images)

    return record_calls(run, {"K2": (kt_mod, "kpconv_tiled")})


@contextlib.contextmanager
def recording_k1(outer):
    """Record K1's calls made inside the searches ``outer`` = [(module,
    name)] (``radius_search_tiled_batch`` / ``radius_search_tiled``:
    top-k; ``min_dist_sq_tiled``: value mode) while the block runs.  Yields
    the list of (mode, args) in the fused kernel's terms: "topk" (queries,
    supa, sel, k, r2, nq, ns, batch) or "min_d2" (queries, supa, sel, nq).
    On a tree from before the fused kernel, whose K1 writes the distance
    matrix (``tiled_candidate_distances``), the same arguments are made
    from K1's and the search's own."""
    import pcrcg_tpu_torch.ops.tiled_search as ts
    from pcrcg_tpu_torch.ops.neighbors import radius_sq

    calls, active = [], []
    fused = hasattr(ts, "tiled_search")

    def wrap_outer(real):
        def fn(*a, **kw):
            active.append((real.__name__, a))
            try:
                return real(*a, **kw)
            finally:
                active.pop()
        return fn

    def wrap_inner(real, mode):
        def fn(*a):
            if active:
                if fused:
                    calls.append((mode, a))
                else:  # the distance-only K1: (queries, supa, sel)
                    name, oa = active[-1]
                    q, s = oa[0], oa[1]
                    if name == "min_dist_sq_tiled":
                        calls.append(("min_d2", (*a, q.shape[0])))
                    else:
                        b, nq, ns = (q.shape[0], q.shape[1], s.shape[1]) if q.dim() == 3 \
                            else (1, q.shape[0], s.shape[0])
                        calls.append(("topk", (*a, oa[4], radius_sq(oa[3]), nq, ns, b)))
            return real(*a)
        return fn

    inner = ([(ts, "tiled_search", "topk"), (ts, "tiled_min_dist_sq", "min_d2")] if fused
             else [(ts, "tiled_candidate_distances", None)])
    patched = [(mod, name) for mod, name in outer] + [(ts, name) for _, name, _ in inner]
    real = {(id(mod), name): getattr(mod, name) for mod, name in patched}
    for mod, name in outer:
        setattr(mod, name, wrap_outer(real[id(mod), name]))
    for mod, name, mode in inner:
        setattr(mod, name, wrap_inner(real[id(mod), name], mode))
    try:
        yield calls
    finally:
        for mod, name in patched:
            setattr(mod, name, real[id(mod), name])


def record_backward_inputs(cfg, batch, state, generator, images=None):
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
    kw = {} if images is None else dict(images=images)  # older trees take no images
    return record_calls(lambda: train_step(state, cfg, batch, generator=generator, **kw), targets)


def _chain_after_distances(d2, sel, k, r2, nq, ns, batch, tile, supa_tiles):
    """The stable sort, tile-table mapping and cutoff that followed the
    distance-only K1 (the fused kernel's plain chain after its distances)."""
    import torch
    from pcrcg_tpu_torch.ops.neighbors import _smallest_k

    g_total, m_tiles = sel.shape
    g_count = g_total // batch
    d2k, lidx = _smallest_k(d2, k)
    d2k = d2k.reshape(batch, g_count * 128, k)
    lidx = lidx.reshape(batch, g_count, 128 * k)
    boff = torch.arange(batch, device=sel.device)[:, None, None] * (supa_tiles // batch)
    cloud_sel = sel.long().reshape(batch, g_count, m_tiles) - boff
    tile_of = torch.gather(cloud_sel, 2, lidx // tile)
    gidx = (tile_of * tile + lidx % tile).reshape(batch, g_count * 128, k)
    in_r = d2k <= r2
    idx = torch.where(in_r, gidx, ns)[:, :nq]
    return idx, torch.where(in_r, lidx.reshape(batch, g_count * 128, k), m_tiles * tile).to(
        torch.int32)


def phase_k1(calls):
    """K1 on every recorded call (the 9 searches of a serving pyramid, the
    loss's 3 of a ``train_step``): idx and lidx equal to the plain chain
    (distances, stable sort, mapping, cutoff), the value mode bit for bit
    the plain ``amin``.  Timed: the kernel, the plain chain and, for the
    level-0 conv search, ``torch.sort(d2, stable=True)`` alone (a
    diagnostic).  Bound: queries, supa and sel read once, idx (8 B) and
    lidx (4 B) a slot (4 B a query in the value mode) written; 9 operations
    a (query, candidate).  On a tree whose K1 writes the distance matrix,
    the time is that of the chain the fused kernel replaces: K1, then the
    stable sort, the mapping and the cutoff (or the ``amin``)."""
    import torch
    import pcrcg_tpu_torch.ops.search_kernel as sk

    fused = hasattr(sk, "tiled_search")
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0.0, flops=0.0, dist_ms=0.0)
    for i, (mode, args) in enumerate(calls):
        q, supa, sel = args[:3]
        g_total, m_tiles = sel.shape
        tile = supa.shape[2]
        cand = m_tiles * tile
        nbytes = 4 * (q.numel() + supa.numel() + sel.numel())
        flops = 9.0 * g_total * 128 * cand
        if mode == "min_d2":
            nq = args[3]
            nbytes += 4 * nq
            what = f"value mode, Nq={nq}"
            if fused:
                kernel = lambda: sk.tiled_min_dist_sq(*args)  # noqa: E731
                plain = lambda: sk.tiled_min_dist_sq_plain(*args)  # noqa: E731
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"K1 call {i}: value mode differs from amin")
                check(bool(torch.isfinite(got).all()), f"K1 call {i}: non-finite minimum")
            else:
                kernel = lambda: sk.tiled_candidate_distances(q, supa, sel).amin(-1)[:nq]  # noqa
        else:
            k, r2, nq, ns, batch = args[3:]
            nbytes += 8 * batch * nq * k + 4 * g_total * 128 * k  # idx, lidx
            what = f"k={k}, B={batch}, Nq={nq}"
            if fused:
                kernel = lambda: sk.tiled_search(*args)  # noqa: E731
                plain = lambda: sk.tiled_search_plain(*args)  # noqa: E731
                (gi, gl), (wi, wl) = kernel(), plain()
                torch.cuda.synchronize()
                check(torch.equal(gi, wi), f"K1 call {i}: idx differs from the plain chain")
                check(torch.equal(gl, wl), f"K1 call {i}: lidx differs from the plain chain")
                kept = float((gi < ns).float().mean())
                what += f", share of slots kept {kept:.4f}"
                del gi, gl, wi, wl
            else:
                kernel = lambda: _chain_after_distances(  # noqa: E731
                    sk.tiled_candidate_distances(q, supa, sel), sel, *args[3:], tile,
                    supa.shape[0])
        ms = time_ms(kernel)
        extra = ""
        if fused:
            plain_ms = time_ms(plain, iters=3)
            res["plain_ms"] += plain_ms
            extra = f" plain chain {plain_ms:.4f} ms"
        else:  # the distance kernel alone, as the old tree timed it
            dist_ms = time_ms(lambda: sk.tiled_candidate_distances(q, supa, sel))
            res["dist_ms"] += dist_ms
            extra = f" (its distance kernel alone {dist_ms:.4f} ms)"
        if i == 0:
            d2 = sk.tiled_candidate_distances_plain(q, supa, sel)
            sort_ms = time_ms(lambda: torch.sort(d2, dim=-1, stable=True))
            del d2
            extra += f"; torch.sort(d2 [{g_total * 128}, {cand}], stable=True) {sort_ms:.4f} ms"
        b_ms, b_by = bound(nbytes, flops)
        res["ms"] += ms
        res["nbytes"] += nbytes
        res["flops"] += flops
        label = ("kernel" if fused else "old chain (K1 + amin)" if mode == "min_d2"
                 else "old chain (K1 + sort + mapping + cutoff)")
        print(f"  K1 call {i}: G={g_total} M={m_tiles} {what}: {label} {ms:.4f} ms{extra} "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    if fused:
        print(f"[kernels] K1 over {len(calls)} calls: idx and lidx equal to the plain chain, the "
              f"value mode equal to amin; kernel {res['ms']:.4f} ms, plain chain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})",
              flush=True)
    else:
        res["plain_ms"] = None
        print(f"[kernels] K1 (distance kernel, old tree) over {len(calls)} calls: chain "
              f"{res['ms']:.4f} ms, its distance kernel {res['dist_ms']:.4f} ms", flush=True)
    res["library_ms"] = None  # no single PyTorch call searches the candidate tiles
    return res


def phase_k2(calls, tag="kernels", shapes=((1, 128), (64, 64), (256, 256), (512, 512))):
    """K2 against its plain version on every recorded call, and timed: the
    whole kernel, its phase A (influence + reduce) and phase B (the 3xTF32
    W product) apart, ``torch.matmul`` in fp32 on phase B's operands, the
    plain version; bound with the W product as three TF32 passes (and, for
    comparison, all in fp32 on the CUDA cores).  Every (C, D) of
    ``shapes`` must be among the calls."""
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
    seen = set()
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
        seen.add((c_in, d))
        print(f"  K2 call {i}: Nq={nq} H={h} (C,D)=({c_in},{d}) max|d|={err:.3e} rel={rel:.3e} "
              f"kernel {ms:.4f} ms{split} plain {plain_ms:.4f} ms bound {b3:.4f} ms "
              f"({b3_by}; all fp32: {b32:.4f})", flush=True)
    for need in shapes:
        check(need in seen, f"K2: shape {need} not exercised")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["a_flops"],
                                             TF32_PASSES * res["w_flops"])
    bound_fp32 = bound(res["nbytes"], res["a_flops"] + res["w_flops"])[0]
    split = ""
    if res["b_ms"] > 0:
        w_tflops = TF32_PASSES * res["w_flops"] / (res["b_ms"] * 1e-3) / 1e12
        split = (f" = phase A {res['a_ms']:.4f} + phase B {res['b_ms']:.4f} ms "
                 f"({w_tflops:.1f} TFLOP/s of TF32 product, {res['w_flops'] / 1e9:.1f} GFLOP x "
                 f"{TF32_PASSES}; torch.matmul fp32 {res['matmul_ms']:.4f} ms)")
    print(f"[{tag}] K2 over {len(calls)} calls: {res['ms']:.4f} ms{split}; bound "
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


def phase_k3_k4(calls, tag="kernels"):
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
    print(f"[{tag}] K3 (tiled, K4's scatter folded in) over {len(calls)} calls: "
          f"{k3['ms']:.4f} ms = products {products:.4f} (dW {k3['dw_ms']:.4f} + gW "
          f"{k3['gw_ms']:.4f}; {rate:.1f} TFLOP/s of TF32 product, "
          f"{k3['prod_flops'] / 1e9:.1f} GFLOP x {TF32_PASSES}; torch.matmul fp32 on the same "
          f"operands, allow_tf32=False: {k3['matmul_ms']:.4f}) + rest "
          f"{k3['ms'] - products:.4f}; bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}; "
          f"products as 3xTF32, dnx not written); unfused rule (all fp32, dnx written and read):"
          f" K3 {bound(old['k3_bytes'], old['k3_flops'])[0]:.4f} + K4 "
          f"{bound(old['k4_bytes'], old['k4_flops'])[0]:.4f} ms", flush=True)
    print(f"[{tag}] K4: its scatter runs inside K3's entry ({n_ds} of the {len(calls)} calls),"
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


def tpu_merged_counts(nxc_t):
    """K7's neighbor counts under the TPU kernel's rule
    (pcrcg_tpu/ops/kpconv_fused.py:204-211): the channel rows in blocks of
    8 + C (at most 128), each neighbor's sum over every row of a block,
    minus rows 0-7 (coordinates and pad) in the first block; a neighbor
    counts when that is > 0.  fp32, in torch's summation order."""
    c8 = nxc_t.shape[1]
    blk = c8 if c8 <= 128 else 128
    hsum = None
    for j, c0 in enumerate(range(0, c8, blk)):
        part = nxc_t[:, c0:c0 + blk].sum(1)
        if j == 0:
            part = part - nxc_t[:, :8].sum(1)
        hsum = part if hsum is None else hsum + part
    return (hsum > 0.0).sum(0).clamp_min(1).to(nxc_t.dtype)


def _gathered_conv_phase(key, calls, kernel, plain, shapes):
    """K6 / K7: each recorded call against its plain version (outputs after
    the ÷nn on the queries whose counts agree, which must be >= 1 - 1e-4 of
    them), then timed: the whole kernel, its phase A (influences, reduce,
    counts) and phase B (the 3xTF32 W product, held within 1e-5 of its
    largest entry against float64) apart, ``torch.matmul`` in fp32 on phase
    B's operands (a diagnostic), the plain version; bound with the W product
    as three TF32 passes, the all-fp32 rule beside it.  K7 also counts the
    queries whose count differs under the TPU kernel's s_all - s_coord
    rule.  On a tree without ``kpconv_gathered_reduce`` (one C entry, the
    SGEMM) only the kernel and its plain version are timed."""
    import torch

    try:
        from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_gathered_reduce
        from pcrcg_tpu_torch.ops.tc_gemm import plan_gemm, tc_gemm
    except ImportError:
        kpconv_gathered_reduce = None
    torch.backends.cuda.matmul.allow_tf32 = False  # the diagnostic matmul in full fp32
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, a_flops=0.0, w_flops=0.0, nbytes=0.0,
               a_ms=0.0, b_ms=0.0, matmul_ms=0.0, tpu_rule_diff=0, queries=0)
    seen = set()
    c_skip = 8 if key == "K7" else 0
    for i, (args, kw) in enumerate(calls):
        geom, feats_t, kp, w = args[:4]
        conf = args[4:]
        out, nn = kernel(*args, **kw)
        p_out, p_nn = plain(*args, **kw)
        torch.cuda.synchronize()
        same = nn == p_nn
        check(float(same.float().mean()) >= 1 - 1e-4, f"{key} call {i}: neighbor counts differ")
        err, rel = rel_err((out / nn[:, None])[same], (p_out / p_nn[:, None])[same])
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel <= 1e-4, f"{key} call {i}: max relative error {rel}")
        rule = ""
        if key == "K7":
            diff = int((tpu_merged_counts(feats_t) != nn).sum())
            res["tpu_rule_diff"] += diff
            res["queries"] += nn.numel()
            rule = f" TPU s_all-s_coord counts differing {diff}/{nn.numel()}"
        del out, nn, p_out, p_nn, same
        k_count, c_w, d = w.shape
        h, _, n = feats_t.shape
        n_real = real_slots(feats_t, 1)
        # K7's merged gather carries 8 rows before the C features: only the
        # 3 coordinate rows are read besides them, and W8's 8 zero rows are
        # no work.
        c_in, rows = (c_w - 8, c_w - 5) if key == "K7" else (c_w, c_w)
        a_flops = 2.0 * n_real * k_count * (c_in + 12)
        w_flops = 2.0 * n * k_count * c_in * d
        nbytes = 4 * (geom.numel() + h * rows * n + kp.numel() + k_count * c_in * d
                      + n * (d + 1))
        ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3)
        split = ""
        if kpconv_gathered_reduce is not None:
            w_rows = w[:, c_skip:, :].reshape(k_count * c_in, d).contiguous()
            weighted_t = kpconv_gathered_reduce(geom, feats_t, c_skip, kp, *conf)[0]
            b_out = tc_gemm(weighted_t, w_rows, trans_a=True)
            b64 = fp64_err(b_out, weighted_t.T, w_rows)
            check(b64 <= 1e-5, f"{key} call {i}: phase B vs float64 {b64}")
            del b_out
            a_ms = time_ms(lambda: kpconv_gathered_reduce(geom, feats_t, c_skip, kp, *conf))
            b_ms = time_ms(lambda: tc_gemm(weighted_t, w_rows, trans_a=True))
            mm_ms = time_ms(lambda: torch.matmul(weighted_t.T, w_rows))
            del weighted_t, w_rows
            plan = plan_gemm(n, d, k_count * c_in,
                             torch.cuda.get_device_properties(0).multi_processor_count)
            split = (f" (phase A {a_ms:.4f}, phase B {b_ms:.4f} [split-K {plan.splits}, vs f64 "
                     f"{b64:.1e}], torch.matmul fp32 {mm_ms:.4f})")
            for k, val in (("a_ms", a_ms), ("b_ms", b_ms), ("matmul_ms", mm_ms)):
                res[k] += val
        b3, b3_by = bound(nbytes, a_flops, TF32_PASSES * w_flops)
        b32 = bound(nbytes, a_flops + w_flops)[0]
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("nbytes", nbytes),
                       ("a_flops", a_flops), ("w_flops", w_flops)):
            res[k] += val
        seen.add((c_in, d))
        print(f"  {key} call {i}: N={n} H={h} (C,D)=({c_in},{d}) max|d|={err:.3e} rel={rel:.3e}"
              f"{rule} kernel {ms:.4f} ms{split} plain {plain_ms:.4f} ms bound {b3:.4f} ms "
              f"({b3_by}; all fp32: {b32:.4f})", flush=True)
    for need in shapes:
        check(need in seen, f"{key}: shape {need} not exercised")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["a_flops"],
                                             TF32_PASSES * res["w_flops"])
    bound_fp32 = bound(res["nbytes"], res["a_flops"] + res["w_flops"])[0]
    split = ""
    if res["b_ms"] > 0:
        rate = TF32_PASSES * res["w_flops"] / (res["b_ms"] * 1e-3) / 1e12
        split = (f" = phase A {res['a_ms']:.4f} + phase B {res['b_ms']:.4f} ms ({rate:.1f} "
                 f"TFLOP/s of TF32 product, {res['w_flops'] / 1e9:.1f} GFLOP x {TF32_PASSES}; "
                 f"torch.matmul fp32 on phase B's operands, allow_tf32=False: "
                 f"{res['matmul_ms']:.4f} ms)")
    print(f"[kernels-untiled] {key} over {len(calls)} calls: {res['ms']:.4f} ms{split}; plain "
          f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms ({res['bound_by']}; W as "
          f"3xTF32) [all fp32: {bound_fp32:.4f} ms]", flush=True)
    if key == "K7":
        print(f"[kernels-untiled] K7 counts under the TPU kernel's s_all - s_coord rule on the "
              f"recorded full-width gathers (the encoder's features of the assets pair, seeded "
              f"random weights): "
              f"{res['tpu_rule_diff']} of {res['queries']} queries differ from the port's "
              f"feature-only sum", flush=True)
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
        again_w, again_nn = kpconv_weighted_reduce(*args, **kw)
        p_weighted, p_nn = kpconv_weighted_reduce_plain(*args, **kw)
        torch.cuda.synchronize()
        n_diff = int((nn != p_nn).sum())  # checked after the timings
        res["nn_diff"] = res.get("nn_diff", 0) + n_diff
        check(torch.equal(weighted, again_w) and torch.equal(nn, again_nn),
              f"K8 call {i}: weighted or nn differs between two runs")
        del again_w, again_nn
        err, rel_e = rel_err(weighted, p_weighted)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        check(rel_e <= 1e-5, f"K8 call {i}: max relative error {rel_e}")
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
        print(f"  K8 call {i}: N={n} H={h} C={c_in} max|d|={err:.3e} rel={rel_e:.3e} nn equal, "
              f"bit-identical rerun; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
    for need in (64, 128, 256, 512):
        check(need in seen, f"K8: width {need} not exercised")
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["flops"])
    print(f"[kernels-untiled] K8 over {len(calls)} calls: {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
          f"{res['bound_ms'] / res['ms']:.2f} of it)", flush=True)
    check(res["nn_diff"] == 0, f"K8: {res['nn_diff']} neighbor counts differ")
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

    try:  # K6's phase A as its own launch, the recomputation of weighted
        from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_gathered_reduce
    except ImportError:
        kpconv_gathered_reduce = None
    split = "trans_b" in inspect.signature(tc_gemm).parameters
    torch.backends.cuda.matmul.allow_tf32 = False  # the diagnostic matmuls in full fp32
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, prod_flops=0.0, nbytes=0.0,
               dw_ms=0.0, gw_ms=0.0, matmul_ms=0.0, old_flops=0.0, a_ms=0.0)
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
        if kpconv_gathered_reduce is not None:
            # K6's phase A on the same operands; the entry runs it without
            # the neighbor count.
            a_ms = time_ms(lambda: kpconv_gathered_reduce(rel, nx_t, 0, kp, *args[5:8]))
            res["a_ms"] += a_ms
            products += f" recompute (phase A, with the count) {a_ms:.4f}"
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
                   f"operands, allow_tf32=False: {res['matmul_ms']:.4f})")
        if res["a_ms"] > 0:
            summary += (f" + recompute of weighted (phase A, timed with the count it skips) "
                        f"{res['a_ms']:.4f} + rest {res['ms'] - products - res['a_ms']:.4f}")
        else:
            summary += f" + rest {res['ms'] - products:.4f}"
    print(f"[kernels-untiled] K3 gathered over {len(calls)} calls: {res['ms']:.4f} ms{summary}; "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}; products as 3xTF32); all-fp32 "
          f"rule {bound(res['nbytes'], res['old_flops'])[0]:.4f} ms", flush=True)
    # No single PyTorch call computes dW, gW and the recomputed influences.
    res["library_ms"] = None
    return res


def phase_path(cfg, batch, model, tag="path", expect=None, images=None):
    """``register_pair`` at full width (with ``images``: the color model):
    one warm call, then 3 timed calls with the counters zeroed just before
    them.  ``expect`` maps a kernel id to its launches per pair (None: at
    least one)."""
    import torch
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.eval.tester import register_pair

    expect = {"K1": None, "K2": None} if expect is None else expect
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (model, cfg, batch.points[0], batch.masks[0], batch.features[0], gen)
    kw = {} if images is None else dict(images=images)
    t0 = time.perf_counter()
    register_pair(*args, **kw)
    torch.cuda.synchronize()
    print(f"  warm call {time.perf_counter() - t0:.3f} s", flush=True)

    n_pairs = 3
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n_pairs):
        res = register_pair(*args, **kw)
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


# [agree-images]: the largest |CUDA - CPU| of the lifted features over their
# largest entry may not exceed this (ResNet-50 UNet at 120x160, fp32 on both
# devices): 1.6e-5 measured on an H100 (PERF.md); TF32 convolutions would
# give ~1e-3.
LIFT_AGREE_BOUND = 1e-4


def phase_agree(tag="agree", images_hw=None, **overrides):
    """CUDA path vs CPU plain path on a small crop, same weights, same draws
    (``overrides``: Config fields, the KPConv route).  With ``images_hw``
    (H, W): the color model (``PCRCG``, ResNet-50 UNet) on renders of the
    crop at that size, and its lifted features compared too."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair
    from pcrcg_tpu_torch.config import Budgets, tiny_test_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.eval.tester import register_pair
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn

    budgets = Budgets(points=(2048, 1024, 512, 256), neighbors=(40,) * 4, corr_k=8,
                      query_chunk=512, search_tile=128, search_m_tiles=4)
    if images_hw is not None:
        overrides = dict(overrides, image_feature=True, in_feats_dim=129)
    cfg = tiny_test_config(budgets=budgets, **overrides)
    src, tgt = demo_cloud_pair()

    def crop(p, n):
        d = ((p - np.median(p, 0)) ** 2).sum(1)
        return p[np.argsort(d, kind="stable")[:n]]

    sample = dict(src_pcd=crop(src, 2048), tgt_pcd=crop(tgt, 2000), rot=np.eye(3),
                  trans=np.zeros(3))
    images, init, kw, lifted = None, init_kpfcnn, {}, {}
    if images_hw is not None:
        from pcrcg_tpu_torch.assets import render_pair_images
        from pcrcg_tpu_torch.models.lift import IMAGE_KEYS, images_to
        from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
        from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

        images = render_pair_images(sample["src_pcd"], sample["tgt_pcd"], cfg.img_num, seed=1,
                                    height=images_hw[0], width=images_hw[1])
        init = init_pcrcg
    n_points, iters, chunk = 512, 8192, 1024
    gen = torch.Generator().manual_seed(1)
    uniforms = (torch.rand(2048, generator=gen), torch.rand(2048, generator=gen))
    picks = torch.randint(0, n_points, (iters // chunk, chunk, 3), generator=gen)
    results = {}
    for dev in ("cpu", "cuda"):
        batch = make_pair_batch([sample], 2048, in_feats_dim=cfg.in_feats_dim, device=dev)
        model = init(cfg, seed=2, device=dev)
        if images is not None:
            kw = dict(images=images_to(images, dev))
            with torch.no_grad():
                pyr = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
                lifted[dev] = model.lift(pyr.points[0], pyr.masks[0],
                                         *(kw["images"][k] for k in IMAGE_KEYS)).cpu()
        res = register_pair(
            model, cfg, batch.points[0], batch.masks[0], batch.features[0], device=dev,
            n_points=n_points, num_iterations=iters, hypothesis_chunk=chunk,
            uniforms=tuple(u.to(dev) for u in uniforms), picks=picks.to(dev), **kw,
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
    desc = float((fc - fg).abs().max())
    extra = ""
    if lifted:
        lift_err = rel_err(lifted["cuda"], lifted["cpu"])[1]
        share = float((lifted["cpu"][..., :-1] != 1).any(-1)[mask].float().mean())
        extra = (f", lifted features max relative error {lift_err:.3e} (bound "
                 f"{LIFT_AGREE_BOUND:.0e}; images {images_hw[0]}x{images_hw[1]}, ResNet-"
                 f"{cfg.backbone2d_depth} UNet, {share:.3f} of the real points lifted)")
    print(f"[{tag}] CUDA vs CPU plain path (N0=2048): transform RMSE {rmse:.3e} m, "
          f"descriptor cosine min {float(cos.min()):.7f} (max |d| {desc:.3e}), fitness "
          f"{float(rg['fitness']):.4f} vs {float(rc['fitness']):.4f}{extra}", flush=True)
    check(rmse <= 0.2, f"CUDA and CPU transforms differ: RMSE {rmse}")
    check(float(cos.min()) > 0.999, "CUDA and CPU descriptors differ")
    if lifted:
        check(lift_err <= LIFT_AGREE_BOUND, f"CUDA and CPU lifted features differ: {lift_err}")


def phase_train(cfg, batch, state, tag="train", launched=("K1", "K2", "K3", "K4", "K5"),
                idle=(), images=None, frozen=None):
    """``train_step`` at full width (with ``images``, batched, the color
    model): one warm step, then 3 timed steps with the launch counters
    zeroed just before them; the kernels ``launched`` must have run, those
    in ``idle`` not.  Every tensor of the state dict under the prefix
    ``frozen`` (parameters and buffers) must be bit-identical after the
    four steps."""
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
    kw = {} if images is None else dict(images=images)
    kept = {} if frozen is None else {k: v.clone() for k, v in state.model.state_dict().items()
                                      if k.startswith(frozen)}
    t0 = time.perf_counter()
    train_step(state, cfg, batch, generator=gen, **kw)
    torch.cuda.synchronize()
    print(f"  warm step {time.perf_counter() - t0:.3f} s", flush=True)

    named = {n: p for n, p in state.model.named_parameters() if p.requires_grad}
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
            stats = train_step(state, cfg, batch, generator=gen, **kw)
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
    if frozen is not None:
        after = state.model.state_dict()
        changed = [k for k, v in kept.items() if not torch.equal(after[k], v)]
        print(f"  {len(kept)} tensors under {frozen} (parameters and buffers): "
              f"{len(kept) - len(changed)} bit-identical after the {n_steps + 1} steps", flush=True)
        check(len(kept) > 0 and not changed, f"frozen tensors changed: {changed[:5]}")
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


def phase_exact_div():
    """``models/lift.py::_exact_div`` on the card over every uint8 (÷255) and
    uint16 (÷1000) value: equal to numpy's correctly rounded float32
    quotient.  The float32 division by the Python scalar (a multiply by the
    reciprocal on the card) is counted beside it."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch.models.lift import _exact_div

    for dtype, denom in ((np.uint8, 255.0), (np.uint16, 1000.0)):
        x = np.arange(np.iinfo(dtype).max + 1, dtype=dtype)
        want = x.astype(np.float32) / np.float32(denom)
        xt = torch.from_numpy(x).cuda()
        bad = int((_exact_div(xt, denom).cpu().numpy() != want).sum())
        naive = int(((xt.to(torch.float32) / denom).cpu().numpy() != want).sum())
        print(f"[exact-div] {np.dtype(dtype).name} / {denom:g} on the card: {bad} of {len(x)} "
              f"values differ from numpy's quotient (float32 division by the scalar: {naive})",
              flush=True)
        check(bad == 0, f"_exact_div differs from numpy on {bad} {np.dtype(dtype).name} values")


def phase_lift_stage(cfg, batch, model, images):
    """The color model's backbone + lift on the [path-images] inputs: its
    device time (``time_ms``) and the share of the real points that take
    their features from an image."""
    import torch
    from pcrcg_tpu_torch.models.lift import IMAGE_KEYS
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

    pyr = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
    args = (pyr.points[0], pyr.masks[0], *(images[k] for k in IMAGE_KEYS))
    feats = model.lift(*args)
    ms = time_ms(lambda: model.lift(*args), iters=5, warmup=1)
    mask = pyr.masks[0]
    share = float((feats[..., :-1] != 1).any(-1)[mask].float().mean())
    n_img, h, w = images["colors"].shape[1:4]
    print(f"[path-images] backbone + lift {ms:.3f} ms device time a pair (ResNet-"
          f"{cfg.backbone2d_depth} UNet over 2 x {n_img} images {h}x{w}), {share:.4f} of the "
          f"real points lifted from an image", flush=True)
    check(tuple(feats.shape) == (2, mask.shape[1], cfg.in_feats_dim), "lifted features shape")
    check(bool(torch.isfinite(feats).all()), "lifted features not finite")
    check(share > 0.1, f"only {share} of the points lifted from an image")


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


# [main]'s train split: an epoch long enough that the loader's start
# (its first batch built with nothing to overlap) does not rule the step
# time.
MAIN_TRAIN_PAIRS = 16


def _fixture_config(repo, work):
    """The fixture's splits and a YAML that differs from
    configs/train/indoor.yaml only in data paths, exp_dir, max_epoch,
    init_mode, verbose_freq and num_workers."""
    import yaml
    from pcrcg_tpu_torch.assets import write_indoor_fixture

    with open(repo / "configs" / "train" / "indoor.yaml") as f:
        raw = yaml.safe_load(f)
    benchmark = raw["model"]["benchmark"]
    t0 = time.perf_counter()
    tr = write_indoor_fixture(work, MAIN_TRAIN_PAIRS, seed=1, images=True, split="train")
    va = write_indoor_fixture(work, 2, seed=2, images=True, split="val")
    te = write_indoor_fixture(work, 4, seed=3, images=True, split="test", info_name=benchmark)
    n = MAIN_TRAIN_PAIRS + 6
    print(f"  fixture: {n} pairs, {2 * n} fragments, {4 * n} images in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    raw["misc"].update(exp_dir=str(work / "exp"), verbose_freq=1)
    raw["model"].update(root=tr["root"], img_path=tr["img_path"],
                        superglue_matches_path=tr["matches"], init_mode="random")
    raw["optimiser"]["max_epoch"] = 1
    raw["dataset"].update(train_info=tr["info"], val_info=va["info"], num_workers=2)
    path = work / "indoor.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, te


class _TimedLoader:
    """A loader whose iteration records how long each batch kept the caller
    waiting."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield item


def phase_main(path):
    """[main]: ``main.main`` trains one epoch of the fixture under the
    color model's config; then a resume and the step times over an epoch
    (the loader's start spread over MAIN_TRAIN_PAIRS steps), the loader's
    waits, and the host's launches and syncs from a profile of the next
    epoch.  Returns the resumed Trainer."""
    import math
    import torch
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch import main as tmain
    from pcrcg_tpu_torch.config import load_config
    from pcrcg_tpu_torch.profile import _device_profile
    from pcrcg_tpu_torch.train.trainer import Trainer

    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = tmain.main(["--config", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    exp = Path(trainer.cfg.exp_dir)
    with open(exp / "scalars.jsonl") as f:
        logged = [json.loads(line) for line in f]
    losses = [r[k] for r in logged for k in ("total", "circle_loss", "overlap_loss") if k in r]
    files = sorted(p.name for p in (exp / "checkpoints").iterdir())
    print(f"[main] 1 epoch ({MAIN_TRAIN_PAIRS} train, 2 val pairs) in {wall:.1f} s including "
          "start-up, launches "
          + " ".join(f"{k} {v}" for k, v in launches.items())
          + f", {len(losses)} logged losses, checkpoints {files}", flush=True)
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5")),
          f"[main] a kernel of the training path never launched: {launches}")
    check(losses and all(math.isfinite(v) for v in losses), "[main] a logged loss is not finite")
    check({"epoch_0.ckpt", "best_loss.ckpt", "best_recall.ckpt"} <= set(files),
          f"[main] checkpoints missing: {files}")
    check(trainer.state.step == MAIN_TRAIN_PAIRS,
          f"[main] {trainer.state.step} steps, expected {MAIN_TRAIN_PAIRS}")

    saved = torch.load(exp / "checkpoints" / "epoch_0.ckpt", map_location=trainer.device,
                       weights_only=True)["state"]["model"]
    cfg = load_config(str(path)).replace(pretrain=str(exp / "checkpoints" / "epoch_0.ckpt"),
                                         exp_dir=str(exp.parent / "resumed"), max_epoch=3)
    resumed = Trainer(cfg, tmain.build_datasets(cfg))
    own = resumed.model.state_dict()
    same = sum(torch.equal(own[k], v) for k, v in saved.items())
    print(f"[main] resumed at epoch {resumed.start_epoch}, step {resumed.state.step}: "
          f"{same}/{len(saved)} tensors equal to the checkpoint", flush=True)
    check(resumed.start_epoch == 1 and resumed.state.step == MAIN_TRAIN_PAIRS,
          "[main] resume position")
    check(same == len(saved) == len(own), "[main] resumed tensors differ from the checkpoint")

    steps = MAIN_TRAIN_PAIRS
    timed = resumed.loaders["train"] = _TimedLoader(resumed.loaders["train"])
    t0 = time.perf_counter()
    resumed.run_epoch(1, "train")
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    wait_ms = sum(timed.waits) / steps * 1e3
    prof = _device_profile(lambda: resumed.run_epoch(2, "train"), 1)  # one epoch
    per = {k: prof[k] / steps for k in ("device_busy_ms", "launches", "launch_host_ms", "syncs",
                                        "sync_wait_ms")}
    print(f"[main] train step: host {host_ms:.1f} ms (waiting on the loader {wait_ms:.1f}, "
          f"its first batch {timed.waits[0] * 1e3:.1f}), device busy "
          f"{per['device_busy_ms']:.1f} ms (share {prof['device_busy_share']:.3f}); "
          f"per step {per['launches']:.0f} kernel launches ({per['launch_host_ms']:.1f} ms "
          f"of host time) and {per['syncs']:.1f} stream syncs ({per['sync_wait_ms']:.2f} ms "
          f"waiting); an epoch of {steps} steps timed, then one profiled", flush=True)
    return resumed


def phase_tester(cfg, model, te):
    """[tester]: every pair of the fixture's test split through
    ``IndoorTester``, scored against the split's gt."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.data.indoor import IndoorDataset
    from pcrcg_tpu_torch.data.loader import PairLoader
    from pcrcg_tpu_torch.eval.benchmark_3dmatch import read_trajectory
    from pcrcg_tpu_torch.eval.tester import IndoorTester
    from pcrcg_tpu_torch.profile import _device_profile

    ds = IndoorDataset(te["info"], cfg, data_augmentation=False)
    loader = PairLoader(ds, cfg.budgets.points[0], batch_size=1, num_threads=2,
                        drop_last=False, pin_memory=True)
    tester = IndoorTester(cfg, model, te["gt"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = tester.run(ds, loader, n_points=cfg.n_points)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    est = Path(res["est_folder"])
    logs = sorted(est.glob("*/est.log"))
    keys, traj = read_trajectory(str(logs[0])) if len(logs) == 1 else (None, None)
    scores = {k: res[k] for k in ("inlier_ratio_wo_mutual", "inlier_ratio_w_mutual", "fmr_005",
                                  "fmr_01", "fmr_02")}
    scores["recall"] = res["benchmark"].weighted_recall
    print(f"[tester] {res['n_pairs']} pairs in {wall:.2f} s ({res['n_pairs'] / wall:.3f} pairs/s, "
          "the loader's reads included), launches " + " ".join(
              f"{k} {v}" for k, v in launches.items()) + ", "
          + ", ".join(f"{k} {v:.4f}" for k, v in scores.items()), flush=True)
    prof = _device_profile(lambda: tester.run(ds, loader, n_points=cfg.n_points), 1)
    print(f"[tester] profiled again: device busy {prof['device_busy_ms'] / 4:.1f} ms a pair "
          f"(share {prof['device_busy_share']:.3f}), {prof['launches'] / 4:.0f} kernel launches "
          f"and {prof['syncs'] / 4:.1f} stream syncs a pair ({prof['sync_wait_ms'] / 4:.2f} ms "
          "waiting)", flush=True)
    check(res["n_pairs"] == 4 and keys is not None and len(keys) == 4, "[tester] pairs missing")
    check(bool(np.isfinite(traj).all()), "[tester] est.log holds a non-finite transform")
    check(all(0.0 <= v <= 1.0 for v in scores.values()), "[tester] a score outside [0, 1]")
    check(launches["K1"] > 0 and launches["K2"] > 0, f"[tester] K1 / K2 idle: {launches}")


def phase_accuracy(work):
    """[accuracy]: the accuracy-evidence loop, color model, 20 steps."""
    import math
    from pcrcg_tpu_torch import accuracy, kernels

    totals = []
    real = accuracy.train_step

    def recording(*args, **kw):
        stats = real(*args, **kw)
        totals.append(stats["total"])
        return stats

    out = work / "accuracy.jsonl"
    accuracy.train_step = recording
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        accuracy.main(["--images", "--steps", "20", "--eval-every", "10", "--n-eval", "2",
                       "--out", str(out)])
    finally:
        accuracy.train_step = real
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    totals = [float(t) for t in totals]
    with open(out) as f:
        events = [json.loads(line) for line in f]
    kinds = [(e["event"], e.get("step")) for e in events]
    print(f"[accuracy] --images, 20 steps and 3 evals of 2 pairs in {wall:.1f} s, launches "
          + " ".join(f"{k} {v}" for k, v in launches.items())
          + f", step losses {totals[0]:.4f} .. {totals[-1]:.4f}, events {kinds}", flush=True)
    check(len(totals) == 20 and all(math.isfinite(t) for t in totals), "[accuracy] losses")
    check(kinds == [("start", None), ("eval", 0), ("eval", 10), ("eval", 20), ("final", 20)],
          f"[accuracy] events {kinds}")
    check(all(len(e["rmse"]) == 2 and all(math.isfinite(r) for r in e["rmse"])
              and 0.0 <= e["recall"] <= 1.0 for e in events[1:]), "[accuracy] eval records")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5")),
          f"[accuracy] a kernel never launched: {launches}")


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

    import pcrcg_tpu_torch.losses as losses_mod
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose, render_pair_images
    from pcrcg_tpu_torch.config import Config, load_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.models.lift import images_to
    from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
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
        with recording_k1([(pyramid_mod, "radius_search_tiled_batch")]) as k1_calls:
            calls = record_kernel_inputs(cfg, batch, model)
        print(f"[kernels] recorded {len(k1_calls)} K1 and {len(calls['K2'])} K2 calls "
              "on the full-width path", flush=True)
        results = {"K2": phase_k2(calls["K2"])}
        del calls
        torch.cuda.empty_cache()

        phase_path(cfg, batch, model, expect={"K1": None, "K2": None, "K6": 0, "K7": 0, "K8": 0})
        phase_agree()

        state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(1)
        with recording_k1([(losses_mod, "min_dist_sq_tiled"),
                           (losses_mod, "radius_search_tiled")]) as k1_loss:
            calls = record_backward_inputs(cfg, batch, state, gen)
        print(f"[kernels] recorded {len(calls['K3'])} K3 and {len(calls['K5'])} K5 calls in "
              f"the backward of one full-width train_step, and the loss's {len(k1_loss)} K1 "
              "calls", flush=True)
        check(len(k1_calls) == 9 and len(k1_loss) == 3,
              f"K1: {len(k1_calls)} serving and {len(k1_loss)} loss calls, expected 9 and 3")
        results["K1"] = phase_k1(k1_calls + k1_loss)
        del k1_calls, k1_loss
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

        # The color model of configs/train/indoor.yaml (PCRCG: ResNet-50
        # UNet, 2 images a cloud, in_feats_dim 129, the [path] widths and
        # budgets) on 240x320 renders of the pair.
        phase_exact_div()
        cfg_i = load_config(str(repo / "configs" / "train" / "indoor.yaml"))
        check(cfg_i.image_feature and cfg_i.in_feats_dim == 129 and cfg_i.backbone2d_depth == 50
              and cfg_i.budgets.points == cfg.budgets.points
              and cfg_i.budgets.neighbors == cfg.budgets.neighbors
              and cfg_i.first_feats_dim == cfg.first_feats_dim,
              "configs/train/indoor.yaml is not the color model at the [path] width")
        batch_i = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)],
                                  cfg_i.budgets.points[0], in_feats_dim=cfg_i.in_feats_dim,
                                  device="cuda")
        images = images_to(render_pair_images(src, tgt, cfg_i.img_num, pose=(rot, trans)), "cuda")
        model_i = init_pcrcg(cfg_i, seed=0, device="cuda")
        calls = [c for c in record_kernel_inputs(cfg_i, batch_i, model_i, images)["K2"]
                 if c[0][6].shape[1] == cfg_i.in_feats_dim]
        print(f"[kernels-images] recorded {len(calls)} K2 call at C = {cfg_i.in_feats_dim} "
              "(block 0) in one serving forward of the color model", flush=True)
        check(len(calls) == 1, "K2: no single block-0 call at C = 129")
        phase_k2(calls, tag="kernels-images", shapes=((cfg_i.in_feats_dim, 128),))
        phase_lift_stage(cfg_i, batch_i, model_i, images)
        phase_path(cfg_i, batch_i, model_i, "path-images",
                   {"K1": None, "K2": None, "K6": 0, "K7": 0, "K8": 0}, images=images)
        del model_i, calls
        torch.cuda.empty_cache()
        state_i = TrainState(cfg_i, init_pcrcg(cfg_i, seed=1, device="cuda"))
        batched = {k: v[None] for k, v in images.items()}
        calls = [c for c in record_backward_inputs(cfg_i, batch_i, state_i, gen, batched)["K3"]
                 if c[0][5].shape[1] == cfg_i.in_feats_dim]
        print(f"[kernels-images] recorded {len(calls)} K3 call at C = {cfg_i.in_feats_dim} "
              "(block 0) in the backward of one image train_step", flush=True)
        check(len(calls) == 1, "K3: no single block-0 call at C = 129")
        phase_k3_k4(calls, tag="kernels-images")
        del calls
        phase_train(cfg_i, batch_i, state_i, "train-images", idle=("K6", "K7", "K8"),
                    images=batched, frozen="lift.backbone2d.")
        del state_i, images, batched
        torch.cuda.empty_cache()
        phase_agree("agree-images", images_hw=(120, 160))

        # Training and evaluation as users run them, on a split in the
        # 3DMatch layout; then the accuracy-evidence loop.
        work = repo / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            path, te = _fixture_config(repo, work)
            trainer = phase_main(path)
            phase_tester(trainer.cfg, trainer.model, te)
            del trainer
            torch.cuda.empty_cache()
            phase_accuracy(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
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
