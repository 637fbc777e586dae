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
19. kitti    — configs/train/kitti.yaml (its data paths, exp_dir,
               ``max_epoch: 1`` and ``num_workers: 2`` changed; every width
               and budget as shipped) on a drive that
               ``assets.py::write_kitti_fixture`` writes: 17 HDL-64E-like
               scans of 120,000 rays, pairs 9.9 m apart, the ICP-refined GT
               cached before anything is timed.  The pyramid of a test pair
               drops no voxel; K1's and K2's calls in one ``register_pair``
               and K3's / K5's (and the loss's K1) in one ``train_step`` on
               an augmented pair are held against their plain versions as in
               2; 5 on that pair (K5 3 a step, no voxel dropped); the device
               ms of a pair and a step; ``main`` trains one epoch (4 steps,
               then 4 val pairs: every step's loss terms finite, no voxel
               dropped, K1-K5 launched, K5 3 a step, the batches' raw clouds
               apart from the model input); ``KITTITester`` over the 4 test
               pairs (every pair scored, RRE and RTE finite, recall in [0, 1],
               pairs/s and device ms a pair).
20. agree-train-kitti — 6 with configs/train/kitti.yaml's radii and heads
               on a 2,048-point crop of an augmented train pair, the loss on
               its raw clouds: the first pair whose crop is well conditioned
               (one rounding unit in K2's outputs or in the weights moves the
               CPU path's gradients and updates by at most a tenth of their
               bounds; each pair's share printed).
21. modelnet — configs/train/modelnet.yaml changed as in 19 (3 levels,
               1,024 points, crops of 0.7) on ``assets.py::modelnet_shapes``
               read through a subclass of ``ModelNetHdf`` (the card's
               machine has no h5py): 2 and 5 as in 19 at the 3-level
               topology (9 KPConvs, K5 for the 2 strided blocks; K1 idle:
               1,024 points make 8 search tiles, no more than
               search_m_tiles, so every search takes the tiled search's
               dense fallback, as in the JAX package), the device
               ms of a pair and a step, a ``main`` epoch (13 steps, 13 val
               pairs), ``ModelnetTester`` over the 11 test pairs (every metric
               finite, the chamfer on the batches' ``extras['points_raw']``).
22. agree-modelnet — 4 at the 3-level topology (N0 = 1,024) on a ModelNet
               test pair.
23. kernels-deformable, path-deformable, train-deformable, agree-deformable,
               agree-train-deformable — ``Config(deformable=True,
               modulated=True)`` on the assets pair: K1 on the 9 serving
               searches at the widened radii against its plain chain, K6 on
               the 10 offset sub-convs ((C, D) = (64..512, 60)) and K3's
               gathered entry on their backward against their plain versions
               and timed; 3 and 5 (K2 1, K6 10 a pair; K3 11, K5 3, K4 none
               a step); 4 at the tiny widths; 6 with the shipped heads (off)
               on the first crop whose CPU path is well conditioned;
               kernels-deformable-kitti — the configuration of the
               benchmark's ``pcrcg_kitti_deform.train`` cell
               (``perfbench/configs/pcrcg_kitti_deform.json``: kitti.yaml's
               widths, the last five encoder blocks deformable, unmodulated,
               neighbor caps 40 / 40 / 98 / 84) on a pair of its
               ``kitti_drive_gt`` traffic with its seeded weights: K1 on
               one train_step's searches (k = 98 at level 2), K6 on the 5
               offset sub-convs ((C, D) = (256, 45), (512, 45) at H = 98 /
               84) and K3's gathered entry on their backward, against their
               plain versions and timed.
24. path-dense, kernels-dense, train-dense, routes-dense, agree-dense —
               ``search_impl: dense``: 3 and 5
               (K6 8, K7 3, no K1 or K2; K3 11, no K5), then the tiled and
               dense routes' pyramids compared: the tiled conv lists' recall
               of the exact ones by level (>= 0.95; 1.0 where the tiled
               search falls back to the dense one), the share of the tiled
               conv lists' entries that the dense lists hold where they
               have room (>= 0.999), the pool and upsample recall and the
               two routes' descriptors printed; kernels-dense — K6 and K7
               on the calls of a serving forward and K3's gathered entry on
               those of a train_step, against their plain versions and
               timed; agree-dense — 4 on the dense route.
25. dp       — ``train_step_dp`` on two ranks of ``torch.distributed`` that
               share the card (gloo by name: NCCL takes a card a rank),
               ``Config()``, a pair a rank, 3 steps: step 1 against the
               single-process ``train_step`` on the same 2-pair batch, weights
               and draws (loss terms rtol 1e-4, parameters rtol 5e-4 / atol
               5e-5), the ranks' parameters bit-identical, K1-K5 launched in
               each rank, ms a dp step; then ``main.py`` for an epoch of a
               fixture split in a one-rank NCCL group (checkpoints, losses).
26. kernels-cloud — K1-K5 as a rank of the cloud ('model') axis launches
               them, one cloud a launch: K1 in the 9 searches of the
               source cloud's pyramid (idx and lidx equal to the plain
               chain), K2 in its encoder, K3 with K4's scatter and K5 in
               that encoder's backward, each against its plain version and
               timed with its bound, as in 2.
27. cloud    — ``train_step_dp`` on ``make_mesh(1, 2)``: two gloo ranks
               sharing the card, a cloud of the assets pair each,
               ``Config()``, 3 steps: step 1 against the single-process
               ``train_step`` (loss terms rtol 1e-4; the encoder's, GCN's,
               decoder's and heads' parameters each rtol 5e-4 / atol 5e-5),
               the ranks bit-identical, K1-K5 launched in each rank; ms a
               step beside the single-process step's, exchanges a step,
               peak GiB a rank.
28. cloud-dp — 27 on the 2 x 2 mesh: four ranks, [dp]'s two pairs, a pair
               a data row, 2 steps.
29. cloud-images — 27 for the color model of ``configs/train/indoor.yaml``
               (each rank lifts its own cloud's 240×320 renders), 1 step;
               the frozen backbone unchanged.

Then it prints the wall time, the card's ``name, power.limit``, one JSON
line with every kernel's numbers (launches: K1-K5 from [train], K6 / K7 and K3's gathered
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
        with eager_pyramid():  # a replay runs no search of its own
            yield calls
    finally:
        for mod, name in patched:
            setattr(mod, name, real[id(mod), name])


@contextlib.contextmanager
def eager_pyramid():
    """``build_pyramid_cfg`` builds eagerly on the card while the block
    runs, as it did before the pyramid became a CUDA graph (a tree without
    ``graphed_pyramid`` is always eager)."""
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod

    real = getattr(pyramid_mod, "graphed_pyramid", None)
    if real is None:
        yield
        return
    pyramid_mod.graphed_pyramid = pyramid_mod.build_pyramid
    try:
        yield
    finally:
        pyramid_mod.graphed_pyramid = real


def phase_pyramid_graph(tag, cfg, batches, calls=10):
    """[pyramid-graph]: ``build_pyramid_cfg`` on the card, one CUDA graph a
    key, against the eager build, bit for bit, on each batch's pair (from
    no graph: the first call with a key captures, the others replay), with and without
    the overflow; a returned pyramid unchanged after the next replay; then
    the capturing calls' seconds and host ms a call, eager and replayed,
    each run of ``calls`` ended by a sync."""
    import torch
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
    from pcrcg_tpu_torch.utils import profiling

    def leaves(pyr, overflow):
        return pyramid_mod._leaves(pyr) + [overflow]

    pyramid_mod.clear_graphs()
    before = dict(profiling.counters()["pyramid_graph"])
    kept, seconds = [], []
    for with_overflow in (True, False):
        for points, masks in batches:
            with eager_pyramid():
                want = leaves(*build_pyramid_cfg(cfg, points, masks, with_overflow=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = build_pyramid_cfg(cfg, points, masks, with_overflow=with_overflow)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            got = leaves(*got) if with_overflow else leaves(got, want[-1])
            check(len(got) == len(want) and all(
                g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
                for g, w in zip(got, want)), f"[pyramid-graph] {tag}: replay differs from eager")
            kept.append((got, [w.clone() for w in want]))
    torch.cuda.synchronize()
    check(all(all(torch.equal(g, w) for g, w in zip(got, want)) for got, want in kept),
          f"[pyramid-graph] {tag}: a later replay changed an earlier pyramid")
    now = profiling.counters()["pyramid_graph"]
    calls_seen = {k: now[k] - before[k] for k in now}
    n = 2 * len(batches)
    check(calls_seen == {"captures": 2, "replays": n - 2, "eager": 0},
          f"[pyramid-graph] {tag}: calls {calls_seen}")

    points, masks = batches[0]

    def host_ms(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    with eager_pyramid():
        eager_ms = host_ms(lambda: build_pyramid_cfg(cfg, points, masks))
    graph_ms = host_ms(lambda: build_pyramid_cfg(cfg, points, masks))
    print(f"[pyramid-graph] {tag}: {n} calls bit for bit the eager build ({calls_seen}); "
          f"the capturing calls {seconds[0]:.3f} / {seconds[len(batches)]:.3f} s; host ms a "
          f"call, synced: eager {eager_ms:.2f}, replayed {graph_ms:.2f}", flush=True)


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


def phase_k1(calls, tag="kernels"):
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
        print(f"[{tag}] K1 over {len(calls)} calls: idx and lidx equal to the plain chain, the "
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


def phase_k5(calls, tag="kernels"):
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
    print(f"[{tag}] K5 {res['ms']:.4f} ms over {len(calls)} calls: {verdict} its yardstick "
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


def _gathered_conv_phase(key, calls, kernel, plain, shapes, tag="kernels-untiled"):
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
    print(f"[{tag}] {key} over {len(calls)} calls: {res['ms']:.4f} ms{split}; plain "
          f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms ({res['bound_by']}; W as "
          f"3xTF32) [all fp32: {bound_fp32:.4f} ms]", flush=True)
    if key == "K7":
        print(f"[{tag}] K7 counts under the TPU kernel's s_all - s_coord rule on the "
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


def phase_k3g(calls, tag="kernels-untiled"):
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
    print(f"[{tag}] K3 gathered over {len(calls)} calls: {res['ms']:.4f} ms{summary}; "
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


def phase_agree(tag="agree", images_hw=None, budgets=None, sample=None, **overrides):
    """CUDA path vs CPU plain path on a small crop, same weights, same draws
    (``overrides``: Config fields, the KPConv route).  With ``images_hw``
    (H, W): the color model (``PCRCG``, ResNet-50 UNet) on renders of the
    crop at that size, and its lifted features compared too.  ``budgets``
    and ``sample`` (a pair's sample dict) replace the 4-level budgets at
    N0 = 2048 and the crop of the assets pair."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair
    from pcrcg_tpu_torch.config import tiny_test_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.eval.tester import register_pair
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn

    if budgets is None:
        budgets = _agree_budgets()
    n0 = budgets.points[0]
    if images_hw is not None:
        overrides = dict(overrides, image_feature=True, in_feats_dim=129)
    cfg = tiny_test_config(budgets=budgets, **overrides)
    if sample is None:
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
    uniforms = (torch.rand(n0, generator=gen), torch.rand(n0, generator=gen))
    picks = torch.randint(0, n_points, (iters // chunk, chunk, 3), generator=gen)
    results = {}
    for dev in ("cpu", "cuda"):
        batch = make_pair_batch([sample], n0, in_feats_dim=cfg.in_feats_dim, device=dev)
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
    mask = make_pair_batch([sample], n0).masks[0]
    cos = (fc * fg).sum(-1)[mask]
    desc = float((fc - fg).abs().max())
    extra = ""
    if lifted:
        lift_err = rel_err(lifted["cuda"], lifted["cpu"])[1]
        share = float((lifted["cpu"][..., :-1] != 1).any(-1)[mask].float().mean())
        extra = (f", lifted features max relative error {lift_err:.3e} (bound "
                 f"{LIFT_AGREE_BOUND:.0e}; images {images_hw[0]}x{images_hw[1]}, ResNet-"
                 f"{cfg.backbone2d_depth} UNet, {share:.3f} of the real points lifted)")
    print(f"[{tag}] CUDA vs CPU plain path (N0={n0}, {budgets.num_levels} levels): transform "
          f"RMSE {rmse:.3e} m, "
          f"descriptor cosine min {float(cos.min()):.7f} (max |d| {desc:.3e}), fitness "
          f"{float(rg['fitness']):.4f} vs {float(rc['fitness']):.4f}{extra}", flush=True)
    check(rmse <= 0.2, f"CUDA and CPU transforms differ: RMSE {rmse}")
    check(float(cos.min()) > 0.999, "CUDA and CPU descriptors differ")
    if lifted:
        check(lift_err <= LIFT_AGREE_BOUND, f"CUDA and CPU lifted features differ: {lift_err}")


def phase_train(cfg, batch, state, tag="train", launched=("K1", "K2", "K3", "K4", "K5"),
                idle=(), images=None, frozen=None, per_step=None, n_kpconv=11,
                overflow_free=False):
    """``train_step`` at full width (with ``images``, batched, the color
    model): one warm step, then 3 timed steps with the launch counters
    zeroed just before them; the kernels ``launched`` must have run, those
    in ``idle`` not, and those of ``per_step`` exactly that many times a
    step.  Every tensor of the state dict under the prefix ``frozen``
    (parameters and buffers) must be bit-identical after the four steps.
    The model has ``n_kpconv`` KPConv weights; with ``overflow_free`` no
    step's pyramid may drop a voxel."""
    import torch
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.ops.neighbors import min_dist_sq, radius_sq
    from pcrcg_tpu_torch.train.step import train_step

    pts, msk = batch.loss_points[0], batch.masks[0]
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
        totals, overflows = [], []
        for _ in range(n_steps):
            stats = train_step(state, cfg, batch, generator=gen, **kw)
            totals.append(stats["total"])
            overflows.append(stats["max_overflow"])
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
    check(len(kp_weights) == n_kpconv and not zero_kp,
          f"KPConv weights without a gradient: {zero_kp}")
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
    for key, n in (per_step or {}).items():
        check(launches[key] == n * n_steps,
              f"[{tag}] {key}: {launches[key]} launches, expected {n} a step")
    if overflow_free:
        check(max(float(v) for v in overflows) == 0.0,
              f"[{tag}] the pyramid dropped voxels: max_overflow {overflows}")
    return launches


def _overlap_crop(n_src, n_tgt, at=0.5):
    """The assets pair cut to the n nearest points of each cloud around one
    point of their overlap (the one at quantile ``at`` of the overlapping
    source points' order), with the GT pose."""
    import numpy as np
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
    from pcrcg_tpu_torch.ops.neighbors import min_dist_sq

    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    warped = src @ rot.T + trans
    d2 = min_dist_sq(torch.from_numpy(warped), torch.from_numpy(tgt),
                     torch.ones(len(tgt), dtype=torch.bool)).numpy()
    overlap = np.flatnonzero(d2 < 0.0375**2)
    center = src[overlap[int(len(overlap) * at)]]

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


def _agree_budgets(**overrides):
    """The budgets of [agree*] and [agree-train*]: 4 levels at N0 = 2,048."""
    from pcrcg_tpu_torch.config import Budgets

    return Budgets(**{"points": (2048, 1024, 512, 256), "neighbors": (40,) * 4, "corr_k": 8,
                      "query_chunk": 512, "search_tile": 128, "search_m_tiles": 4,
                      **overrides})


def _agree_train_config(**overrides):
    """[agree-train*]'s Config: tiny widths at ``_agree_budgets()``, both
    heads on unless ``overrides`` say otherwise."""
    from pcrcg_tpu_torch.config import tiny_test_config

    return tiny_test_config(**{"budgets": _agree_budgets(), "node_overlap": True,
                               "quaternion": True, **overrides})


def _agree_train_draws(cfg):
    """The loss's draws of [agree-train*]: one row for the gradient, two for
    the SGD steps."""
    import torch

    gen = torch.Generator().manual_seed(3)
    return torch.rand(3, 1, cfg.budgets.points[0] * cfg.budgets.corr_k, generator=gen)


def _rounding_sensitivity(sample, **overrides):
    """How far one rounding unit moves the CPU path on ``sample`` under
    [agree-train]'s Config, weights and draws: once every K2 output (the
    KPConv sums) scaled by 1 + 1e-7·N(0, 1), fp32 rounding (K2 and its
    plain version on the card differ by more: [kernels]' rel), once every
    weight, as [agree-train]'s own perturbed run (the two paths' weights
    differ so after an update).  Returns the worst
    parameter's change as a share of [agree-train]'s bounds, the
    gradient's and the two SGD steps' update's, the largest of the two
    runs.  Where it is large, rounding alone moves the CPU path past the
    bounds (a near-tied choice downstream flips), and the CUDA path cannot
    be held to the CPU path there."""
    import torch
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import pair_loss, train_step

    cfg = _agree_train_config(**overrides)
    draws = _agree_train_draws(cfg)
    batch = make_pair_batch([sample], cfg.budgets.points[0])
    raw = None if batch.raw_points is None else batch.raw_points[0]
    real = kt_mod.kpconv_tiled
    noise = torch.Generator().manual_seed(5)

    def rounded(*args, **kw):
        out, *rest = real(*args, **kw)
        return (out * (1.0 + 1e-7 * torch.randn(out.shape, generator=noise)), *rest)

    runs = []
    for fn, eps in ((real, 0.0), (rounded, 0.0), (real, 1e-7)):
        kt_mod.kpconv_tiled = fn
        try:
            state = TrainState(cfg, init_kpfcnn(cfg, seed=2, device="cpu"), steps_per_epoch=1)
            if eps:
                weight_noise = torch.Generator().manual_seed(4)
                with torch.no_grad():
                    for p in state.model.parameters():
                        p.mul_(1.0 + eps * torch.randn(p.shape, generator=weight_noise))
            with torch.enable_grad():
                pair_loss(state.model, cfg, batch.points[0], batch.masks[0], batch.features[0],
                          batch.rot[0], batch.trans[0], uniforms=draws[0, 0],
                          raw_points=raw)["total"].backward()
            grads = {n: p.grad.double() for n, p in state.model.named_parameters()}
            state.zero_grad()
            start = {n: p.detach().double() for n, p in state.model.named_parameters()}
            for u in draws[1:]:
                train_step(state, cfg, batch, uniforms=u)
            updates = {n: p.detach().double() - start[n]
                       for n, p in state.model.named_parameters()}
        finally:
            kt_mod.kpconv_tiled = real
        runs.append((grads, updates))

    def share(got, want, rtol, floor_rtol):
        floor = floor_rtol * max(float(w.norm()) for w in want.values())
        return max(float((got[n] - w).norm()) / (rtol * float(w.norm()) + floor)
                   for n, w in want.items())

    (g0, u0), *perturbed = runs
    return max(max(share(g, g0, 1e-3, 1e-6), share(u, u0, 1e-2, 1e-5)) for g, u in perturbed)


def phase_agree_train(tag="agree-train", sample=None, **overrides):
    """CUDA path vs CPU plain path of the training slice on a small crop
    (``overrides``: Config fields, the KPConv route, the heads, both on
    unless overridden; ``sample``: a pair's sample dict in place of the
    assets crop, its loss on the raw clouds when it has them),
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
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import pair_loss, train_step

    cfg = _agree_train_config(**overrides)
    sample = _overlap_crop(2048, 2000) if sample is None else sample
    draws = _agree_train_draws(cfg)
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
                              uniforms=draws[0, 0].to(dev),
                              raw_points=None if batch.raw_points is None
                              else batch.raw_points[0])
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
    loss_on = "raw clouds" if "raw_src_pcd" in sample else "model-input clouds"
    heads = [h for h in ("node_overlap", "quaternion") if getattr(cfg, h)]
    print(f"[{tag}] CUDA vs CPU plain path (N0=2048, heads {heads}, loss on the {loss_on}): "
          "loss terms max "
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


def _epoch_losses(run):
    """Run ``run()`` (an entry point that trains) with the Trainer's train
    and eval steps recorded; returns (its result, every step's stats)."""
    import pcrcg_tpu_torch.train.trainer as trainer_mod

    real = {name: getattr(trainer_mod, name) for name in ("train_step", "eval_step")}
    stats = []

    def recorder(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            stats.append(out)
            return out
        return wrapped

    for name, fn in real.items():
        setattr(trainer_mod, name, recorder(fn))
    try:
        result = run()
    finally:
        for name, fn in real.items():
            setattr(trainer_mod, name, fn)
    return result, [{k: float(v) for k, v in s.items()} for s in stats]


def _serving_calls(cfg, batch, model, **reg_kw):
    """K1's and K2's calls in one ``register_pair`` of ``batch``'s pair."""
    import torch
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch.eval.tester import register_pair

    gen = torch.Generator(device="cuda").manual_seed(0)
    with recording_k1([(pyramid_mod, "radius_search_tiled_batch")]) as k1_calls:
        calls = record_calls(lambda: register_pair(model, cfg, batch.points[0], batch.masks[0],
                                                   batch.features[0], gen, **reg_kw),
                             {"K2": (kt_mod, "kpconv_tiled")})
    return k1_calls, calls["K2"]


def _training_calls(cfg, batch, state):
    """The loss's K1 calls and K3's / K5's in one ``train_step``."""
    import torch
    import pcrcg_tpu_torch.losses as losses_mod

    gen = torch.Generator(device="cuda").manual_seed(1)
    with recording_k1([(losses_mod, "min_dist_sq_tiled"),
                       (losses_mod, "radius_search_tiled")]) as k1_loss:
        calls = record_backward_inputs(cfg, batch, state, gen)
    return k1_loss, calls


def _device_ms(tag, cfg, batch, model, state, reg_kw):
    """Device busy ms of one pair (``register_pair``, 3 profiled) and of one
    training step (2 profiled), after a warm call of each."""
    import torch
    from pcrcg_tpu_torch.eval.tester import register_pair
    from pcrcg_tpu_torch.profile import _device_profile
    from pcrcg_tpu_torch.train.step import train_step

    gen = torch.Generator(device="cuda").manual_seed(2)

    def pair():
        register_pair(model, cfg, batch.points[0], batch.masks[0], batch.features[0], gen,
                      **reg_kw)

    def step():
        train_step(state, cfg, batch, generator=gen)

    out = {}
    for name, fn, count in (("pair", pair, 3), ("step", step, 2)):
        fn()
        prof = _device_profile(fn, count)
        out[name] = prof["device_busy_ms"]
        print(f"[{tag}] {name}: device busy {prof['device_busy_ms']:.2f} ms (share "
              f"{prof['device_busy_share']:.3f} of {prof['profiled_wall_ms']:.1f} ms profiled), "
              f"{prof['launches']:.0f} launches and {prof['syncs']:.1f} stream syncs a {name}",
              flush=True)
    return out


def _epoch_checks(tag, path, trainer, stats, launches, n_train, expect):
    """[kitti] / [modelnet]'s checks of a ``main`` epoch: every train and
    val step's loss terms finite, no voxel dropped, the steps counted, K2-K5
    launched and ``expect``'s kernels exactly that many times."""
    import math

    bad = [s for s in stats if not all(math.isfinite(v) for v in s.values())]
    overflow = max(s["max_overflow"] for s in stats)
    print(f"[{tag}] main --config {path.name}: {trainer.state.step} train steps and "
          f"{len(stats) - trainer.state.step} val steps, launches "
          + " ".join(f"{k} {v}" for k, v in launches.items())
          + f"; totals {min(s['total'] for s in stats):.4f} .. "
          f"{max(s['total'] for s in stats):.4f}, max_overflow {overflow:g}", flush=True)
    check(trainer.state.step == n_train >= 4, f"[{tag}] {trainer.state.step} train steps")
    check(not bad, f"[{tag}] a step's loss terms are not finite: {bad[:1]}")
    check(overflow == 0.0, f"[{tag}] the pyramid dropped voxels: max_overflow {overflow}")
    check(all(launches[k] > 0 for k in ("K2", "K3", "K4", "K5")),
          f"[{tag}] a kernel of the training path never launched: {launches}")
    for key, n in expect.items():
        check(launches[key] == n, f"[{tag}] {key}: {launches[key]} launches, expected {n}")


# [kitti]'s drive: frames 3.3 m apart, paired (0, 3), (4, 7), (8, 11),
# (12, 15): a Trainer epoch of 4 steps, 4 val and 4 test pairs.
KITTI_FRAMES = 17


def _crop_around_midpoint(sample, n):
    """The n raw points of each cloud nearest to the midpoint between the
    two scanners, with the same rows of the model-input clouds."""
    import numpy as np

    rot, trans = sample["rot"].astype(np.float64), sample["trans"].astype(np.float64)
    c_src = -0.5 * rot.T @ trans
    out = dict(rot=sample["rot"], trans=sample["trans"])
    for cloud, c in (("src", c_src), ("tgt", rot @ c_src + trans)):
        raw = sample[f"raw_{cloud}_pcd"]
        rows = np.argsort(((raw - c) ** 2).sum(1), kind="stable")[:n]
        out[f"{cloud}_pcd"] = sample[f"{cloud}_pcd"][rows]
        out[f"raw_{cloud}_pcd"] = raw[rows]
    return out


def phase_kitti(repo, work):
    """[kitti] and [agree-train-kitti]: configs/train/kitti.yaml (its data
    paths, exp_dir, max_epoch and num_workers changed) on a synthetic drive
    (``assets.py::write_kitti_fixture``: 17 HDL-64E-like scans of 120,000
    rays).  -> the device ms of a pair and a step."""
    import contextlib
    import numpy as np
    import torch
    import yaml
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch import main as tmain
    from pcrcg_tpu_torch.assets import write_kitti_fixture
    from pcrcg_tpu_torch.config import load_config
    from pcrcg_tpu_torch.data.loader import PairLoader
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.eval.tester import KITTITester
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
    from pcrcg_tpu_torch.profile import _device_profile
    from pcrcg_tpu_torch.train.state import TrainState

    t0 = time.perf_counter()
    write_kitti_fixture(work / "kitti", KITTI_FRAMES, seed=0)
    lists = work / "configs" / "kitti"
    lists.mkdir(parents=True)
    for split in ("train", "val", "test"):
        (lists / f"{split}_kitti.txt").write_text("0\n")
    with open(repo / "configs" / "train" / "kitti.yaml") as f:
        raw = yaml.safe_load(f)
    raw["misc"]["exp_dir"] = str(work / "exp_kitti")
    raw["model"]["root"] = str(work / "kitti")
    raw["optimiser"]["max_epoch"] = 1
    raw["dataset"]["num_workers"] = 2
    path = work / "kitti.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    print(f"  fixture: {KITTI_FRAMES} scans in {time.perf_counter() - t0:.1f} s", flush=True)

    # KITTIDataset reads configs/kitti/<split>_kitti.txt from the working
    # directory, as the JAX package's does.
    with contextlib.chdir(work):
        cfg = load_config(str(path))
        n0 = cfg.budgets.points[0]
        train_ds = tmain.build_datasets(cfg)["train"]
        test_ds = tmain.build_datasets(cfg.replace(mode="test"))["test"]
        # The ICP-refined GT of every pair, cached under <root>/icp before
        # anything is timed (the val and test splits share the drive).
        t0 = time.perf_counter()
        test_samples = [test_ds.get(i) for i in range(len(test_ds))]
        rng = np.random.default_rng(0)
        train_samples = [train_ds.get(i, rng) for i in range(len(train_ds))]
        print(f"  ICP cache warmed for {len(test_ds)} pairs in {time.perf_counter() - t0:.1f} s;"
              " level 0 after the 0.3 m voxel: " + ", ".join(
                  f"{len(s['src_pcd'])}/{len(s['tgt_pcd'])}" for s in test_samples), flush=True)
        check(len(train_ds) == len(test_ds) == 4, f"[kitti] {len(test_ds)} pairs, expected 4")

        batch = make_pair_batch(test_samples[:1], n0, device="cuda")
        model = init_kpfcnn(cfg, seed=0, device="cuda")
        with torch.no_grad():
            pyr, overflow = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0],
                                              with_overflow=True)
        print(f"[kitti] pyramid of a test pair: points a level "
              + " ".join(str(m.sum(1).tolist()) for m in pyr.masks)
              + f" (budgets {list(cfg.budgets.points)}), overflow {overflow.tolist()}", flush=True)
        check(int(overflow.max()) <= 0, f"[kitti] the pyramid drops voxels: {overflow.tolist()}")
        pairs = [make_pair_batch([smp], n0, device="cuda") for smp in test_samples[:2]]
        phase_pyramid_graph("kitti.yaml", cfg, [(b.points[0], b.masks[0]) for b in pairs])
        del pairs
        reg_kw = dict(distance_threshold=0.3, ransac_n=4)
        k1_calls, k2_calls = _serving_calls(cfg, batch, model, **reg_kw)
        tbatch = make_pair_batch(train_samples[:1], n0, device="cuda")
        check(tbatch.raw_points is not None
              and not torch.allclose(tbatch.raw_points, tbatch.points, atol=0.5),
              "[kitti] the train batch has no raw clouds apart from the model input")
        state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
        k1_loss, calls = _training_calls(cfg, tbatch, state)
        print(f"[kitti] recorded {len(k1_calls)} K1 and {len(k2_calls)} K2 calls in one "
              f"register_pair, the loss's {len(k1_loss)} K1, {len(calls['K3'])} K3 and "
              f"{len(calls['K5'])} K5 calls in one train_step", flush=True)
        check(len(k1_calls) == 9 and len(k1_loss) == 3 and len(calls["K5"]) == 3,
              "[kitti] unexpected call counts")
        phase_k1(k1_calls + k1_loss, tag="kitti")
        phase_k2(k2_calls, tag="kitti")
        del k1_calls, k1_loss, k2_calls
        phase_k3_k4(calls["K3"], tag="kitti")
        phase_k5(calls["K5"], tag="kitti")
        del calls
        torch.cuda.empty_cache()
        phase_train(cfg, tbatch, state, "kitti-train", idle=("K6", "K7", "K8"),
                    per_step={"K5": 3}, overflow_free=True)
        device_ms = _device_ms("kitti", cfg, tbatch, model, state, reg_kw)
        del state, model
        torch.cuda.empty_cache()

        kernels.reset_launches()
        trainer, stats = _epoch_losses(lambda: tmain.main(["--config", str(path)]))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        _epoch_checks("kitti", path, trainer, stats, launches, len(train_ds),
                      {"K5": 3 * len(train_ds)})
        check(launches["K1"] > 0, f"[kitti] K1 never launched: {launches}")
        first, _ = next(iter(trainer.loaders["train"]))
        check(first.raw_points is not None
              and not torch.allclose(first.raw_points, first.points, atol=0.5),
              "[kitti] the Trainer's batches carry no raw clouds apart from the model input")

        loader = PairLoader(test_ds, n0, batch_size=1, num_threads=2, drop_last=False,
                            pin_memory=True)
        tester = KITTITester(cfg, trainer.model)
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = tester.run(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        prof = _device_profile(lambda: tester.run(loader), 1)
        n = res["n_pairs"]
        print(f"[kitti] KITTITester: {n} pairs in {wall:.2f} s ({n / wall:.3f} pairs/s, the ICP "
              f"cache warm, the loader's reads included), device busy "
              f"{prof['device_busy_ms'] / n:.1f} ms a pair; recall "
              f"{res['registration_recall']:.4f}, RRE {np.round(res['rre'], 3).tolist()} deg, "
              f"RTE {np.round(res['rte'], 3).tolist()} m; launches "
              + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
        check(n == len(test_ds), f"[kitti] {n} of {len(test_ds)} pairs scored")
        check(bool(np.isfinite(res["rre"]).all() and np.isfinite(res["rte"]).all()),
              "[kitti] a non-finite RRE or RTE")
        check(0.0 <= res["registration_recall"] <= 1.0, "[kitti] recall outside [0, 1]")
        check(launches["K1"] > 0 and launches["K2"] > 0, f"[kitti] K1 / K2 idle: {launches}")
        del trainer, tester
        torch.cuda.empty_cache()

        # The radii and heads of configs/train/kitti.yaml (no node-overlap
        # or pose head), on the first train pair whose crop is well
        # conditioned: where one rounding unit in K2's outputs or in the
        # weights already moves the CPU path's gradients or updates past a
        # tenth of their bounds, the CUDA path (which rounds otherwise)
        # cannot be held to it.
        kitti_cfg = dict(dataset="kitti", **{k: getattr(cfg, k) for k in (
            "first_subsampling_dl", "pos_radius", "safe_radius", "overlap_radius",
            "matchability_radius", "node_overlap", "quaternion")})
        shares = []
        for s in train_samples:
            crop = _crop_around_midpoint(s, 2048)
            shares.append(_rounding_sensitivity(crop, **kitti_cfg))
            if shares[-1] <= 0.1:
                break
        print(f"[agree-train-kitti] train pairs' crops, one rounding unit in K2's outputs or "
              "the weights moves "
              f"the CPU path's gradients or updates by {[round(v, 3) for v in shares]} of their "
              f"bounds; held on pair {len(shares) - 1}", flush=True)
        check(shares[-1] <= 0.1, "[agree-train-kitti] no train pair's crop is well conditioned")
        phase_agree_train("agree-train-kitti", sample=crop, **kitti_cfg)
    return device_ms


# [modelnet]'s shards: 24 shapes each, shape i of category (3 i) mod 40 in
# configs/modelnet/modelnet40_all.txt's order: 13 of each shard's in half1
# (the train split of the train shard, the val split of the test shard),
# 11 in half2 (the test split of the test shard).
MODELNET_SHAPES = 24


def phase_modelnet(repo, work):
    """[modelnet] and [agree-modelnet]: configs/train/modelnet.yaml (its data
    paths, exp_dir, max_epoch and num_workers changed: 3 levels, 1,024
    points, crops of 0.7) on ``assets.py::modelnet_shapes``.  The card's
    machine has no h5py: ``ModelNetHdf`` reads its shards through a
    subclass here whose ``_read_h5`` gives the shapes.  -> the device ms of
    a pair and a step."""
    import numpy as np
    import torch
    import yaml
    import pcrcg_tpu_torch.data.modelnet as mn_mod
    import pcrcg_tpu_torch.eval.modelnet_metrics as mm_mod
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch import main as tmain
    from pcrcg_tpu_torch.assets import modelnet_shapes
    from pcrcg_tpu_torch.config import Budgets, load_config
    from pcrcg_tpu_torch.data.loader import PairLoader
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.train.state import TrainState

    class ShapesHdf(mn_mod.ModelNetHdf):
        """``ModelNetHdf`` over ``modelnet_shapes``: each shard is
        MODELNET_SHAPES shapes (seed 0 for the train shard, 1 for the test
        shard), categories filtered as the HDF5 reader filters them."""

        @staticmethod
        def _read_h5(files, categories):
            data, labels = [], []
            for fname in files:
                d = modelnet_shapes(MODELNET_SHAPES, 2048, seed=int("test" in Path(fname).name))
                lab = (3 * np.arange(MODELNET_SHAPES)) % 40
                keep = np.isin(lab, categories) if categories is not None else lab >= 0
                data.append(d[keep])
                labels.append(lab[keep])
            return np.concatenate(data), np.concatenate(labels)

    root = work / "modelnet"
    root.mkdir()
    (root / "shape_names.txt").write_text(
        (repo / "configs" / "modelnet" / "modelnet40_all.txt").read_text())
    for subset in ("train", "test"):
        (root / f"{subset}_files.txt").write_text(
            f"data/modelnet40_ply_hdf5_2048/ply_data_{subset}0.h5\n")
    with open(repo / "configs" / "train" / "modelnet.yaml") as f:
        raw = yaml.safe_load(f)
    raw["misc"]["exp_dir"] = str(work / "exp_modelnet")
    raw["model"]["root"] = str(root)
    for split in ("train", "val", "test"):  # the shipped category lists, wherever this runs
        key = f"{split}_categoryfile"
        raw["dataset"][key] = str(repo / raw["dataset"][key])
    raw["optimiser"]["max_epoch"] = 1
    raw["dataset"]["num_workers"] = 2
    path = work / "modelnet.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)

    real = mn_mod.ModelNetHdf
    mn_mod.ModelNetHdf = ShapesHdf
    try:
        cfg = load_config(str(path))
        n0 = cfg.budgets.points[0]
        train_ds = tmain.build_datasets(cfg)["train"]
        test_ds = tmain.build_datasets(cfg.replace(mode="test"))["test"]
        np.random.seed(0)  # the train chain draws its per-sample seeds here
        sample = train_ds[0]
        check(cfg.num_layers == 3 and cfg.architecture.count("resnetb_strided") == 2,
              "configs/train/modelnet.yaml is not the 3-level topology")
        batch = make_pair_batch([sample], n0, device="cuda")
        model = init_kpfcnn(cfg, seed=0, device="cuda")
        reg_kw = dict(n_points=450, distance_threshold=0.02, ransac_n=3)
        k1_calls, k2_calls = _serving_calls(cfg, batch, model, **reg_kw)
        state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
        k1_loss, calls = _training_calls(cfg, batch, state)
        print(f"[modelnet] {len(train_ds)} train, {len(test_ds)} test pairs of "
              f"{len(sample['src_pcd'])}/{len(sample['tgt_pcd'])} points; recorded "
              f"{len(k1_calls)} K1 and {len(k2_calls)} K2 calls in one register_pair, the "
              f"loss's {len(k1_loss)} K1, {len(calls['K3'])} K3 and {len(calls['K5'])} K5 calls "
              "in one train_step", flush=True)
        check(len(calls["K5"]) == 2 and len(calls["K3"]) == 9,
              "[modelnet] K5 must run for the 2 strided blocks, K3 for the 9 KPConvs")
        # 1,024 points make 8 search tiles of 128, no more than
        # search_m_tiles (12): every search takes the tiled search's dense
        # fallback, in the JAX package too, so K1 (its pruned route) idles.
        check(not k1_calls and not k1_loss, "[modelnet] K1 ran: the search tiles were pruned")
        phase_k2(k2_calls, tag="modelnet", shapes=((1, 128), (64, 64), (128, 128), (256, 256)))
        phase_k3_k4(calls["K3"], tag="modelnet")
        phase_k5(calls["K5"], tag="modelnet")
        del k1_calls, k1_loss, k2_calls, calls
        phase_train(cfg, batch, state, "modelnet-train", launched=("K2", "K3", "K4", "K5"),
                    idle=("K1", "K6", "K7", "K8"),
                    per_step={"K5": 2}, n_kpconv=9, overflow_free=True)
        device_ms = _device_ms("modelnet", cfg, batch, model, state, reg_kw)
        del state, model
        torch.cuda.empty_cache()

        kernels.reset_launches()
        trainer, stats = _epoch_losses(lambda: tmain.main(["--config", str(path)]))
        torch.cuda.synchronize()
        _epoch_checks("modelnet", path, trainer, stats, dict(kernels.LAUNCHES), len(train_ds),
                      {"K1": 0, "K5": 2 * len(train_ds)})

        items = list(PairLoader(test_ds, n0, batch_size=1, num_threads=2, drop_last=False,
                                pin_memory=True))
        seen = []
        real_metrics = mm_mod.compute_metrics
        mm_mod.compute_metrics = lambda *a: seen.append(a[2]) or real_metrics(*a)
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            summary = mm_mod.ModelnetTester(cfg, trainer.model).run(items)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            mm_mod.compute_metrics = real_metrics
        launches = dict(kernels.LAUNCHES)
        n = summary.pop("n_pairs")
        raws = np.stack([b.extras["points_raw"][0].numpy() for b, _ in items])
        print(f"[modelnet] ModelnetTester: {n} pairs in {wall:.2f} s ({n / wall:.3f} pairs/s), "
              + ", ".join(f"{k} {v:.4f}" for k, v in summary.items())
              + "; launches " + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
        check(n == len(test_ds) >= 8, f"[modelnet] {n} of {len(test_ds)} pairs scored")
        check(all(np.isfinite(v) for v in summary.values()), "[modelnet] a non-finite metric")
        check(len(seen) == 1 and np.array_equal(seen[0], raws),
              "[modelnet] the chamfer did not take the batches' extras['points_raw']")
        check(launches["K1"] == 0 and launches["K2"] > 0,
              f"[modelnet] K1 ran or K2 idled: {launches}")
        del trainer
        torch.cuda.empty_cache()

        np.random.seed(1)
        phase_agree("agree-modelnet", budgets=Budgets(
            points=(1024, 512, 256), neighbors=(40,) * 3, corr_k=8, query_chunk=512,
            search_tile=128, search_m_tiles=4), sample=test_ds[0], dataset="modelnet",
            first_subsampling_dl=cfg.first_subsampling_dl)
    finally:
        mn_mod.ModelNetHdf = real
    return device_ms


# [kernels-deformable]: the offset sub-convs' widths, (C, D) = (quarter of
# the block's width, 4K) under Config(deformable=True, modulated=True).
OFFSET_SHAPES = ((64, 60), (128, 60), (256, 60), (512, 60))


def phase_deformable(batch):
    """[kernels-deformable], [path-deformable], [train-deformable],
    [agree-deformable], [agree-train-deformable]: ``Config(deformable=True,
    modulated=True)`` at full width on the assets pair (seeded random
    weights).  K1 on the 9 serving searches at the widened radii, K6 on the
    10 offset sub-convs of a serving forward and K3's gathered entry on
    their backward in one ``train_step`` are held against their plain
    versions and timed; then a pair, 3 train steps, and the CUDA path
    against the CPU path at the tiny widths."""
    import torch
    import pcrcg_tpu_torch.ops.kpconv_fused as kf_mod
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch.config import Config
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_fused, kpconv_fused_plain
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
    from pcrcg_tpu_torch.train.state import TrainState

    cfg = Config(deformable=True, modulated=True)
    conv_flags, pool_flags = cfg.deform_level_flags()
    print(f"[kernels-deformable] search radii widened by {cfg.deform_radius / cfg.conv_radius:g} "
          f"at conv levels {[i for i, f in enumerate(conv_flags) if f]} and pool levels "
          f"{[i for i, f in enumerate(pool_flags) if f]}", flush=True)
    model = init_kpfcnn(cfg, seed=0, device="cuda")

    def forward():
        with torch.no_grad():
            model(build_pyramid_cfg(cfg, batch.points[0], batch.masks[0]), batch.features[0])

    with recording_k1([(pyramid_mod, "radius_search_tiled_batch")]) as k1_calls:
        calls = record_calls(forward, {"K6": (kf_mod, "kpconv_fused"),
                                       "K2": (kt_mod, "kpconv_tiled")})
    print(f"[kernels-deformable] recorded {len(k1_calls)} K1, {len(calls['K2'])} K2 and "
          f"{len(calls['K6'])} K6 calls (the offset sub-convs) in one serving forward",
          flush=True)
    check(len(k1_calls) == 9 and len(calls["K2"]) == 1 and len(calls["K6"]) == 10,
          "[kernels-deformable] unexpected call counts")
    phase_k1(k1_calls, tag="kernels-deformable")
    k6 = _gathered_conv_phase("K6", calls["K6"], kpconv_fused, kpconv_fused_plain, OFFSET_SHAPES,
                              tag="kernels-deformable")
    del calls, k1_calls
    torch.cuda.empty_cache()

    state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    calls = record_gathered_backward_inputs(cfg, batch, state, gen)
    print(f"[kernels-deformable] recorded {len(calls['K3g'])} calls of K3's gathered entry (the "
          "offset sub-convs' backward) in one train_step", flush=True)
    check(len(calls["K3g"]) == 10, "[kernels-deformable] K3 gathered: expected 10 calls")
    k3g = phase_k3g(calls["K3g"], tag="kernels-deformable")
    del calls
    torch.cuda.empty_cache()

    # Block 0 (simple, rigid) on K2; every resnetb block deformable: its
    # offset sub-conv on K6 forward and K3's gathered entry backward, its
    # deformable conv dense, its strided shortcut the tiled route's
    # max-pool (K5 backward).
    phase_path(cfg, batch, model, "path-deformable",
               {"K1": None, "K2": 1, "K6": 10, "K7": 0, "K8": 0})
    del model
    phase_train(cfg, batch, state, "train-deformable",
                launched=("K1", "K2", "K3", "K5", "K6"), idle=("K4", "K7", "K8"),
                per_step={"K2": 1, "K6": 10, "K3": 11, "K5": 3})
    del state
    torch.cuda.empty_cache()
    phase_agree("agree-deformable", deformable=True, modulated=True)
    # The CUDA path against the CPU path in training, with the shipped
    # configs' heads (off) on the first crop of the assets pair that is well
    # conditioned: with both heads on, one rounding unit in K2's outputs or
    # the weights moves the deformable model's CPU gradients or updates by
    # 0.4 to 13 times their bounds on every crop tried (a CPU rehearsal).
    deform_cfg = dict(deformable=True, modulated=True, node_overlap=False, quaternion=False)
    shares = []
    for at in (0.5, 0.1, 0.25):
        crop = _overlap_crop(2048, 2000, at)
        shares.append(_rounding_sensitivity(crop, **deform_cfg))
        if shares[-1] <= 0.1:
            break
    print(f"[agree-train-deformable] crops around the overlap points at quantiles 0.5, 0.1, "
          f"0.25: one rounding unit in K2's outputs or the weights moves the CPU path's "
          f"gradients or updates by {[round(v, 3) for v in shares]} of their bounds; held on "
          f"crop {len(shares) - 1}", flush=True)
    check(shares[-1] <= 0.1, "[agree-train-deformable] no crop is well conditioned")
    phase_agree_train("agree-train-deformable", sample=crop, **deform_cfg)
    torch.cuda.empty_cache()
    phase_deformable_kitti()
    return k6, k3g


# [kernels-deformable-kitti]: the offset sub-convs' (C, D) in the benchmark's
# deformable KITTI configuration (unmodulated: D = 3K).
KITTI_DEFORM_SHAPES = ((256, 45), (512, 45))


def phase_deformable_kitti(seed=3180000701):
    """[kernels-deformable-kitti]: the configuration of the benchmark's
    ``pcrcg_kitti_deform.train`` cell on the first pair of its traffic, the
    cell's seeded weights and training state, all made as a run of the cell
    makes them from ``seed``.  One ``train_step``'s calls of K1 (the
    pyramid's searches and the loss's), K6 (the 5 offset sub-convs' forward)
    and K3's gathered entry (their backward) are recorded; each is held
    against its plain version and timed as in [kernels-deformable], at the
    widened caps: k = neighbors[2] in K1, H = neighbors[2] and neighbors[3]
    in K6 and K3."""
    import torch
    import pcrcg_tpu_torch.losses as losses_mod
    import pcrcg_tpu_torch.ops.kpconv_fused as kf_mod
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_fused, kpconv_fused_plain
    from pcrcg_tpu_torch.train.step import train_step
    from perfbench.core import files, harness, program, weights

    tag = "kernels-deformable-kitti"
    device = torch.device("cuda", 0)
    cell = files.load_cell("pcrcg_kitti_deform.train")
    cfg = program.port_config(cell["sections"])
    caps = cfg.budgets.neighbors
    sample = files.make_pool(cell["traffic_params"], harness.sub_seed(seed, 1), device,
                             images=False)[0]
    batch = program.make_batch(sample, cfg, device)
    state = weights.seeded_state(program.model_shapes(cfg), harness.sub_seed(seed, 0), device)
    model = program.build_model(cfg, state, device)
    del state
    train = program.train_state(cfg, model, cell["steps_per_epoch"])
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, 2))
    with recording_k1([(pyramid_mod, "radius_search_tiled_batch"),
                       (losses_mod, "min_dist_sq_tiled"),
                       (losses_mod, "radius_search_tiled")]) as k1_calls:
        calls = record_calls(lambda: train_step(train, cfg, batch, generator=gen),
                             {"K6": (kf_mod, "kpconv_fused"),
                              "K3g": (kf_mod, "kpconv_fused_bwd")})
    ks = sorted({args[3] for mode, args in k1_calls if mode == "topk"})
    h6 = sorted({args[1].shape[0] for args, _ in calls["K6"]})
    h3 = sorted({args[1].shape[0] for args, _ in calls["K3g"]})
    print(f"[{tag}] caps {tuple(caps)}; recorded {len(k1_calls)} K1 calls (top-k k {ks}), "
          f"{len(calls['K6'])} K6 calls (H {h6}) and {len(calls['K3g'])} calls of K3's gathered "
          f"entry (H {h3}) in one train_step", flush=True)
    check(caps[2] in ks, f"[{tag}] no K1 call at k = {caps[2]}")
    check(len(calls["K6"]) == 5 and len(calls["K3g"]) == 5,
          f"[{tag}] expected 5 K6 and 5 K3 gathered calls")
    check(h6 == h3 == sorted({caps[2], caps[3]}), f"[{tag}] H is not the caps at levels 2-3")
    del model, train
    k1 = phase_k1(k1_calls, tag=tag)
    del k1_calls
    k6 = _gathered_conv_phase("K6", calls["K6"], kpconv_fused, kpconv_fused_plain,
                              KITTI_DEFORM_SHAPES, tag=tag)
    k3g = phase_k3g(calls["K3g"], tag=tag)
    del calls
    torch.cuda.empty_cache()
    return k1, k6, k3g


def _level_perm(p_from, m_from, p_to, m_to):
    """Row i of a level in one pyramid -> the row of the same voxel in the
    other: its nearest point there (the same voxels in another order;
    from level 2 on their barycenters sum the finer level's rows in another
    order, so they agree to rounding).  Pads map to the shadow index."""
    import torch
    from pcrcg_tpu_torch.ops.neighbors import knn_search

    n = p_from.shape[0]
    perm = torch.full((n + 1,), n, dtype=torch.long)
    rf = torch.nonzero(m_from.cpu()).flatten()
    idx = knn_search(p_from.cpu()[rf], p_to.cpu(), m_to.cpu(), 1)[0][:, 0]
    gap = float((p_from.cpu()[rf].double() - p_to.cpu()[idx].double()).abs().max())
    check(int(m_from.sum()) == int(m_to.sum()), "[routes-dense] the pyramids hold other voxels")
    check(gap <= 1e-5 and idx.unique().numel() == rf.numel(),
          f"[routes-dense] the pyramids' voxels differ (max coordinate gap {gap:.2e})")
    perm[rf] = idx
    return perm


def _neighbor_recall(t_idx, d_idx, q_perm, s_perm):
    """The share of the exact (dense) neighbor lists' entries that the
    tiled lists hold, over every real query of both clouds."""
    import torch

    found = total = 0
    for c in range(t_idx.shape[0]):
        n = s_perm[c].shape[0] - 1
        t = s_perm[c][t_idx[c].cpu()]  # into the dense pyramid's rows
        rows = q_perm[c][:-1]
        real = rows < rows.shape[0]
        t, d = t[real], d_idx[c].cpu()[rows[real]]
        both = torch.cat([t, d], 1).sort(1).values
        found += int(((both[:, 1:] == both[:, :-1]) & (both[:, 1:] < n)).sum())
        total += int((d < n).sum())
    return found / max(total, 1)


def _tiled_in_dense(t_idx, d_idx, q_perm, s_perm):
    """The share of the tiled lists' real entries that the dense lists hold,
    over the rows whose dense list has room (a full list keeps only the
    nearest neighbors, which may exclude a tiled entry): 1 unless the dense
    search loses neighbors, or a distance at the radius rounds to either
    side in the two searches."""
    import torch

    found = total = 0
    for c in range(t_idx.shape[0]):
        n = s_perm[c].shape[0] - 1
        t = s_perm[c][t_idx[c].cpu()]  # into the dense pyramid's rows
        rows = q_perm[c][:-1]
        real = rows < rows.shape[0]
        t, d = t[real], d_idx[c].cpu()[rows[real]]
        room = (d >= n).any(1)
        t, d = t[room], d[room]
        held = t < n
        found += int(((t.unsqueeze(2) == d.unsqueeze(1)).any(2) & held).sum())
        total += int(held.sum())
    return found / max(total, 1)


def phase_routes_dense(batch, cfg_tiled, cfg_dense):
    """[routes-dense]: the tiled route (Morton-ordered pyramid, K1's pruned
    searches, K2) against the dense one (raster order, exact searches, K6 /
    K7) on the assets pair, the same seeded weights.  The tiled search
    keeps each 128-query group's ``search_m_tiles`` nearest candidate tiles,
    so it finds most, not all, of the exact search's neighbors (the JAX
    package measured a neighbor recall of 0.962 / 0.978 / 0.994 / 1.0 by
    level at m_tiles 12 on this pair, pcrcg_tpu/config.py:84-95): the
    routes' neighborhoods differ, and through 11 blocks of random weights so
    do their descriptors (printed).  The checks: per level, the share of the
    exact conv lists' entries that the tiled lists hold, at least 0.95, the
    JAX package's validated floor, and 1.0 where the tiled search falls back
    to the dense one (a level of no more tiles than ``search_m_tiles``); and
    the share of the tiled conv lists' entries that the dense lists hold
    where they have room, at least 0.999, so a dense search that loses
    neighbors fails.
    The pool searches (coarser queries, so wider query groups) and the k = 1
    upsample (4 candidate tiles) find fewer; their shares are printed (the
    JAX package measured neither)."""
    import torch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg

    outs = {}
    with torch.no_grad():
        for name, cfg in (("tiled", cfg_tiled), ("dense", cfg_dense)):
            pyr, overflow = build_pyramid_cfg(cfg, batch.points[0], batch.masks[0],
                                              with_overflow=True)
            check(int(overflow.max()) <= 0, f"[routes-dense] {name} pyramid drops voxels")
            outs[name] = (init_kpfcnn(cfg, seed=0, device="cuda")(pyr, batch.features[0]), pyr)
    (ref, pt), (out, pd) = outs["tiled"], outs["dense"]
    mask = batch.masks[0]
    cos = (out["feats_f"] * ref["feats_f"]).sum(-1)[mask]
    diffs = {k: float((out[k] - ref[k]).abs().max()) for k in ("scores_overlap", "scores_saliency")}
    levels = len(pt.points)
    perms = [[_level_perm(pt.points[l][c], pt.masks[l][c], pd.points[l][c], pd.masks[l][c])
              for c in range(2)] for l in range(levels)]
    tile, m_tiles = cfg_tiled.budgets.search_tile, cfg_tiled.budgets.m_tiles_at
    rows = []
    for lvl in range(levels):
        conv = _neighbor_recall(pt.neighbors[lvl], pd.neighbors[lvl], perms[lvl], perms[lvl])
        pool = up = None
        if lvl + 1 < levels:
            pool = _neighbor_recall(pt.pools[lvl], pd.pools[lvl], perms[lvl + 1], perms[lvl])
            up = _neighbor_recall(pt.upsamples[lvl], pd.upsamples[lvl], perms[lvl],
                                  perms[lvl + 1])
        exact = -(-pt.points[lvl].shape[1] // tile) <= m_tiles(lvl)
        held = _tiled_in_dense(pt.neighbors[lvl], pd.neighbors[lvl], perms[lvl], perms[lvl])
        rows.append((lvl, conv, pool, up, exact, held))
    print("[routes-dense] neighbor recall of the tiled route against the exact dense search, "
          "by level (conv / pool / k=1 upsample): " + "; ".join(
              f"L{l} {c:.4f} / {'-' if p is None else f'{p:.4f}'} / "
              f"{'-' if u is None else f'{u:.4f}'}{' (dense fallback)' if e else ''}"
              for l, c, p, u, e, _ in rows), flush=True)
    print("[routes-dense] share of the tiled conv lists' entries that the dense lists hold "
          "(rows with room), by level: " + ", ".join(f"L{r[0]} {r[5]:.6f}" for r in rows),
          flush=True)
    print(f"[routes-dense] descriptors of the two routes (different neighborhoods, random "
          f"weights): cosine min {float(cos.min()):.4f}, median {float(cos.median()):.4f}; "
          f"max |d| " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    for lvl, conv, _, _, exact, held in rows:
        check(conv >= 0.95, f"[routes-dense] level {lvl} conv recall {conv}")
        check(held >= 0.999, f"[routes-dense] level {lvl}: the dense lists miss "
                             f"{1 - held:.2e} of the tiled lists' neighbors")
        check(exact is False or conv == 1.0, f"[routes-dense] level {lvl}: the dense fallback "
                                             f"differs from the dense route ({conv})")


def phase_dense(batch):
    """[path-dense], [train-dense], [routes-dense]: ``search_impl: dense``
    at full width: the reference's raster-order subsample and dense radius
    searches (no K1), the untiled KPConv route (K6 / K7 forward, K3's
    gathered entry backward, no K2 or K5), the loss's dense searches; then
    [kernels-dense]: the K6 and K7 calls of a serving forward and the K3
    gathered calls of a train_step on that route held against their plain
    versions, and [agree-dense]: the CUDA path against the CPU path there
    at the tiny widths."""
    import dataclasses
    import torch
    import pcrcg_tpu_torch.ops.kpconv_fused as kf_mod
    from pcrcg_tpu_torch.config import Config
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.ops.kpconv_fused import (
        kpconv_fused, kpconv_fused_merged, kpconv_fused_merged_plain, kpconv_fused_plain,
    )
    from pcrcg_tpu_torch.ops.pyramid import build_pyramid_cfg
    from pcrcg_tpu_torch.train.state import TrainState

    base = Config()
    cfg = base.replace(budgets=dataclasses.replace(base.budgets, search_impl="dense"))
    model = init_kpfcnn(cfg, seed=0, device="cuda")
    phase_path(cfg, batch, model, "path-dense", {"K1": 0, "K2": 0, "K6": 8, "K7": 3, "K8": 0})

    def forward():
        with torch.no_grad():
            model(build_pyramid_cfg(cfg, batch.points[0], batch.masks[0]), batch.features[0])

    calls = record_calls(forward, {"K6": (kf_mod, "kpconv_fused"),
                                   "K7": (kf_mod, "kpconv_fused_merged")})
    _gathered_conv_phase("K6", calls["K6"], kpconv_fused, kpconv_fused_plain, FULL_SHAPES,
                         tag="kernels-dense")
    _gathered_conv_phase("K7", calls["K7"], kpconv_fused_merged, kpconv_fused_merged_plain,
                         FULL_SHAPES[1:4], tag="kernels-dense")
    del model, calls
    state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    calls = record_gathered_backward_inputs(cfg, batch, state, gen)
    check(len(calls["K3g"]) == 11, "[kernels-dense] K3 gathered: expected 11 calls")
    phase_k3g(calls["K3g"], tag="kernels-dense")
    del calls
    torch.cuda.empty_cache()
    phase_train(cfg, batch, state, "train-dense", launched=("K3", "K6", "K7"),
                idle=("K1", "K2", "K4", "K5", "K8"), per_step={"K6": 8, "K7": 3, "K3": 11})
    del state
    torch.cuda.empty_cache()
    phase_routes_dense(batch, base, cfg)
    # Serving only: on this route at the tiny widths a change of 3e-7 of the
    # largest entry in K6's or K7's outputs (the distance of their plain
    # versions from float64) moves the CPU path's gradients 1.8 to 46 times
    # [agree-train]'s bounds on each of six crops tried (a near-tied
    # choice flips; a CPU rehearsal), so the CUDA path cannot be held to
    # the CPU path's gradients there.
    phase_agree("agree-dense", budgets=_agree_budgets(search_impl="dense"))


def phase_dp(work):
    """[dp]: ``train_step_dp`` over two ranks of ``torch.distributed`` that
    share the one card (``parallel/launch.py::dp_steps``), ``Config()`` at
    full width, a global batch of 2 pairs (the assets pair and a crop of
    it), a pair a rank, 3 steps.  Rank 0's stats and parameters after step 1
    against a single-process ``train_step`` on the same batch, weights and
    draws on the card (loss terms rtol 1e-4; parameters rtol 5e-4, atol
    5e-5, as tests/test_parallel.py: K3's and K5's atomics vary in the last
    bits); K1-K5 launched in each rank.  Then a one-rank NCCL group runs
    ``main.py`` for an epoch of a fixture split: ``initialize``, the NCCL
    path and rank 0's checkpoints on the card."""
    import math
    import numpy as np
    import torch
    import yaml
    from pcrcg_tpu_torch import main as tmain
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose, write_indoor_fixture
    from pcrcg_tpu_torch.config import Config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.parallel import launch
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import train_step

    cfg = Config()
    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    n0 = cfg.budgets.points[0]
    batch = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans),
                             _overlap_crop(16000, 12000)], n0)
    state_dict = init_kpfcnn(cfg, seed=1, device="cpu").state_dict()
    gen = torch.Generator().manual_seed(3)
    uniforms = [torch.rand(2, n0 * cfg.budgets.corr_k, generator=gen) for _ in range(3)]
    payload = work / "dp.pt"
    torch.save(dict(cfg=cfg, state_dict=state_dict, batch=batch, uniforms=uniforms), payload)
    print("[dp] 2 ranks on the 1 card: NCCL takes one rank a card, so the group runs gloo "
          "over CUDA tensors (its all_reduce goes through the host), chosen by name",
          flush=True)
    t0 = time.perf_counter()
    launch.spawn(launch.dp_steps, 2, args=(str(payload), str(work / "dp_out")),
                 init_method=f"file://{work / 'dp.rendezvous'}", device="cuda", backend="gloo",
                 timeout=300)
    wall = time.perf_counter() - t0
    outs = [torch.load(work / f"dp_out.rank{r}", weights_only=False) for r in (0, 1)]

    state = TrainState(cfg, init_kpfcnn(cfg, seed=1, device="cuda"))
    want = train_step(state, cfg, batch.map(lambda t: t.cuda()), uniforms=uniforms[0].cuda())
    want = {k: float(v) for k, v in want.items()}
    got = outs[0]["stats"][0]
    stat_rel = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    worst, worst_name = 0.0, ""
    for name, p in state.model.state_dict().items():
        a, b = outs[0]["params"][name].double(), p.detach().cpu().double()
        excess = float(((a - b).abs() - (5e-5 + 5e-4 * b.abs())).max())
        if excess > worst or not worst_name:
            worst, worst_name = excess, name
    ranks_equal = all(torch.equal(outs[0]["params"][k], outs[1]["params"][k])
                      for k in outs[0]["params"])
    ms = [float(np.mean(o["ms"][1:])) for o in outs]
    print(f"[dp] {len(uniforms)} steps of a 2-pair global batch in {wall:.1f} s with start-up; "
          f"ms a dp step (steps 2-3, host clock, two ranks sharing the card): "
          f"{ms[0]:.1f} / {ms[1]:.1f}; launches a step by rank: "
          + "; ".join(" ".join(f"{k} {v / len(uniforms):g}" for k, v in o["launches"].items())
                      for o in outs)
          + f"; step 1 vs single-process: loss terms max relative difference {stat_rel:.2e} "
          f"(total {got['total']:.6f} vs {want['total']:.6f}), parameters worst excess over "
          f"rtol 5e-4 / atol 5e-5 {worst:.2e} ({worst_name}); the ranks' parameters "
          f"{'bit-identical' if ranks_equal else 'DIFFER'}", flush=True)
    check(all(o["backend"] == "gloo" for o in outs), "[dp] backend")
    check(stat_rel <= 1e-4, f"[dp] loss terms differ from the single-process step: {stat_rel}")
    check(worst <= 0.0, f"[dp] parameters differ from the single-process step: {worst_name}")
    check(ranks_equal, "[dp] the ranks' parameters differ")
    check(all(math.isfinite(s["total"]) for o in outs for s in o["stats"]), "[dp] loss not finite")
    for o in outs:
        check(all(o["launches"][k] > 0 for k in ("K1", "K2", "K3", "K4", "K5")),
              f"[dp] rank {o['rank']}: a kernel never launched: {o['launches']}")
    del state
    torch.cuda.empty_cache()

    tr = write_indoor_fixture(work / "fixture", 4, seed=1, split="train")
    va = write_indoor_fixture(work / "fixture", 2, seed=2, split="val")
    path = work / "dp_main.yaml"
    with open(path, "w") as f:
        yaml.safe_dump({"model": dict(root=tr["root"], train_info=tr["info"],
                                      val_info=va["info"], exp_dir=str(work / "dp_exp"),
                                      max_epoch=1, num_workers=2, verbose_freq=1)}, f)
    t0 = time.perf_counter()
    launch.spawn(tmain.main, 1, f"file://{work / 'main.rendezvous'}",
                 args=(["--config", str(path)],), device="cuda", timeout=300)
    wall = time.perf_counter() - t0
    files = sorted(p.name for p in (work / "dp_exp" / "checkpoints").iterdir())
    with open(work / "dp_exp" / "scalars.jsonl") as f:
        losses = [json.loads(line)["total"] for line in f if '"total"' in line]
    print(f"[dp] main.py in a one-rank NCCL group: an epoch of 4 train and 2 val pairs in "
          f"{wall:.1f} s with start-up, checkpoints {files}, {len(losses)} logged totals",
          flush=True)
    check({"epoch_0.ckpt", "best_loss.ckpt"} <= set(files), f"[dp] checkpoints: {files}")
    check(losses and all(math.isfinite(v) for v in losses), "[dp] a logged loss is not finite")


def slice12(repo):
    """Phases 23-25: slice 12's paths."""
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
    from pcrcg_tpu_torch.config import Config
    from pcrcg_tpu_torch.data.pair import make_pair_batch

    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    batch = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)],
                            Config().budgets.points[0], device="cuda")
    phase_deformable(batch)
    torch.cuda.empty_cache()
    phase_dense(batch)
    torch.cuda.empty_cache()
    work = repo / "build" / "chip_smoke_dp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        phase_dp(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_kernels_cloud(cfg, batch):
    """[kernels-cloud]: the kernels as a rank of the cloud axis launches
    them, one cloud a launch (B = 1).  K1 in the 9 searches of the assets
    pair's source cloud's pyramid at ``Config()``, against its plain chain
    (idx and lidx equal); K2 in that cloud's encoder, K3 with K4's scatter
    and K5 in its backward (of Σ x·r over the bottleneck features, r
    seeded), against their plain versions at the tolerances of [kernels];
    each timed with its bound, as there."""
    import torch
    import pcrcg_tpu_torch.ops.kpconv_tiled as kt_mod
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn

    model = init_kpfcnn(cfg, seed=1, device="cuda")
    points, masks, feats = batch.points[0][:1], batch.masks[0][:1], batch.features[0][:1]
    with recording_k1([(pyramid_mod, "radius_search_tiled_batch")]) as k1_calls:
        pyramid = pyramid_mod.build_pyramid_cfg(cfg, points, masks)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def run():
        with torch.enable_grad():
            x = model.encode(pyramid, feats)[0]
            (x * torch.randn(x.shape, generator=gen, device="cuda")).sum().backward()

    calls = record_calls(run, {"K2": (kt_mod, "kpconv_tiled"), "K3": (kt_mod, "kpconv_tiled_bwd"),
                               "K5": (kt_mod, "maxpool_bwd")})
    counts = dict(K1=len(k1_calls), **{k: len(v) for k, v in calls.items()})
    print(f"[kernels-cloud] one cloud (B = 1, {int(masks.sum())} points): recorded "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + " calls (its pyramid; its encoder's forward and backward)", flush=True)
    check(counts == dict(K1=9, K2=11, K3=11, K5=3), f"[kernels-cloud] calls: {counts}")
    check(all(a[7] == 1 for _, a in k1_calls), "[kernels-cloud] a K1 call stacks two clouds")
    results = dict(K1=phase_k1(k1_calls, tag="kernels-cloud"),
                   K2=phase_k2(calls["K2"], tag="kernels-cloud"))
    results["K3"] = phase_k3_k4(calls["K3"], tag="kernels-cloud")[0]
    results["K5"] = phase_k5(calls["K5"], tag="kernels-cloud")
    del calls, k1_calls, pyramid, model
    torch.cuda.empty_cache()
    print("[kernels-cloud] " + "; ".join(
        f"{k} {r['ms']:.4f} ms over {counts[k]} calls, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms" for k, r in results.items()),
        flush=True)
    return results


# Parameter groups by name prefix; the rest are the heads.
CLOUD_GROUPS = {"encoder_blocks.": "encoder", "gnn.": "GCN", "decoder_blocks.": "decoder"}


def phase_cloud(tag, work, cfg, batch, state_dict, uniforms, images=None):
    """[cloud*]: ``train_step_dp`` on the cloud axis (``make_mesh(n_data,
    2)``, ``parallel/launch.py::dp_steps``): ``2 · n_data`` gloo ranks
    sharing the card (NCCL takes a card a rank), a pair a data row, one step
    per entry of ``uniforms``.  Rank 0's stats and parameters after step 1
    against a single-process ``train_step`` on the same batch, weights and
    draws on the card (loss terms rtol 1e-4; parameters rtol 5e-4 / atol
    5e-5, the worst of each group apart: encoder, GCN, decoder, heads);
    every rank's parameters bit-identical; K1-K5 launched in every rank; a
    frozen backbone unchanged.  Prints ms a step (host clock, steps 2 on)
    and peak GiB a rank."""
    import math
    import numpy as np
    import torch
    from pcrcg_tpu_torch.models.kpfcnn import KPFCNN
    from pcrcg_tpu_torch.models.pcrcg import PCRCG
    from pcrcg_tpu_torch.parallel import launch
    from pcrcg_tpu_torch.train.state import TrainState
    from pcrcg_tpu_torch.train.step import train_step

    n_data = batch.points.shape[0]
    world = 2 * n_data
    payload = work / f"{tag}.pt"
    torch.save(dict(cfg=cfg, state_dict=state_dict, batch=batch, uniforms=uniforms,
                    images=images, n_model=2), payload)
    t0 = time.perf_counter()
    launch.spawn(launch.dp_steps, world, args=(str(payload), str(work / tag)),
                 init_method=f"file://{work / (tag + '.rendezvous')}", device="cuda",
                 backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    outs = [torch.load(work / f"{tag}.rank{r}", weights_only=False) for r in range(world)]

    model = (PCRCG if cfg.image_feature else KPFCNN)(cfg)
    model.load_state_dict(state_dict)
    state = TrainState(cfg, model.cuda().eval())
    kw = {} if images is None else dict(images={k: v.cuda() for k, v in images.items()})
    want = train_step(state, cfg, batch.map(lambda t: t.cuda()), uniforms=uniforms[0].cuda(),
                      **kw)
    want = {k: float(v) for k, v in want.items()}
    got = outs[0]["stats"][0]
    stat_rel = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    worst = {}
    frozen_same = True
    for name, p in state.model.state_dict().items():
        a, b = outs[0]["params"][name].double(), p.detach().cpu().double()
        if name.startswith("lift."):
            frozen_same &= torch.equal(outs[0]["params"][name], state_dict[name])
            continue
        short = name.removeprefix("kpfcnn.")
        group = next((g for p, g in CLOUD_GROUPS.items() if short.startswith(p)), "heads")
        excess = float(((a - b).abs() - (5e-5 + 5e-4 * b.abs())).max())
        if group not in worst or excess > worst[group][0]:
            worst[group] = (excess, name)
    ranks_equal = all(torch.equal(o["params"][k], outs[0]["params"][k])
                      for o in outs[1:] for k in outs[0]["params"])
    stats_equal = all(o["stats"] == outs[0]["stats"] for o in outs[1:])
    steps = len(uniforms)
    # The single-process step alone on the card, warm, for scale.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u in uniforms[1:] or uniforms:
        train_step(state, cfg, batch.map(lambda t: t.cuda()), uniforms=u.cuda(), **kw)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / len(uniforms[1:] or uniforms)
    ms = [float(np.mean(o["ms"][1:] or o["ms"])) for o in outs]
    print(f"[{tag}] {world} ranks ({n_data} x 2) on the 1 card, gloo over CUDA tensors: "
          f"{steps} steps of a {n_data}-pair batch in {wall:.1f} s with start-up; ms a step "
          f"({'steps 2-' + str(steps) if steps > 1 else 'its one step, warm-up included'}, "
          "host clock): " + " / ".join(f"{m:.1f}" for m in ms)
          + f" (the single-process step alone, warm: {single_ms:.1f})"
          + "; peak GiB a rank: " + " / ".join(f"{o['peak_gib']:.2f}" for o in outs)
          + "; exchanges a step by rank: "
          + "; ".join(" ".join(f"{k} {v / steps:g}" for k, v in o["exchanges"].items())
                      for o in outs)
          + "; launches a step by rank: "
          + "; ".join(" ".join(f"{k} {v / steps:g}" for k, v in o["launches"].items())
                      for o in outs)
          + f"; step 1 vs single-process: loss terms max relative difference {stat_rel:.2e} "
          f"(total {got['total']:.6f} vs {want['total']:.6f}); parameters' worst excess over "
          f"rtol 5e-4 / atol 5e-5 by group: "
          + ", ".join(f"{g} {e:.2e} ({n})" for g, (e, n) in worst.items())
          + f"; the ranks' parameters {'bit-identical' if ranks_equal else 'DIFFER'}, their "
          f"stats {'bit-identical' if stats_equal else 'differ in the last bits'}"
          + ("" if images is None else
             f"; backbone2d {'unchanged' if frozen_same else 'CHANGED'}"), flush=True)
    check(all(o["backend"] == "gloo" and o["n_model"] == 2 for o in outs), f"[{tag}] mesh")
    check(stat_rel <= 1e-4, f"[{tag}] loss terms differ from the single-process step: {stat_rel}")
    check(set(worst) == {*CLOUD_GROUPS.values(), "heads"}, f"[{tag}] parameter groups: {worst}")
    for group, (excess, name) in worst.items():
        check(excess <= 0.0, f"[{tag}] {group} parameters differ from the single-process step: "
                             f"{name} {excess}")
    check(ranks_equal, f"[{tag}] the ranks' parameters differ")
    check(frozen_same, f"[{tag}] the frozen backbone moved")
    check(all(math.isfinite(s["total"]) for o in outs for s in o["stats"]),
          f"[{tag}] loss not finite")
    for o in outs:
        check(all(o["launches"][k] > 0 for k in ("K1", "K2", "K3", "K4", "K5")),
              f"[{tag}] rank {o['rank']}: a kernel never launched: {o['launches']}")
    del state, model
    torch.cuda.empty_cache()
    return dict(ms=ms, single_ms=single_ms, peak_gib=[o["peak_gib"] for o in outs],
                launches=[{k: v / steps for k, v in o["launches"].items()} for o in outs])


def slice13(repo):
    """Phases 26-29: the cloud ('model') mesh axis."""
    import torch
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose, render_pair_images
    from pcrcg_tpu_torch.config import Config, load_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.models.pcrcg import init_pcrcg

    cfg = Config()
    n0 = cfg.budgets.points[0]
    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    pair = dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)
    batch = make_pair_batch([pair], n0)
    phase_kernels_cloud(cfg, batch.map(lambda t: t.cuda()))

    work = repo / "build" / "chip_smoke_cloud"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = torch.Generator().manual_seed(3)
    draws = lambda b, n: [torch.rand(b, n0 * cfg.budgets.corr_k, generator=gen)  # noqa: E731
                          for _ in range(n)]
    try:
        state_dict = init_kpfcnn(cfg, seed=1, device="cpu").state_dict()
        phase_cloud("cloud", work, cfg, batch, state_dict, draws(1, 3))
        batch2 = make_pair_batch([pair, _overlap_crop(16000, 12000)], n0)
        phase_cloud("cloud-dp", work, cfg, batch2, state_dict, draws(2, 2))
        cfg_i = load_config(str(repo / "configs" / "train" / "indoor.yaml"))
        batch_i = make_pair_batch([pair], cfg_i.budgets.points[0],
                                  in_feats_dim=cfg_i.in_feats_dim)
        images = render_pair_images(src, tgt, cfg_i.img_num, pose=(rot, trans))
        images = {k: torch.as_tensor(v)[None] for k, v in images.items()}
        state_dict = init_pcrcg(cfg_i, seed=1, device="cpu").state_dict()
        phase_cloud("cloud-images", work, cfg_i, batch_i, state_dict, draws(1, 1), images)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def earlier_slices(repo):
    """Phases 2-22: the paths of slices 1-11.  Returns the kernels' numbers
    (per kernel id), their launches on their routes ([train]: K1-K5;
    [train-untiled]: K6, K7, K3's gathered entry; [path-reduce]: K8) and
    the device busy ms of a KITTI and a ModelNet pair and step."""
    import torch
    import pcrcg_tpu_torch.losses as losses_mod
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose, render_pair_images
    from pcrcg_tpu_torch.config import Config, load_config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.models.lift import images_to
    from pcrcg_tpu_torch.models.pcrcg import init_pcrcg
    from pcrcg_tpu_torch.train.state import TrainState


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
    swapped = make_pair_batch([dict(src_pcd=tgt, tgt_pcd=src, rot=rot, trans=trans)],
                              cfg_i.budgets.points[0], in_feats_dim=cfg_i.in_feats_dim,
                              device="cuda")
    phase_pyramid_graph("indoor.yaml", cfg_i, [(b.points[0], b.masks[0])
                                               for b in (batch_i, swapped)])
    del swapped
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
        kitti_ms = phase_kitti(repo, work)
        modelnet_ms = phase_modelnet(repo, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # Launches on each kernel's route: [train] (K1-K5), [train-untiled] (K6,
    # K7, K3's gathered entry), [path-reduce] (K8).
    launches.update(K3g=untiled_launches["K3"], K6=untiled_launches["K6"],
                    K7=untiled_launches["K7"], K8=reduce_launches["K8"])
    return results, launches, kitti_ms, modelnet_ms


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

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    try:
        phase_build()
        results, launches, kitti_ms, modelnet_ms = earlier_slices(repo)
        slice12(repo)
        slice13(repo)
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
    print(f"[done] {time.perf_counter() - t_start:.1f} s; device busy ms a pair / a step: KITTI "
          f"{kitti_ms['pair']:.2f} / {kitti_ms['step']:.2f}, ModelNet {modelnet_ms['pair']:.2f} / "
          f"{modelnet_ms['step']:.2f}", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
