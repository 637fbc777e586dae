#!/usr/bin/env python3
"""Side-by-side device times of K1 and K8 against variants of their sources.

    python3 kernel_variants.py [--out chiprun_out/variants.json]

Each variant is the kernel's source in ``pcrcg_tpu_torch/csrc/`` with one
design choice changed by a text edit (the script stops if an edit no longer
applies), built by ``nvcc`` with the kernels' flags into the git-ignored
``build/pcrcg_tpu_torch/variants/``.  All variants run on the inputs the
full-width serving path gives the kernel (the assets pair, ``Config()``,
seeded random weights): K1's 9 searches of one pyramid, K8's 10 calls on
the ``reduce`` route.  Each variant is timed twice, in turn, with
``chip_smoke.time_ms`` (device time of back-to-back calls).  K1's
variants must give idx and lidx equal to the plain chain (except
``no_rank``, a diagnostic that skips the ranking); K8's must stay within
1e-5 relative of the plain version with nn equal.  It also prints the
level-0 conv search's counts of candidates within the radius.  Needs CUDA
and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = REPO / "pcrcg_tpu_torch" / "csrc"

_RANK_START = "    __syncwarp();\n    for (int e = lane; e < cnt; e += 32) {"
_RANK_END = "    for (int s = cnt + lane; s < k; s += 32) emit(s, cand);\n"

K1_VARIANTS = {
    "kernel": [],
    "steps_1": [("constexpr int kSteps = 2;", "constexpr int kSteps = 1;")],
    "steps_4": [("constexpr int kSteps = 2;", "constexpr int kSteps = 4;")],
    "blocks_4": [("< 8LL * sms", "< 4LL * sms")],
    "blocks_16": [("< 8LL * sms", "< 16LL * sms")],
    "no_split": [("< 8LL * sms) qpb /= 2;", "< 0LL) qpb /= 2;")],
    "no_rank": "no_rank",  # the ranking and the writes replaced by one store
}

# The neighbor count's sums added across a query's lanes by a shuffle
# butterfly inside the walk, one slot a warp and neighbor, instead of one
# slot a thread.
_SHUFFLE_COUNTS = [
    ("  float* my_slots = slots + (size_t)tid * pitch;\n",
     "  const int sub = tpq < 32 ? tpq : 32;\n"
     "  float* my_part = slots + ((size_t)qa * (tpq / sub) + lq / sub) * h_count;\n"
     "  const bool leader = lq % sub == 0;\n"),
    ("      const float s = ((f[0] + f[1]) + f[2]) + f[3];\n"
     "      my_slots[h] = pass == 0 ? s : my_slots[h] + s;",
     "      float s = ((f[0] + f[1]) + f[2]) + f[3];\n"
     "      for (int off = sub / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);\n"
     "      if (leader) my_part[h] = pass == 0 ? s : my_part[h] + s;"),
    ("    const float* qs = slots + (size_t)qi * tpq * pitch + h;\n"
     "    float s = qs[0];\n"
     "    for (int u = 1; u < tpq; ++u) s += qs[(size_t)u * pitch];",
     "    const int parts = tpq < 32 ? 1 : tpq / 32;\n"
     "    const float* qs = slots + (size_t)qi * parts * h_count + h;\n"
     "    float s = qs[0];\n"
     "    for (int u = 1; u < parts; ++u) s += qs[(size_t)u * h_count];"),
]

K8_VARIANTS = {
    "kernel": [],
    "unroll_2": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 2;")],
    "unroll_4": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")],
    "shuffle_counts": _SHUFFLE_COUNTS,
}

_C = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def variant_source(src: str, edits) -> str:
    if edits == "no_rank":
        a, b = src.index(_RANK_START), src.index(_RANK_END) + len(_RANK_END)
        return src[:a] + "    if (lane == 0) lidx[row * k] = cnt;\n" + src[b:]
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant edit no longer applies: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(variants, source, tag, out_dir):
    """Compile every variant at once; -> {name: ctypes.CDLL}."""
    from pcrcg_tpu_torch import kernels

    src = (CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        cu = out_dir / f"{tag}_{name}.cu"
        cu.write_text(variant_source(src, edits))
        so = cu.with_suffix(".so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {tag} {name}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"  {tag} {name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib, fn_name, signature):
    fn = getattr(lib, fn_name)
    fn.argtypes = [_C[ch] for ch in signature]
    fn.restype = ctypes.c_int
    return fn


def run_k1(libs, calls, time_ms, stream):
    import torch
    from pcrcg_tpu_torch.ops.search_kernel import tiled_search_plain

    prepared = []
    for _, a in calls:
        q, supa, sel, k, r2, nq, ns, b = a
        idx = torch.empty(b, nq, k, device=q.device, dtype=torch.int64)
        lidx = torch.empty(b, sel.shape[0] // b * 128, k, device=q.device, dtype=torch.int32)
        prepared.append((a, idx, lidx, tiled_search_plain(*a)))
    results = {}
    for rep in range(2):
        for name, lib in libs.items():
            fn = bind(lib, "pcrcg_tiled_search", "pppiiiiiiiifipppp")
            per, equal = [], True
            for a, idx, lidx, (want_idx, want_lidx) in prepared:
                q, supa, sel, k, r2, nq, ns, b = a
                args = (q.data_ptr(), supa.data_ptr(), sel.data_ptr(), sel.shape[0],
                        sel.shape[0] // b, sel.shape[1], supa.shape[2], supa.shape[0] // b, nq,
                        ns, k, float(r2), 1 if k == 1 else 0, idx.data_ptr(), lidx.data_ptr(),
                        None, stream)
                if fn(*args) != 0:
                    raise SystemExit(f"K1 {name}: launch failed")
                torch.cuda.synchronize()
                equal &= torch.equal(idx, want_idx) and torch.equal(lidx, want_lidx)
                per.append(time_ms(lambda: fn(*args), iters=20))
            if name != "no_rank" and not equal:
                raise SystemExit(f"K1 {name}: idx or lidx differ from the plain chain")
            results.setdefault(name, []).append(per)
            print(f"K1 {name:10s} run {rep}: {sum(per):.4f} ms over {len(per)} calls "
                  f"(level 0 {per[0]:.4f}), equal {equal}", flush=True)
    return results


def run_k8(libs, calls, time_ms, stream):
    import torch
    from pcrcg_tpu_torch.ops.kpconv_common import INFLUENCE
    from pcrcg_tpu_torch.ops.kpconv_pallas import kpconv_weighted_reduce_plain

    prepared = []
    for a, kw in calls:
        rel, nx, kp, extent = a[:4]
        influence = a[4] if len(a) > 4 else kw.get("influence", "linear")
        n, h, c = nx.shape
        out = (torch.empty(kp.shape[0], n, c, device=nx.device),
               torch.empty(n, device=nx.device))
        args = (rel.data_ptr(), nx.data_ptr(), n, h, c, kp.data_ptr(), kp.shape[0],
                float(extent), float(2.0 * (extent * 0.3) ** 2 + 1e-9), INFLUENCE[influence],
                out[0].data_ptr(), out[1].data_ptr(), stream)
        prepared.append((args, out, kpconv_weighted_reduce_plain(*a, **kw)))
    results = {}
    for rep in range(2):
        for name, lib in libs.items():
            fn = bind(lib, "pcrcg_kpconv_weighted_reduce", "ppiiipiffippp")
            per = []
            for args, (w, nn), (want_w, want_nn) in prepared:
                if fn(*args) != 0:
                    raise SystemExit(f"K8 {name}: launch failed")
                torch.cuda.synchronize()
                rel = float((w - want_w).abs().max()) / max(float(want_w.abs().max()), 1e-12)
                if rel > 1e-5 or not torch.equal(nn, want_nn):
                    raise SystemExit(f"K8 {name}: differs from the plain version ({rel})")
                per.append(time_ms(lambda: fn(*args), iters=20))
            results.setdefault(name, []).append(per)
            print(f"K8 {name:14s} run {rep}: {sum(per):.4f} ms over {len(per)} calls "
                  f"(call 0 {per[0]:.4f})", flush=True)
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import pcrcg_tpu_torch.ops.kpconv_pallas as kr_mod
    import pcrcg_tpu_torch.ops.pyramid as pyramid_mod
    from pcrcg_tpu_torch import kernels
    from pcrcg_tpu_torch.assets import demo_cloud_pair, demo_pair_gt_pose
    from pcrcg_tpu_torch.config import Config
    from pcrcg_tpu_torch.data.pair import make_pair_batch
    from pcrcg_tpu_torch.models.kpfcnn import init_kpfcnn
    from pcrcg_tpu_torch.ops.search_kernel import tiled_candidate_distances_plain

    torch.set_grad_enabled(False)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(card, flush=True)
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    k1_libs = build(K1_VARIANTS, "search_distances", "k1", out_dir)
    k8_libs = build(K8_VARIANTS, "kpconv_reduce", "k8", out_dir)

    cfg = Config()
    src, tgt = demo_cloud_pair()
    rot, trans = demo_pair_gt_pose()
    batch = make_pair_batch([dict(src_pcd=src, tgt_pcd=tgt, rot=rot, trans=trans)],
                            cfg.budgets.points[0], device="cuda")
    with chip_smoke.recording_k1([(pyramid_mod, "radius_search_tiled_batch")]) as k1_calls:
        pyramid_mod.build_pyramid_cfg(cfg, batch.points[0], batch.masks[0])
    cfg_r = cfg.replace(kpconv_impl="reduce")
    model_r = init_kpfcnn(cfg_r, seed=0, device="cuda")
    k8_calls = chip_smoke.record_calls(
        lambda: model_r(pyramid_mod.build_pyramid_cfg(cfg_r, batch.points[0], batch.masks[0]),
                        batch.features[0]),
        {"K8": (kr_mod, "kpconv_weighted_reduce")})["K8"]

    q, supa, sel, _, r2 = k1_calls[0][1][:5]
    counts = (tiled_candidate_distances_plain(q, supa, sel) <= r2).sum(-1).float()
    quant = torch.quantile(counts, torch.tensor([0.5, 0.9, 0.99], device=counts.device)).tolist()
    stats = dict(mean=float(counts.mean()), p50=quant[0], p90=quant[1], p99=quant[2],
                 max=float(counts.max()))
    print("level-0 conv search, candidates within the radius a query: "
          + ", ".join(f"{k} {v:.1f}" for k, v in stats.items()), flush=True)

    stream = kernels.stream_handle(batch.points.device)
    res = dict(card=card, level0_in_radius=stats,
               K1=run_k1(k1_libs, k1_calls, chip_smoke.time_ms, stream),
               K8=run_k8(k8_libs, k8_calls, chip_smoke.time_ms, stream))
    if opts.out is not None:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
