"""A tiny benchmark tree for the CPU tests: the harness's own code with
small configurations, traffic and cells written as files under a
temporary root, the way a later change adds them."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

PERFBENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(PERFBENCH.parent))

COLOR = {
    "model": {"dataset": "indoor", "image_feature": True, "in_feats_dim": 17,
              "first_feats_dim": 32, "gnn_feats_dim": 32, "final_feats_dim": 8,
              "first_subsampling_dl": 0.025, "backbone2d_depth": 18, "backbone2d_channels": 16,
              "img_num": 2, "pos_radius": 0.0375, "safe_radius": 0.1, "overlap_radius": 0.0375,
              "matchability_radius": 0.05, "max_points": 64},
    "optimiser": {"optimizer": "SGD", "lr": 0.005, "momentum": 0.98, "weight_decay": 1e-6},
    "tpu": {"budgets": {"points": [512, 256, 192, 96], "neighbors": [16, 16, 16, 16],
                        "corr_k": 8, "query_chunk": 64, "search_tile": 32,
                        "search_m_tiles": 4}},
}
GEOMETRY = json.loads(json.dumps(COLOR))
GEOMETRY["model"].update(image_feature=False, in_feats_dim=1, dataset="kitti",
                         first_subsampling_dl=0.3, pos_radius=0.21, safe_radius=0.75,
                         overlap_radius=0.45, matchability_radius=0.3)
TRAFFIC = {
    "tiny_frag": {"kind": "fragment_pairs", "pairs": 3, "keep": [0.7, 1.0], "img_num": 2,
                  "height": 64, "width": 80, "max_points": 500},
    "tiny_lidar": {"kind": "lidar_drive", "pairs": 3, "range_m": 30.0, "rays": 3000,
                   "voxel": 1.5},
}
REGISTER_LIMITS = {"pyramid_mismatch": 0.0, "feats_gap": 1e-4, "scores_gap": 1e-4,
                   "rot_gap": 1e-5, "trans_gap_m": 1e-5, "lift_gap": 1e-4}
TRAIN_LIMITS = {"first_loss_gap": 1e-3, "later_loss_gap": 1e-2, "grad_gap": 1e-2,
                "change_gap": 0.3}
CELLS = {
    "tc.register": ("tiny_color", "tiny_frag", "register"),
    "tg.register": ("tiny_geometry", "tiny_lidar", "register"),
    "tg.train": ("tiny_geometry", "tiny_lidar", "train"),
}


IGNORE = shutil.ignore_patterns("__pycache__")


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_tree(root: Path) -> Path:
    """A root holding the tiny cells (and the benchmark's modes,
    generators and metric readers), with a BENCHMARK.json listing them."""
    write_json(root / "configs" / "tiny_color.json", COLOR)
    write_json(root / "configs" / "tiny_geometry.json", GEOMETRY)
    for name, params in TRAFFIC.items():
        write_json(root / "traffic" / f"{name}.json", params)
    for name, (config, traffic, mode) in CELLS.items():
        cell = {"config": config, "traffic": traffic, "mode": mode, "trace_units": 2,
                "limits": REGISTER_LIMITS if mode == "register" else TRAIN_LIMITS}
        if mode == "train":
            cell["steps_per_epoch"] = 1000
        write_json(root / "workloads" / f"{name}.json", cell)
    for part in ("metrics", "modes"):
        shutil.copytree(PERFBENCH / part, root / part, ignore=IGNORE)
    shutil.copytree(PERFBENCH / "traffic", root / "traffic", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("*.json", "__pycache__"))
    spec = json.loads((PERFBENCH.parent / "BENCHMARK.json").read_text())
    rename = {"pcrcg_3dmatch.register": "tc.register", "pcrcg_kitti.register": "tg.register",
              "pcrcg_kitti.train": "tg.train"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"] if w in rename]
    spec["workloads"] = [{**w, "name": rename[w["name"]]} for w in spec["workloads"]
                         if w["name"] in rename]
    write_json(root / "BENCHMARK.json", spec)
    return root


def run_cell(root: Path, cell: str, capsys, trace: int = 0, seed: int = 2147483651) -> dict:
    """One CPU run of a tiny cell; its result line."""
    from perfbench.core.harness import run

    torch.set_num_threads(2)
    rc = run(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace",
              str(trace)], root=root, repo_root=root, device="cpu")
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
