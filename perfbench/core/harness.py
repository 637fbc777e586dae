"""One run of one cell: set-up, the timed window, (with ``--trace 1``) the
traced window, the check against the reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the process's start): the kernels found or
built under ``build/pcrcg_tpu_torch/`` in the checkout, the seeded weights
and the pool of pairs and draws made on the card, the cell's shapes warmed
up by its mode (``modes/<mode>.py``; ``register``: two pairs, ``train``:
the first three steps, which the check then follows).  Nothing compiles
inside the window.  The mode drives the window and names the end-to-end
metrics it measured; the harness reports those the cell lists.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared with its limit.  The
same numbers end standard error.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.core import check, files, trace, weights
from perfbench.core import work as unit_work
from perfbench.counts.work import FLOPS_PEAK
from perfbench.reference.pipeline import config_from_sections

FORBIDDEN = ("jax", "jaxlib", "flax", "pcrcg_tpu")


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's, flax's or
    the JAX package's, compared whole: ``pcrcg_tpu_torch`` is not
    ``pcrcg_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def sub_seed(seed: int, stream: int) -> int:
    """Independent streams of one run seed: weights 0, traffic 1, draws 2."""
    return (int(seed) * 8 + stream) % (2**63)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_name(device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Cell:
    """The program set up for one cell, ready for its window.  What is
    particular to the cell's mode (``modes/<mode>.py``) the mode does."""

    def __init__(self, cell: dict, seed: int, device, t0: float, root: Path = files.ROOT):
        from perfbench.core import program

        self.program = program
        self.cell = cell
        self.seed = seed
        self.device = device
        self.mode = files.mode_module(cell["mode"], root)
        if device.type == "cuda":
            program.build_kernels()
        self.cfg = program.port_config(cell["sections"])
        self.shapes = program.model_shapes(self.cfg)
        state = weights.seeded_state(self.shapes, sub_seed(seed, 0), device)
        self.model = program.build_model(self.cfg, state, device)
        del state
        self.pool = files.make_pool(cell["traffic_params"], sub_seed(seed, 1), device,
                                    images=self.cfg.image_feature, root=root)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
        self.draws = [self.mode.draws(self, s, gen) for s in self.pool]
        self.rng = random.Random(sub_seed(seed, 3))
        self.n_pool = len(self.pool)
        self.mode.setup(self)
        self.sync()
        self.setup_s = time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_unit(self, i: int):
        return self.mode.run_unit(self, i)

    def window(self, seconds: float) -> dict:
        return self.mode.window(self, seconds)

    def traced(self, units: int) -> dict:
        """The profiled units, the same units with their layers marked, and
        one unit's work counted from the shapes it sees."""
        p = self.program
        backward = self.mode.BACKWARD
        order = [(3 + k) % self.n_pool for k in range(units)]
        hooks = trace.KPConvHooks(p.kpconv_modules(self.model))
        red = trace.profile_units(self.run_unit, order, self.sync)
        hooks.remove()
        kp = unit_work.kpconv_calls(hooks.calls, backward)
        red["kpconv_roofline"] = unit_work.roofline_share(
            kp, red["kpconv_fwd_s"] + (red["kpconv_bwd_s"] if backward else 0.0), backward)
        del hooks
        marks = trace.StageMarks(self.sync)
        try:
            red["spans_ms"] = trace.staged_units(self.run_unit, order, marks,
                                                 self.mode.stage_marks(self, marks))
        finally:
            marks.remove()
        dense = unit_work.DenseHooks(self.model, p.kpfcnn_module(self.model, self.cfg))
        kp_hooks = trace.KPConvHooks(p.kpconv_modules(self.model))
        self.run_unit(order[0])
        self.sync()
        dense.remove()
        kp_hooks.remove()
        red["flops"] = unit_work.unit_flops(
            dense, unit_work.kpconv_calls(kp_hooks.calls, backward), self.cfg, backward)
        red["level_points"] = [[int(x) for x in m.sum(-1)] for m in dense.pyramid.masks]
        return red

    def free_program(self) -> None:
        """Drop the model and the mode's state before the reference runs."""
        self.mode.free(self)
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, window: dict) -> Dict[str, float]:
        state = weights.seeded_state(self.shapes, sub_seed(self.seed, 0), self.device)
        ref_cfg = config_from_sections(self.cell["sections"])
        with check.reference_precision(False):
            return self.mode.numbers(self, window, ref_cfg, state)


def layer_metrics(unit: str, spec_metrics: Dict[str, dict], red: dict, window: dict,
                  root: Path) -> Dict[str, dict]:
    """The cell's per-layer metrics from their readers (``metrics/<name>.py``);
    a reader that finds nothing returns None and the metric is left out."""
    red = {**red, "unit": unit, "unit_rate": window.get("unit_rate"), "flops_peak": FLOPS_PEAK}
    out = {}
    for name, m in spec_metrics.items():
        reader = files.metric_reader(name, root)
        value = None if reader is None else reader(red)
        if value is not None:
            out[name] = {"value": value, "unit": m["unit"]}
    return out


def run(argv=None, root: Path = files.ROOT, repo_root: Optional[Path] = None,
        device=None, t0: Optional[float] = None) -> int:
    """The whole run; returns the exit code.  ``device`` is for the tests
    alone (the CPU at a tiny size); the command always asks for the card."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    repo_root = root.parent if repo_root is None else repo_root
    spec = files.benchmark_spec(repo_root)
    cell = files.load_cell(args.workload, root)
    if device is None:
        chips = next((w.get("chips", 1) for w in spec.get("workloads", [])
                      if w["name"] == args.workload), 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no CUDA device for {args.workload!r} (needs {chips}); no result",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    e2e = files.cell_metrics(spec, args.workload, "end_to_end")
    per_layer = files.cell_metrics(spec, args.workload, "per_layer")

    c = Cell(cell, args.seed, device, t0, root)
    window = c.window(args.seconds)
    result_device = card_name(device)
    if device.type == "cuda":
        result_device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        result_device["memory_peak_bytes"] = 0
    breakdown = None
    if args.trace:
        red = c.traced(int(cell.get("trace_units", 4)))
        result_device["busy_s"] = red["busy_s"]
        result_device["window_s"] = red["window_s"]
        metrics = layer_metrics(c.mode.UNIT, per_layer, red, window, root)
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        print(json.dumps({"trace_detail": {k: red[k] for k in ("spans_ms", "flops",
                                                                "level_points",
                                                                "kpconv_fwd_s", "kpconv_bwd_s",
                                                                "kpconv_roofline",
                                                                "kernels_per_unit")}}),
              flush=True)
    else:
        values = {"setup_s": c.setup_s, **window["metrics"]}
        metrics = {name: {"value": values[name], "unit": m["unit"]} for name, m in e2e.items()
                   if values.get(name) is not None}

    c.free_program()
    numbers = c.numbers(window)
    for k in [k for k in numbers if k.startswith("_")]:  # what a reading names, not a number
        print(f"{k[1:]}: {numbers.pop(k)}", file=sys.stderr)
    limits = cell["limits"]
    correct = (window["failed"] == 0 and check.verdict(numbers, limits)
               and window.get("complete", True))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}; no result", file=sys.stderr)
        return 4
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    if device.type == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k} {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
