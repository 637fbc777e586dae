"""Where the harness finds what a cell names, by name alone:

* a cell is ``workloads/<cell>.json``: its configuration, its traffic, its
  mode and its limits;
* a configuration is ``configs/<config>.json`` (the YAML's sections as JSON);
* a traffic mix is ``traffic/<traffic>.json``, parameters for the generator
  ``traffic/<kind>.py`` that its ``kind`` names (``make_pool``);
* a mode is ``modes/<mode>.py``: how a cell's units are driven in the
  timed window, which end-to-end metrics it reports and how its answers
  are checked;
* a per-layer metric is ``metrics/<metric>.py`` with a ``read(trace)``
  function.

A later cell, configuration, traffic mix, generator, mode or metric is
added as files only."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module of its own."""
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    tag = "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"perfbench_found_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic resolved:
    keys ``name``, ``mode``, ``config`` (name), ``sections`` (the
    configuration file), ``traffic`` (name), ``traffic_params``, ``limits``
    and the cell file's other keys."""
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no cell {name!r}: {path} is missing")
    cell = load_json(path)
    cell["name"] = name
    cell["sections"] = load_json(root / "configs" / f"{cell['config']}.json")
    cell["traffic_params"] = load_json(root / "traffic" / f"{cell['traffic']}.json")
    return cell


def mode_module(name: str, root: Path = ROOT) -> ModuleType:
    """``modes/<name>.py``."""
    return load_module(root / "modes" / f"{name}.py")


def make_pool(params: dict, seed: int, device, images: bool, root: Path = ROOT) -> list:
    """The pool of a traffic mix: ``make_pool`` of ``traffic/<kind>.py``
    with the mix's parameters, made from ``seed`` on ``device``."""
    generator = load_module(root / "traffic" / f"{params['kind']}.py")
    return generator.make_pool(params, seed, device, images=images)


def metric_reader(name: str, root: Path = ROOT) -> Optional[Callable[[dict], Optional[float]]]:
    """``read`` of ``metrics/<name>.py``, or None when there is no such file."""
    path = root / "metrics" / f"{name}.py"
    return load_module(path).read if path.exists() else None


def benchmark_spec(repo_root: Path) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return load_json(repo_root / "BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, kind: str) -> Dict[str, dict]:
    """The ``kind`` ("end_to_end" / "per_layer") metrics that ``cell``
    reports: those that list it under ``workloads``, or list none."""
    return {m["name"]: m for m in spec.get(kind, [])
            if "workloads" not in m or cell in m["workloads"]}
