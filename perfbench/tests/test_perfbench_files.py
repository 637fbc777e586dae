"""A cell, a configuration, a traffic mix, a traffic generator, a mode and
a per-layer metric are added as files alone: the harness finds each by its
name."""
import json

from perfbench.core import files
from perfbench.tests.tiny import REGISTER_LIMITS, TRAFFIC, make_tree, run_cell, write_json

MIRROR = '''"""A generator added as a file: the LiDAR drive, each pair's source and
target swapped."""
from perfbench.traffic import lidar_drive


def make_pool(params, seed, device, images=False):
    pool = lidar_drive.make_pool(params, seed, device, images)
    return [{"src_pcd": s["tgt_pcd"], "tgt_pcd": s["src_pcd"], "rot": s["rot"].T,
             "trans": -s["rot"].T @ s["trans"]} for s in pool]
'''

COUNTED = '''"""A mode added as a file: registration as modes/register.py drives it,
reporting the pairs the window completed."""
from pathlib import Path

from perfbench.core import files

_register = files.load_module(Path(__file__).with_name("register.py"))
globals().update({k: v for k, v in vars(_register).items() if not k.startswith("__")})


def window(c, seconds):
    w = _register.window(c, seconds)
    w["metrics"] = {"pairs_done": float(len(w["latencies_s"]))}
    return w
'''


def test_new_files_are_found_by_name(tmp_path):
    root = make_tree(tmp_path)
    cell = files.load_cell("tg.register", root)
    assert cell["mode"] == "register"
    assert cell["sections"]["model"]["dataset"] == "kitti"
    assert cell["traffic_params"]["kind"] == "lidar_drive"
    assert files.mode_module(cell["mode"], root).UNIT == "pair"
    (root / "metrics" / "always_seven.py").write_text("def read(t):\n    return 7.0\n")
    assert files.metric_reader("always_seven", root)({}) == 7.0
    assert files.metric_reader("no_such_metric", root) is None


def test_cell_metrics_follow_the_workloads_key():
    spec = {"per_layer": [{"name": "a", "workloads": ["x"]}, {"name": "b"},
                          {"name": "c", "workloads": ["y"]}]}
    assert sorted(files.cell_metrics(spec, "x", "per_layer")) == ["a", "b"]


def test_a_cell_added_as_files_runs_with_its_new_metric(tmp_path, capsys):
    root = make_tree(tmp_path)
    (root / "metrics" / "units_traced.serve.py").write_text(
        "def read(t):\n    return float(t['units']) if t['unit'] == 'pair' else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "units_traced.serve", "unit": "units", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "pairs_per_s", "workloads": ["tg.register"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = run_cell(root, "tg.register", capsys, trace=1)
    assert result["metrics"]["units_traced.serve"]["value"] == 2.0
    assert result["correct"] is True
    assert list(result)[-1] == "checks"


def _add_cell(root, name, config, traffic, mode, e2e=()):
    """A cell written as a file, listed in BENCHMARK.json and by the end-to-end
    metrics ``e2e``."""
    write_json(root / "workloads" / f"{name}.json",
               {"config": config, "traffic": traffic, "mode": mode, "trace_units": 2,
                "limits": REGISTER_LIMITS})
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in e2e:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_generator_added_as_a_file_drives_a_new_cell(tmp_path, capsys):
    root = make_tree(tmp_path)
    (root / "traffic" / "mirror_drive.py").write_text(MIRROR)
    write_json(root / "traffic" / "tiny_mirror.json", dict(TRAFFIC["tiny_lidar"],
                                                           kind="mirror_drive"))
    _add_cell(root, "tm.register", "tiny_geometry", "tiny_mirror", "register",
              e2e=("pairs_per_s", "pair_ms_p95"))
    pool = files.make_pool(files.load_cell("tm.register", root)["traffic_params"], 7, "cpu",
                           images=False, root=root)
    plain = files.make_pool(TRAFFIC["tiny_lidar"], 7, "cpu", images=False, root=root)
    assert (pool[0]["src_pcd"] == plain[0]["tgt_pcd"]).all()
    result = run_cell(root, "tm.register", capsys)
    assert result["correct"] is True, result["checks"]
    assert sorted(result["metrics"]) == ["pair_ms_p95", "pairs_per_s", "setup_s"]


def test_a_mode_added_as_a_file_reports_its_own_metric(tmp_path, capsys):
    root = make_tree(tmp_path)
    (root / "modes" / "counted.py").write_text(COUNTED)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "pairs_done", "unit": "pairs", "better": "higher",
                               "bound": 0.25, "source": "host_clock", "workloads": []})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    _add_cell(root, "tn.counted", "tiny_geometry", "tiny_lidar", "counted", e2e=("pairs_done",))
    result = run_cell(root, "tn.counted", capsys)
    assert result["correct"] is True, result["checks"]
    assert sorted(result["metrics"]) == ["pairs_done", "setup_s"]
    assert result["metrics"]["pairs_done"]["value"] >= 3
