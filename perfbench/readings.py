"""The readings a cell's correctness limits are set from, on the card, many
seeds in one process (the benchmark's own runs never run this):

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 [--control]
        [--seconds 1] [--out chiprun_out/readings.json]

* sound runs (default): the program as a run drives it (set-up, a short
  window at the cell's own load, the check), its numbers per seed: the
  lower readings;
* ``--control``: the reference computed in TF32 (the precision below the
  configurations' float32) put in the program's place and checked as the
  program is: the upper readings.  It must come out not correct;
* ``--fault unchanged``: sound runs with a training step planted in the
  program that leaves the state unchanged (a fault's readings);
* ``--look`` (training cells): the first steps leaf by leaf, the program
  twice against the reference on the card and on the CPU.

Prints one JSON line per seed and writes them all to ``--out``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench.core import check, files, harness, weights  # noqa: E402
from perfbench.reference import pipeline  # noqa: E402


def inputs(cell: dict, seed: int, device, root: Path = files.ROOT):
    """What a run of ``cell`` with ``seed`` hands both sides: the mode, the
    reference's configuration, the seeded weights, the pool and the draws."""
    from perfbench.core import program

    mode = files.mode_module(cell["mode"], root)
    cfg = program.port_config(cell["sections"])
    ref_cfg = pipeline.config_from_sections(cell["sections"])
    pool = files.make_pool(cell["traffic_params"], harness.sub_seed(seed, 1), device,
                           images=cfg.image_feature, root=root)
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, 2))
    holder = SimpleNamespace(program=program, cfg=cfg, device=device)
    draws = [mode.draws(holder, s, gen) for s in pool]
    state = weights.seeded_state(program.model_shapes(cfg), harness.sub_seed(seed, 0), device)
    return mode, ref_cfg, state, pool, draws


def control_numbers(cell: dict, seed: int, device, root: Path = files.ROOT) -> dict:
    """The control's numbers: the reference in TF32 in the program's place."""
    mode, ref_cfg, state, pool, draws = inputs(cell, seed, device, root)
    return mode.control_numbers(ref_cfg, state, pool, draws, device)


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return x


def look(cell: dict, seed: int, device, root: Path = files.ROOT) -> dict:
    """A training cell's first steps, leaf by leaf, on three sides: the
    program twice (a run's set-up, twice over), the reference on the card,
    and the reference on the host's CPU (a second witness: float32 with
    another order of rounding).  Per pair of sides, the worst and the
    median leaf of the first gradient's and the three steps' change's norm
    gaps (``check.leaf_gaps``), and the loss of each step."""
    train_mode = files.mode_module("train", root)
    cpu = torch.device("cpu")
    sides = {}
    for run in ("program", "program_again"):
        c = harness.Cell(cell, seed, device, time.perf_counter(), root)
        first = dict(c.first_steps, names=c.leaf_names)
        c.free_program()
        sides[run] = first
    _, ref_cfg, state, pool, draws = inputs(cell, seed, device, root)
    with check.reference_precision(False):
        sides["card"] = train_mode.reference_steps(ref_cfg, state, pool, draws, device)
        sides["cpu"] = train_mode.reference_steps(ref_cfg, _to(state, cpu), _to(pool, cpu),
                                                  _to(draws, cpu), cpu)
    by_name = {}
    for side, first in sides.items():
        idx = {n: i for i, n in enumerate(first["names"])}
        take = lambda key: [first[key][idx[n]].detach().to(cpu)  # noqa: E731
                            for n in sides["card"]["names"]]
        by_name[side] = {"losses": first["losses"], "buf1": take("buf1"),
                         "change": [b - a for a, b in zip(take("p0"), take("p3"))]}
    names = sides["card"]["names"]
    moved = check.moved_leaves([g.to(cpu) for g in sides["card"]["grad1"]])
    out = {"losses": {side: v["losses"] for side, v in by_name.items()},
           "repeat_max_abs_change": max(float((a - b).abs().max()) for a, b in zip(
               by_name["program"]["change"], by_name["program_again"]["change"]))}
    for a, b in (("program", "card"), ("program_again", "card"), ("cpu", "card"),
                 ("program", "cpu")):
        for key, include in (("buf1", None), ("change", moved)):
            gaps = sorted(check.leaf_gaps(by_name[a][key], by_name[b][key], include),
                          reverse=True)
            out[f"{a}_vs_{b}.{key}"] = {
                "worst": [[names[i], g] for g, i in gaps[:4]],
                "median": gaps[len(gaps) // 2][0]}
    return out


def unchanged_step(state, cfg, batch, uniforms, images):
    """A planted fault: a training step that returns the state unchanged
    (the loss is evaluated, nothing is updated)."""
    from pcrcg_tpu_torch.train.step import eval_step

    state.step += 1
    return eval_step(state, cfg, batch, uniforms=uniforms, images=images)


def sound_numbers(cell: dict, seed: int, seconds: float, device) -> dict:
    """A run's set-up, window and check, without the result line."""
    c = harness.Cell(cell, seed, device, time.perf_counter())
    window = c.window(seconds)
    c.free_program()
    numbers = c.numbers(window)
    return {**numbers, "_failed": window["failed"], "_attempted": window["attempted"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=("unchanged",), default=None,
                   help="plant a fault in the program's training step")
    p.add_argument("--look", action="store_true",
                   help="a training cell's first steps leaf by leaf: the program twice, the "
                        "reference on the card and on the CPU")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = files.load_cell(args.workload)
    if args.fault == "unchanged":
        from perfbench.core import program

        program.train_step = unchanged_step
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.look:
            row = {"workload": args.workload, "seed": seed, "look": look(cell, seed, device),
                   "seconds": time.perf_counter() - t}
            print(json.dumps(row), flush=True)
            rows.append(row)
            continue
        numbers = (control_numbers(cell, seed, device) if args.control
                   else sound_numbers(cell, seed, args.seconds, device))
        row = {"workload": args.workload, "seed": seed, "control": args.control,
               "fault": args.fault,
               "correct": check.verdict({k: v for k, v in numbers.items()
                                         if not k.startswith("_")}, cell["limits"]),
               "numbers": numbers, "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
