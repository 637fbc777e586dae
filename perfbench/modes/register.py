"""Registration, closed loop, one pair a call: per pair,
``data/pair.py::make_pair_batch`` on the raw clouds, then
``eval/tester.py::register_pair`` with the pair's injected draws, ended
when the transform is on the host.

End-to-end: ``pairs_per_s`` (pairs completed over the whole window) and
``pair_ms_p95`` (the 95th percentile of every pair's latency, from the
``make_pair_batch`` call to the transform on the host).  The check holds
one answer of each pool pair (an occurrence drawn from the seed) against
the reference (``core/check.py::register_numbers``).
"""
from __future__ import annotations

import torch

from perfbench.core import check, drive
from perfbench.reference import pipeline

UNIT = "pair"
BACKWARD = False  # a unit runs no backward pass


def draws(c, sample, gen: torch.Generator) -> dict:
    return c.program.draws(c.cfg, sample, gen, c.device, train=False)


def setup(c) -> None:
    p = c.program
    c.capture = drive.Capture(p.kpfcnn_module(c.model, c.cfg), p.lift_module(c.model, c.cfg))
    for i in range(min(2, c.n_pool)):  # warm-up: the cell's one set of shapes
        run_unit(c, i)


def run_unit(c, i: int) -> dict:
    s = c.pool[i]
    batch = c.program.make_batch(s, c.cfg, c.device)
    res = c.program.register(c.model, c.cfg, batch, c.draws[i], s.get("images"), c.device)
    res["transform"] = res["transform"].cpu()
    return res


def window(c, seconds: float) -> dict:
    keep_at = [c.rng.randrange(2) for _ in range(c.n_pool)]
    w = drive.register_window(lambda i: run_unit(c, i), c.n_pool, seconds, keep_at,
                              c.capture, c.sync)
    w["metrics"] = {"pairs_per_s": w["pairs_per_s"], "pair_ms_p95": w["pair_ms_p95"]}
    w["unit_rate"] = w["pairs_per_s"]
    w["complete"] = len(w["kept"]) == c.n_pool
    return w


def stage_marks(c, marks) -> list:
    """The layers of ``register_pair`` a pair passes, in order: the batch
    and the pyramid, the 2D backbone and lift (color), the KPFCNN, and
    sampling, matching and RANSAC up to the transform on the host."""
    p = c.program
    marks.around(p.step_module(), "build_pyramid_cfg", after="pyramid")
    stages = ["pyramid"]
    lift = p.lift_module(c.model, c.cfg)
    if lift is not None:
        marks.after_forward(lift, "backbone_lift")
        stages.append("backbone_lift")
    marks.after_forward(p.kpfcnn_module(c.model, c.cfg), "kpfcnn")
    return stages + ["kpfcnn", "registration"]


def free(c) -> None:
    c.capture.remove()
    c.model = None


def numbers(c, window: dict, ref_cfg, state) -> dict:
    return check.register_numbers(window.get("kept"), c.pool, c.draws, ref_cfg, state,
                                  c.device)


def control_numbers(ref_cfg, state, pool, draws_, device) -> dict:
    """The correctness control: every pool pair's answer as the reference
    gives it in TF32, held to the reference in IEEE float32."""
    with check.reference_precision(True):
        kept = reference_answers(ref_cfg, state, pool, draws_, device)
    with check.reference_precision(False):
        return check.register_numbers(kept, pool, draws_, ref_cfg, state, device)


def reference_answers(cfg, state, pool, draws_, device) -> dict:
    """Every pool pair's answer as the reference gives it, in the form the
    window keeps the program's."""
    model = pipeline.build_model(cfg, state, device)
    kept = {}
    with torch.no_grad():
        for i, s in enumerate(pool):
            batch = pipeline.pair_batch(s, cfg, device)
            pts, msk, feats = batch.points[0], batch.masks[0], batch.features[0]
            out, pyr, lifted = pipeline.forward(model, cfg, pts, msk, feats,
                                                pipeline.images_on(s.get("images"), device))
            reg = pipeline.register_from_outputs(cfg, out, pts, msk, draws_[i]["uniforms"],
                                                 draws_[i]["picks"])
            kept[i] = {"pyramid": pyr, "lifted": lifted,
                       "result": {"transform": reg["transform"].cpu(), "outputs": out}}
    return kept
