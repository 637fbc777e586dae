"""Training, batch 1: ``train/step.py::train_step`` back to back over
batches made before the window (as the loader's threads make them ahead
in training), pool pairs in turn; a device sync ends the window.

End-to-end: ``steps_per_s`` (steps completed over the whole window).
Set-up builds one training state and drives it through its first three
steps, the warm-up; the window goes on with that same state, and the
check follows those three steps with the reference
(``core/check.py::train_numbers``).
"""
from __future__ import annotations

import torch

from perfbench.core import check, drive, weights
from perfbench.reference import pipeline

UNIT = "step"
BACKWARD = True  # a unit runs the backward pass
FIRST_STEPS = 3


def draws(c, sample, gen: torch.Generator) -> dict:
    return c.program.draws(c.cfg, sample, gen, c.device, train=True)


def _batched_images(sample):
    im = sample.get("images")
    return None if im is None else {k: v[None] for k, v in im.items()}


def setup(c) -> None:
    p = c.program
    c.batches = [p.make_batch(s, c.cfg, c.device) for s in c.pool]
    c.images = [_batched_images(s) for s in c.pool]
    c.state = p.train_state(c.cfg, c.model, c.cell["steps_per_epoch"])
    named = {id(t): n for n, t in c.model.named_parameters()}
    c.leaf_names = [weights.canonical(named[id(t)], c.cfg.image_feature)
                    for t in c.state.params]
    p0 = [t.detach().clone() for t in c.state.params]
    losses, buf1 = [], None
    for step in range(FIRST_STEPS):  # the first steps: warm-up, and what the check follows
        stats = run_unit(c, step)
        losses.append(float(stats["total"]))
        if step == 0:
            # The optimizer's state after one step (none: it got nothing).
            held = [c.state.optimizer.state.get(t, {}).get("momentum_buffer")
                    for t in c.state.params]
            buf1 = [torch.zeros_like(t) if b is None else b.clone()
                    for t, b in zip(c.state.params, held)]
    c.first_steps = {"losses": losses, "p0": p0, "buf1": buf1,
                     "p3": [t.detach().clone() for t in c.state.params]}


def run_unit(c, i: int):
    return c.program.train_step(c.state, c.cfg, c.batches[i], c.draws[i]["uniforms"],
                                c.images[i])


def window(c, seconds: float) -> dict:
    w = drive.train_window(lambda i: run_unit(c, i), c.n_pool, FIRST_STEPS, seconds, c.sync)
    w["metrics"] = {"steps_per_s": w["steps_per_s"]}
    w["unit_rate"] = w["steps_per_s"]
    return w


def stage_marks(c, marks) -> list:
    """The layers of ``train_step`` a step passes, in order: the pyramid,
    the forward pass (with the color model's 2D backbone and lift), the
    loss, the backward pass, and the optimizer's update."""
    step = c.program.step_module()
    marks.around(step, "build_pyramid_cfg", after="pyramid")
    marks.after_forward(c.state.model, "forward")
    marks.around(step, "loss_from_outputs", after="loss")
    marks.around(c.state, "apply_gradients", before="backward")
    return ["pyramid", "forward", "loss", "backward", "optimizer"]


def free(c) -> None:
    c.model = c.state = None


def numbers(c, window: dict, ref_cfg, state) -> dict:
    return check.train_numbers(c.first_steps, c.pool, c.draws, ref_cfg, state, c.leaf_names,
                               c.device)


def control_numbers(ref_cfg, state, pool, draws_, device) -> dict:
    """The correctness control: the reference's first steps in TF32, held
    to the reference in IEEE float32."""
    with check.reference_precision(True):
        first = reference_steps(ref_cfg, state, pool, draws_, device)
    names = first.pop("names")
    with check.reference_precision(False):
        return check.train_numbers(first, pool, draws_, ref_cfg, state, names, device)


def reference_steps(cfg, state, pool, draws_, device) -> dict:
    """The reference's first steps, recorded as set-up records the
    program's."""
    model = pipeline.build_model(cfg, state, device)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    leaves = [p for _, p in model.named_parameters() if p.requires_grad]
    optimizer = pipeline.make_optimizer(cfg, leaves)
    p0 = [p.detach().clone() for p in leaves]
    losses, buf1, grad1 = [], None, None
    for step in range(FIRST_STEPS):
        s = pool[step]
        batch = pipeline.pair_batch(s, cfg, device)
        images = pipeline.images_on(s.get("images"), device)
        images = None if images is None else {k: v[None] for k, v in images.items()}
        stats, grads = pipeline.train_step(model, leaves, optimizer, cfg, batch,
                                           draws_[step]["uniforms"], images)
        losses.append(float(stats["total"]))
        if step == 0:
            grad1 = grads
            buf1 = [optimizer.state[p]["momentum_buffer"].clone() for p in leaves]
    return {"losses": losses, "p0": p0, "buf1": buf1, "grad1": grad1,
            "p3": [p.detach().clone() for p in leaves], "names": names}
