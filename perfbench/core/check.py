"""Whether what the timed path produced is correct: the program's answers
held against the plain reference (``perfbench/reference``), run after the
window on the same raw inputs, the same seeded weights and the same draws.

Registration, per kept answer (one of each pool pair):

* ``pyramid_mismatch``: entries of the pyramid (points and masks of every
  level, every conv / pool / upsample neighbor list) that differ from the
  reference's pyramid of the same raw pair: an exact comparison;
* ``feats_gap``: the widest distance between a real point's descriptor and
  the reference's (both unit vectors);
* ``scores_gap``: the widest gap of a real point's overlap or saliency score;
* ``lift_gap`` (color model): the widest gap of a lifted feature, over the
  largest reference feature's magnitude;
* ``rot_gap`` / ``trans_gap_m``: the program's transform against the
  reference's sampling, matching and RANSAC run on the program's own model
  outputs with the same draws (that stage checked alone; the stages
  before it are checked from the raw inputs above).

Training, the first three steps of the object the window trains, against
the reference following the same three steps:

* ``first_loss_gap``: the first step's |total - reference| / |reference|;
* ``later_loss_gap``: the same, the worse of steps 2 and 3;
* ``grad_gap``: by the worst leaf, the gap between the norms of the first
  update's gradient as the optimizer holds it (SGD's momentum buffer after
  step 1: the gradient plus the weight decay), over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same for the parameters' change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from perfbench.reference import pipeline
from perfbench.reference import precision as reference_precision  # noqa: F401

def pyramid_mismatch(port, ref) -> int:
    """Entries that differ between two pyramids (exact)."""
    bad = 0
    for a, b in zip(port.masks, ref.masks):
        bad += int((a != b).sum())
    for a, b in zip(port.points, ref.points):
        bad += int((a != b).any(-1).sum())
    for group in ("neighbors", "pools", "upsamples"):
        for a, b in zip(getattr(port, group), getattr(ref, group)):
            bad += int((a.to(b.dtype) != b).sum())
    return bad


def rotation_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """|R_a - R_b| (Frobenius): about the angle between them in radians
    times sqrt(2), and precise near zero, where an arccos is not."""
    return float((a[:3, :3].double() - b[:3, :3].double()).norm())


def register_numbers(kept: Mapping[int, dict], pool: List[dict], draws: List[dict], cfg,
                     state: Mapping[str, torch.Tensor], device) -> Dict[str, float]:
    """The worst of each number over the kept answers."""
    worst = {"pyramid_mismatch": 0.0, "feats_gap": 0.0, "scores_gap": 0.0,
             "rot_gap": 0.0, "trans_gap_m": 0.0}
    if cfg.image_feature:
        worst["lift_gap"] = 0.0
    model = pipeline.build_model(cfg, state, device)
    with torch.no_grad():
        for i, got in sorted(kept.items()):
            batch = pipeline.pair_batch(pool[i], cfg, device)
            pts, msk, feats = batch.points[0], batch.masks[0], batch.features[0]
            images = pipeline.images_on(pool[i].get("images"), device)
            out, pyr, lifted = pipeline.forward(model, cfg, pts, msk, feats, images)
            res = got["result"]
            pout = res["outputs"]
            real = msk
            numbers = {
                "pyramid_mismatch": float(pyramid_mismatch(got["pyramid"], pyr)),
                "feats_gap": float((pout["feats_f"] - out["feats_f"]).norm(dim=-1)[real].max()),
                "scores_gap": float(max(
                    (pout[k] - out[k]).abs()[real].max() for k in ("scores_overlap",
                                                                    "scores_saliency"))),
            }
            if cfg.image_feature:
                scale = lifted[real].abs().max().clamp_min(1e-30)
                numbers["lift_gap"] = float((got["lifted"] - lifted).abs()[real].max() / scale)
            # Registration: the reference's stage on the program's outputs.
            reg = pipeline.register_from_outputs(cfg, pout, pts, msk, draws[i]["uniforms"],
                                                 draws[i]["picks"])
            t_port = res["transform"].to(device)
            numbers["rot_gap"] = rotation_gap(t_port, reg["transform"])
            numbers["trans_gap_m"] = float((t_port[:, 3] - reg["transform"][:, 3]).norm())
            for k, v in numbers.items():
                worst[k] = max(worst[k], v)
    return worst


def leaf_gaps(port: List[torch.Tensor], ref: List[torch.Tensor],
              include: Optional[List[bool]] = None) -> List[tuple]:
    """Per leaf (of those ``include`` keeps): | |port| - |ref| | over
    max(|ref|, the median leaf's |ref|), with the leaf's index."""
    pn = [float(t.double().norm()) for t in port]
    rn = [float(t.double().norm()) for t in ref]
    keep = [i for i in range(len(rn)) if include is None or include[i]]
    med = sorted(rn[i] for i in keep)[len(keep) // 2]
    return [(abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30), i) for i in keep]


def moved_leaves(grads: List[torch.Tensor]) -> List[bool]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone)."""
    gnorm = [float(g.double().norm()) for g in grads]
    med = sorted(gnorm)[len(gnorm) // 2]
    return [g >= 1e-3 * med for g in gnorm]


def train_numbers(program_steps: dict, pool_batches: List[dict], draws: List[dict], cfg,
                  state: Mapping[str, torch.Tensor], names: List[str], device) -> Dict[str, float]:
    """``program_steps``: the losses of the first three steps, the momentum
    buffers after step 1 and the parameters before and after the three
    steps, each list in the order of ``names`` (the trained leaves)."""
    model = pipeline.build_model(cfg, state, device)
    params = dict(model.named_parameters())
    leaves = [params[n] for n in names]
    for p in model.parameters():
        if not any(p is q for q in leaves):
            p.requires_grad_(False)
    optimizer = pipeline.make_optimizer(cfg, leaves)
    p0 = [p.detach().clone() for p in leaves]
    losses, grad1, buf1 = [], None, None
    for step in range(3):
        sample = pool_batches[step]
        batch = pipeline.pair_batch(sample, cfg, device)
        images = pipeline.images_on(sample.get("images"), device)
        if images is not None:
            images = {k: v[None] for k, v in images.items()}
        stats, grads = pipeline.train_step(model, leaves, optimizer, cfg, batch,
                                           draws[step]["uniforms"], images)
        losses.append(float(stats["total"]))
        if step == 0:
            grad1 = grads
            buf1 = [optimizer.state[p]["momentum_buffer"].clone() for p in leaves]
    change = [p.detach() - q for p, q in zip(leaves, p0)]
    port_loss = program_steps["losses"]
    port_change = [b - a for a, b in zip(program_steps["p0"], program_steps["p3"])]
    grad_gaps = leaf_gaps(program_steps["buf1"], buf1)
    change_gaps = leaf_gaps(port_change, change, moved_leaves(grad1))
    grad_gap, grad_leaf = max(grad_gaps)
    change_gap, change_leaf = max(change_gaps)
    return {
        "first_loss_gap": abs(port_loss[0] - losses[0]) / max(abs(losses[0]), 1e-30),
        "later_loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                              for a, b in zip(port_loss[1:], losses[1:])),
        "grad_gap": grad_gap,
        "change_gap": change_gap,
        # Not compared: which leaves the two worst gaps came from, and the
        # median leaf's gaps.
        "_grad_leaf": names[grad_leaf],
        "_change_leaf": names[change_leaf],
        "_grad_gap_median": sorted(g for g, _ in grad_gaps)[len(grad_gaps) // 2],
        "_change_gap_median": sorted(g for g, _ in change_gaps)[len(change_gaps) // 2],
    }


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number within its limit (a number without a limit fails)."""
    return all(name in limits and numbers[name] <= limits[name] for name in numbers)
