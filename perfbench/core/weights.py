"""Seeded random weights, made on the device in two large draws (one
uniform, one normal) and cut into leaves in sorted name order, so the same
seed gives the same weights to the port and to the reference.

Names are the color model's state-dict keys (``kpfcnn.*`` and
``lift.backbone2d.*``, the reference torch layout both models keep);
``kernel_points`` buffers are not weights: each side works them out from
the configuration.  The scales follow the usual initializations:

* KPConv ``weights`` [K, C, D]: U(+-sqrt(1 / (C D)));
* other matrices (linear layers, 1x1 convolutions) [out, in, ...]:
  U(+-1 / sqrt(in)), their biases 0;
* ``epsilon`` (the saliency temperature's log): -5;
* the 2D backbone: convolutions N(0, 2 / fan_in), BN scale 1 and shift 0,
  running statistics 0 / 1, the head's bias 0.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

BACKBONE = "lift.backbone2d."


def _rule(name: str, shape: Tuple[int, ...]):
    """("uniform", bound) | ("normal", std) | ("fill", value) for one leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith(BACKBONE):
        if len(shape) == 4:
            return "normal", math.sqrt(2.0 / math.prod(shape[1:]))
        if leaf in ("weight", "running_var"):
            return "fill", 1.0
        return "fill", 0.0
    if leaf == "epsilon":
        return "fill", -5.0
    if leaf == "weights" and len(shape) == 3:
        return "uniform", math.sqrt(1.0 / (shape[1] * shape[2]))
    if len(shape) >= 2:
        return "uniform", 1.0 / math.sqrt(shape[1])
    return "fill", 0.0


def seeded_state(shapes: Mapping[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``shapes``: canonical name -> shape (no ``kernel_points``) -> the
    seed's weights, float32 on ``device``."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n])) for n in names}
    n_uniform = sum(math.prod(shapes[n]) for n in names if rules[n][0] == "uniform")
    n_normal = sum(math.prod(shapes[n]) for n in names if rules[n][0] == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for n in names:
        kind, value = rules[n]
        size = math.prod(shapes[n])
        if kind == "uniform":
            t = (uniform[iu:iu + size] * 2.0 - 1.0) * value
            iu += size
        elif kind == "normal":
            t = normal[inn:inn + size] * value
            inn += size
        else:
            t = torch.full((size,), value, device=device)
        out[n] = t.reshape(shapes[n])
    return out


def canonical(name: str, color: bool) -> str:
    """A port state-dict key under the color model's layout (a KPFCNN's
    keys gain the ``kpfcnn.`` prefix)."""
    return name if color else f"kpfcnn.{name}"


def load_into(model: torch.nn.Module, state: Mapping[str, torch.Tensor], color: bool) -> None:
    """Copy ``state`` into ``model``'s parameters and buffers, by name."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not name.endswith("kernel_points"):
                t.copy_(state[canonical(name, color)])


def model_shapes(model: torch.nn.Module, color: bool) -> Dict[str, Tuple[int, ...]]:
    return {canonical(n, color): tuple(t.shape) for n, t in model.state_dict().items()
            if not n.endswith("kernel_points")}
