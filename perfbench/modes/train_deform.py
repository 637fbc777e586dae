"""Training, batch 1, of a configuration with deformable blocks: driven,
timed and checked as ``modes/train.py`` does it, with the reference model
built by ``reference/models/deform.py::build_model`` (the reference's
``models/kpconv.py`` holds rigid KPConv only) wherever the check and its
control build one.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

from perfbench.core import files
from perfbench.reference import pipeline
from perfbench.reference.models import deform

_train = files.load_module(Path(__file__).with_name("train.py"))
globals().update({k: v for k, v in vars(_train).items() if not k.startswith("__")})


@contextlib.contextmanager
def _deformable_reference():
    """``pipeline.build_model`` as the deformable reference's, inside the
    block (the check and the control build the reference through it)."""
    plain = pipeline.build_model
    pipeline.build_model = deform.build_model
    try:
        yield
    finally:
        pipeline.build_model = plain


def numbers(c, window: dict, ref_cfg, state) -> dict:
    with _deformable_reference():
        return _train.numbers(c, window, ref_cfg, state)


def control_numbers(ref_cfg, state, pool, draws_, device) -> dict:
    with _deformable_reference():
        return _train.control_numbers(ref_cfg, state, pool, draws_, device)
