"""The KPConv route table (``models/kpconv.py::conv_route``) on the CPU:
each ``(kpconv_impl, kpconv_tiled, search_impl)`` configuration and each
block kind of the encoder give the route, the strided-shortcut rule and
the shared-rel rule the docstring of ``KPConv`` states; a deformable
conv's offset sub-conv keeps its rigid route without tile metadata; and
``train_step`` refuses ``reduce``.  No forward runs: a few ms a case."""
from __future__ import annotations

import dataclasses

import pytest

from pcrcg_tpu_torch.config import tiny_test_config
from pcrcg_tpu_torch.models.kpconv import ConvRoute, KPConv, conv_route
from pcrcg_tpu_torch.train.step import train_step

# Block kinds: (strided, deformable, conv input width).  Block 0 of a
# geometry-only model reads the ones column (width 1).
KINDS = {
    "ones_simple": (False, False, 1),
    "resnetb": (False, False, 32),
    "strided": (True, False, 32),
    "deformable": (False, True, 32),
    "deformable_strided": (True, True, 32),
}

# By the column a configuration falls in: kind -> (route, shortcut,
# shared rel).
TABLE = {
    "tile": {
        "ones_simple": ("tiled", None, False),
        "resnetb": ("tiled", None, False),
        "strided": ("tiled", "max_pool_first", False),
        "deformable": ("deformable", None, True),
        "deformable_strided": ("deformable", "max_pool_first", False),
    },
    "gathered": {
        "ones_simple": ("gathered", None, True),
        "resnetb": ("gathered", None, True),
        "strided": ("merged", "merged", False),
        "deformable": ("deformable", None, True),
        "deformable_strided": ("deformable", "max_pool", False),
    },
    "reduce": {
        "ones_simple": ("dense", None, True),
        "resnetb": ("reduce", None, True),
        "strided": ("reduce", "max_pool", True),
        "deformable": ("deformable", None, True),
        "deformable_strided": ("deformable", "max_pool", True),
    },
    "xla": {
        "ones_simple": ("dense", None, True),
        "resnetb": ("dense", None, True),
        "strided": ("dense", "max_pool", True),
        "deformable": ("deformable", None, True),
        "deformable_strided": ("deformable", "max_pool", True),
    },
}

# The offset sub-conv's route by column (it never gets tile metadata).
OFFSET = {"tile": "gathered", "gathered": "gathered", "reduce": "reduce", "xla": "dense"}


def _column(impl: str, tiled: bool, search_impl: str) -> str:
    if impl in ("auto", "fused"):
        return "tile" if tiled and search_impl == "tiled" else "gathered"
    return impl


CONFIGS = [(impl, tiled, search) for impl in ("auto", "fused", "reduce", "xla")
           for tiled in (True, False) for search in ("tiled", "dense")]


def _cfg(impl: str, tiled: bool, search: str):
    cfg = tiny_test_config(kpconv_impl=impl, kpconv_tiled=tiled)
    return cfg.replace(budgets=dataclasses.replace(cfg.budgets, search_impl=search))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("impl,tiled,search", CONFIGS,
                         ids=[f"{i}-{'tiled' if t else 'untiled'}-{s}" for i, t, s in CONFIGS])
def test_route_table(impl, tiled, search, kind):
    cfg = _cfg(impl, tiled, search)
    strided, deformable, width = KINDS[kind]
    tiled_pyramid = cfg.budgets.search_impl == "tiled"
    column = _column(impl, tiled, search)
    want = ConvRoute(*TABLE[column][kind])
    got = conv_route(cfg.kpconv_impl, cfg.kpconv_tiled, cfg.aggregation_mode,
                     strided=strided, deformable=deformable, in_channels=width,
                     tiled_pyramid=tiled_pyramid)
    assert got == want
    # The module asks the same function, with its own width and flags.
    conv = KPConv(width, 8, radius=0.1, kp_extent=0.12, aggregation=cfg.aggregation_mode,
                  ones_features=width == 1, impl=cfg.kpconv_impl, tiled=cfg.kpconv_tiled,
                  deformable=deformable)
    assert conv.route(strided, tiled_pyramid) == want
    if deformable:
        offset = conv.offset_conv.route(False, False)
        assert offset == ConvRoute(OFFSET[column], None, True)


def test_closest_aggregation_keeps_reduce_off_k8():
    """K8 reduces under sum aggregation only; ``closest`` takes ``dense``."""
    assert conv_route("reduce", aggregation="closest", in_channels=32).conv == "dense"
    assert conv_route("reduce", aggregation="sum", in_channels=8).conv == "reduce"
    assert conv_route("reduce", aggregation="sum", in_channels=7).conv == "dense"


def test_unknown_impl_is_refused():
    with pytest.raises(ValueError, match="unknown kpconv_impl"):
        conv_route("pallas")
    with pytest.raises(ValueError, match="unknown kpconv_impl"):
        KPConv(8, 8, radius=0.1, kp_extent=0.12, impl="pallas")


def test_train_step_refuses_reduce():
    """The refusal comes before any work: no model, batch or state is
    read."""
    with pytest.raises(NotImplementedError, match="kpconv_impl='reduce' serves only"):
        train_step(None, tiny_test_config(kpconv_impl="reduce"), None)
    with pytest.raises(NotImplementedError, match="serves only"):
        conv_route("reduce", backward=True)
    for impl in ("auto", "fused", "xla"):
        assert conv_route(impl, backward=True).conv in ("gathered", "dense")
