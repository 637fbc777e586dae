"""The traced run's layer spans come from marks in the program's own entry:
a forward hook or a wrapper at each boundary.  What the entry no longer
passes through is not reported, and the marks leave nothing behind."""
import types

import torch

from perfbench.core import trace


def _entry():
    """A stand-in entry: a 'pyramid' function, then a module, then the rest."""
    ns = types.SimpleNamespace(pyramid=lambda x: x + 1)
    net = torch.nn.Linear(2, 2)

    def run(i):
        return net(ns.pyramid(torch.ones(1, 2) * i)).sum()

    return ns, net, run


def test_marks_time_each_stage_of_the_entry_and_come_off():
    ns, net, run = _entry()
    marks = trace.StageMarks(lambda: None)
    original = ns.pyramid
    marks.around(ns, "pyramid", after="pyramid")
    marks.after_forward(net, "net")
    spans = trace.staged_units(run, [0, 1, 2], marks, ["pyramid", "net", "rest"])
    marks.remove()
    assert sorted(spans) == ["net", "pyramid", "rest"]
    assert all(v >= 0 for v in spans.values())
    assert ns.pyramid is original and not net._forward_hooks


def test_marks_report_nothing_for_a_stage_the_entry_no_longer_has():
    ns, net, run = _entry()
    marks = trace.StageMarks(lambda: None)
    marks.around(ns, "no_such_stage", after="pyramid")
    marks.after_forward(net, "net")
    assert trace.staged_units(run, [0], marks, ["pyramid", "net", "rest"]) == {}
    marks.remove()


def test_marks_report_nothing_when_the_stages_come_in_another_order():
    ns, net, run = _entry()
    marks = trace.StageMarks(lambda: None)
    marks.around(ns, "pyramid", after="pyramid")
    marks.after_forward(net, "net")
    assert trace.staged_units(run, [0], marks, ["net", "pyramid", "rest"]) == {}
    marks.remove()
