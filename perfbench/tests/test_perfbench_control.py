"""The correctness control on the card: the reference computed in TF32 put
in the program's place comes out not correct, at a size a test run holds
(the cells' own size: ``perfbench/readings.py --control``)."""
import pytest
import torch

from perfbench.core import check, files


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control compares TF32 with IEEE float32: it needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tc.register", "tg.register"])
def test_tf32_control_is_not_correct(card, cell, tmp_path):
    from perfbench import readings
    from perfbench.tests.tiny import make_tree

    root = make_tree(tmp_path)
    c = files.load_cell(cell, root)
    numbers = readings.control_numbers(c, 2147483901, card, root)
    assert not check.verdict(numbers, c["limits"]), numbers
