"""The operation and byte counts, on cases worked by hand."""
import pytest
import torch

from perfbench.counts import work


def test_kpconv_forward_by_hand():
    # 2 queries, 3 supports, 4 real (query, neighbor) pairs, C = 2, D = 5, K = 3.
    ops, nbytes = work.kpconv_forward(nq=2, ns=3, edges=4, c=2, d=5, k=3)
    influences = 4 * 3 * 12
    weighted = 2 * 4 * 3 * 2
    products = 2 * 2 * 3 * 2 * 5
    assert ops == influences + weighted + products == 312
    reads = 2 * 3 + 3 * 3 + 3 * 2 + 4 + 3 * 3 + 3 * 2 * 5
    writes = 2 * 5
    assert nbytes == 4 * (reads + writes) == 4 * 74


def test_kpconv_backward_by_hand():
    ops, nbytes = work.kpconv_backward(nq=2, ns=3, edges=4, c=2, d=5, k=3, input_grad=False)
    assert ops == 2 * 2 * 3 * 2 * 5
    assert nbytes == 4 * (2 * 5 + 3 * 2 * 5 + 2 * 3 * 2 + 3 * 2 * 5)
    ops_g, bytes_g = work.kpconv_backward(nq=2, ns=3, edges=4, c=2, d=5, k=3, input_grad=True)
    assert ops_g == ops + 2 * 2 * 3 * 2 * 5 + 4 * 3 * 12 + 2 * 4 * 3 * 2
    assert bytes_g == nbytes + 4 * (2 * 3 + 3 * 3 + 4 + 3 * 2)


def test_conv2d_matches_a_direct_count():
    # One 3x3 convolution, 4 -> 6 channels, stride 1, padding 1, 5 x 7 image, batch 2.
    x = torch.randn(2, 4, 5, 7)
    conv = torch.nn.Conv2d(4, 6, 3, padding=1, bias=False)
    out = conv(x)
    macs = out.numel() * 4 * 3 * 3
    assert work.conv2d(2, 4, 6, 3, 3, 5, 7) == 2 * macs == 2 * 2 * 6 * 5 * 7 * 36


def test_least_time_takes_the_bound_that_binds():
    assert work.least_seconds(495e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(495e12, 2 * 3.35e12) == pytest.approx(2.0)
