"""The frozen arithmetic: FLOP counts against hand counts, the bounds on
small inputs."""

import math

import torch
import torch.nn.functional as F

from benchmark.harness import work


def test_conv_flops_by_hand():
    with work.FlopCount() as fc:
        F.conv2d(torch.empty(2, 8, 10, 12, device="meta"),
                 torch.empty(16, 8, 3, 3, device="meta"), padding=1)
    assert fc.flops == 2 * (2 * 16 * 10 * 12) * (8 * 3 * 3)


def test_grouped_and_transposed_conv_flops_by_hand():
    with work.FlopCount() as fc:
        F.conv2d(torch.empty(1, 8, 6, 6, device="meta"),
                 torch.empty(8, 2, 3, 3, device="meta"), groups=4)
    assert fc.flops == 2 * (8 * 4 * 4) * (2 * 3 * 3)
    with work.FlopCount() as fc:
        F.conv_transpose2d(torch.empty(2, 8, 5, 5, device="meta"),
                           torch.empty(8, 4, 2, 2, device="meta"), stride=2)
    assert fc.flops == 2 * (2 * 8 * 5 * 5) * (4 * 2 * 2)


def test_linear_flops_by_hand():
    with work.FlopCount() as fc:
        F.linear(torch.empty(5, 7, device="meta"),
                 torch.empty(3, 7, device="meta"),
                 torch.empty(3, device="meta"))
    assert fc.flops == 2 * 5 * 7 * 3


def test_roi_bound_counts_touched_pixels():
    # one 8x8 box on p2 (stride 4): a 2x2-pixel footprint a sample pair
    shapes = [(1, 16, 16, 8), (1, 8, 8, 8), (1, 4, 4, 8), (1, 2, 2, 8)]
    boxes = torch.tensor([[[8.0, 8.0, 16.0, 16.0]]])
    valid = torch.ones(1, 1, dtype=torch.bool)
    touched = work.roi_touched_bytes(shapes, 2, boxes, valid,
                                     [4, 8, 16, 32], 2)
    # samples at 1.75, 2.25, 2.75, 3.25: rows and columns 1..4
    assert touched == 4 * 4 * 8 * 2
    s = work.roi_bound_s(shapes, 2, boxes, valid, [4, 8, 16, 32], 2)
    assert math.isclose(s, (touched + 2 * 2 * 8 * 4 + 17)
                        / work.PEAK_BYTES)


def test_nms_bound_counts_kept_pairs():
    boxes = torch.tensor([[[0.0, 0, 10, 10], [1, 1, 11, 11],
                           [50, 50, 60, 60]]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    # kept: 0 and 2; pairs (0, 1), (0, 2): 2
    s = work.nms_bound_s(boxes, valid, 0.5)
    ops = work.NMS_PAIR_OPS * 2 + work.NMS_BOX_OPS * 3
    assert math.isclose(s, max((12 * 4 + 6) / work.PEAK_BYTES,
                               ops / work.PEAK_F32_FLOPS))
