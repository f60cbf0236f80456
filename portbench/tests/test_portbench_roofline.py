"""The roofline arithmetic against a hand count on one bucket shape."""
import numpy as np
import pytest

from portbench import roofline


def test_project_bound_by_hand():
    # one K = 2 launch: 1,000 geometric-mean pools of width 2 and 200
    # constant-sum pools of width 2, float32, ProjectionConfig(24, 4)
    gm = np.full(1000, 2)
    cs = np.full(200, 2)
    bytes_ = 4 * (1000 * (8 * 2 + 3) + 200 * (7 * 2 + 2))  # 88,800
    flops = 60 * 28 * 2 * 1200  # 4,032,000
    assert bytes_ == 88_800 and flops == 4_032_000
    want = max(bytes_ / 3.35e12, flops / 67e12)  # operations bound: 60.18 ns
    assert roofline.project_bound_s(gm, cs, "float") == pytest.approx(want)
    assert want == pytest.approx(flops / 67e12)


def test_pools_go_to_the_fewest_lanes_that_hold_them():
    net = {"width": np.array([2, 3, 4, 2, 3]), "kind": np.array([0, 1, 0, 1, 0])}
    g = roofline.pools_by_lanes(net, [4, 2])
    assert g[2][0].tolist() == [2] and g[2][1].tolist() == [2]
    assert g[4][0].tolist() == [4, 3] and g[4][1].tolist() == [3]
    g = roofline.pools_by_lanes(net, [4])
    assert sorted(g[4][0].tolist() + g[4][1].tolist()) == [2, 2, 3, 3, 4]


def test_kernel_names_give_dtype_and_lanes():
    name = "void (anonymous namespace)::project_kernel<double, 4>((anonymous namespace)::Table<double>, int, int, int)"
    assert roofline.variant(name, "project_kernel") == ("double", 4)
    assert roofline.variant(name, "fused_delta_kernel") is None
