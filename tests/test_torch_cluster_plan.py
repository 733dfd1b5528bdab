"""CPU tests of what surrounds the stacked decoder kernel K3 on the card: its
launch plan (lanes per cluster, CTAs per cluster, clusters) and the
tensor-core order of its packed weights. Neither needs a GPU."""
import numpy as np
import pytest
import torch

from tal_asrd_tpu_torch.ops.cuda_decode_stacked import (
    MAX_GROUP,
    LaunchPlan,
    fragment_order,
    fragment_unorder,
    stacked_launch_plan,
)


@pytest.mark.parametrize("sm_count", [132, 114, 8])
def test_launch_plan_covers_every_lane_once(sm_count):
    for b in range(1, 257):
        plan = stacked_launch_plan(b, sm_count)
        groups = plan.groups(b)
        lanes = [lane for g in groups for lane in g]
        assert lanes == list(range(b)), (b, plan)
        assert all(1 <= len(g) <= plan.group <= MAX_GROUP for g in groups), (b, plan)
        assert plan.clusters == len(groups)
        # every cluster fits on the card at once, or the plan says it runs in waves
        assert plan.ctas <= sm_count or plan.waves > 1, (b, plan)
        assert plan.waves == -(-plan.clusters // plan.slots)


def test_launch_plan_fills_the_card_at_the_serving_shapes():
    # the occupancy an H100 reports for K3: 7 clusters of 16 CTAs, 15 of 8
    h100 = {16: 7, 8: 15}
    two_x = stacked_launch_plan(32, 132, h100)
    assert (two_x.group, two_x.cluster, two_x.clusters, two_x.ctas) == (5, 16, 7, 112)
    assert sorted(len(g) for g in two_x.groups(32)) == [4] * 3 + [5] * 4
    one_x = stacked_launch_plan(8, 132, h100)
    assert (one_x.group, one_x.cluster, one_x.clusters) == (2, 16, 7)
    assert stacked_launch_plan(40, 132, h100) == LaunchPlan(6, 16, 7, 7)
    # more than MAX_GROUP lanes a cluster of 16: the next size
    assert stacked_launch_plan(100, 132, h100) == LaunchPlan(7, 8, 15, 15)
    # without the occupancy: sm_count // C slots
    assert stacked_launch_plan(32, 132) == LaunchPlan(4, 16, 8, 8)
    # more lanes than fit in one wave: MAX_GROUP lanes a cluster, fewest waves
    big = stacked_launch_plan(256, 132, h100)
    assert (big.group, big.cluster, big.waves) == (MAX_GROUP, 8, 3)
    with pytest.raises(RuntimeError):
        stacked_launch_plan(4, 132, slots={16: 0, 8: 0})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_fragment_order_round_trips_and_places_the_mma_fragment(dtype):
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.integers(-127, 128, (2, 64, 48)).astype(np.float32)).to(dtype)
    f = fragment_order(w)
    assert f.shape == (2, 64 * 48) and f.dtype == dtype
    assert torch.equal(fragment_unorder(f, 64, 48), w)
    # thread lane = 4 g + t holds A[row][k] of the 16-column tile: value e of
    # a k-step at row g + 8 * (e // 2 % 2), k 2 t + e % 2 + 8 * (e // 4)
    kpack = 2 if dtype == torch.int8 else 1
    tile, group, lane = 2, 1, 13
    g, t = lane // 4, lane % 4
    base = ((tile * (64 // (16 * kpack)) + group) * 32 + lane) * 8 * kpack
    for e in range(8 * kpack):
        e8, step = e % 8, e // 8
        col = 16 * tile + g + 8 * (e8 // 2 % 2)
        k = 16 * kpack * group + 16 * step + 2 * t + e8 % 2 + 8 * (e8 // 4)
        assert f[1, base + e] == w[1, k, col], e
    with pytest.raises(ValueError):
        fragment_order(w[:, :40])
