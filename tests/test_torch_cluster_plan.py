"""CPU tests of what surrounds the cluster kernel of K1 and K3 on the card:
its launch plan (lanes per cluster, CTAs per cluster, clusters), the
tensor-core order of the packed weights, the operand checks and the shape
rule. None needs a GPU."""
import types

import numpy as np
import pytest
import torch

from tal_asrd_tpu_torch.ops.cuda_decode import (
    TC_KEYS,
    WEIGHT_KEYS,
    check_cluster_shape,
    check_operands,
    pack_layer,
    quantize_packed,
)
from tal_asrd_tpu_torch.ops.cuda_decode_stacked import (
    MAX_GROUP,
    LaunchPlan,
    fragment_order,
    fragment_unorder,
    pack_decoder_stacked,
    stacked_launch_plan,
)


@pytest.mark.parametrize("sm_count", [132, 114, 8])
def test_launch_plan_covers_every_lane_once(sm_count):
    # every batch up to 256, and the eval CLI's beam lanes (64 and 54 segments x 5)
    for b in list(range(1, 257)) + [270, 320]:
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
    # the eval CLI's beam-5 lanes: 320 (a batch of 64) and 270 (the tail of
    # 54) in clusters of MAX_GROUP lanes, 3 waves of the 15 slots of 8 CTAs
    assert stacked_launch_plan(320, 132, h100) == LaunchPlan(MAX_GROUP, 8, 40, 15)
    assert stacked_launch_plan(270, 132, h100) == LaunchPlan(MAX_GROUP, 8, 34, 15)
    for b in (270, 320):
        plan = stacked_launch_plan(b, 132, h100)
        assert plan.waves == 3 and sorted({len(g) for g in plan.groups(b)}) in ([7, 8], [8])
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


def _decoder(d=64, h=4, f=128, n_layers=2):
    from tal_asrd_tpu_torch.models.decoder import RZDecoderLayer
    torch.manual_seed(3)
    return types.SimpleNamespace(
        layers=[RZDecoderLayer(d, h, f, dropout=0.0).eval() for _ in range(n_layers)])


@pytest.mark.parametrize("w8", [False, True], ids=["float", "w8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_layers_carry_their_weights_in_fragment_order(dtype, w8):
    """pack_layer (bf16) and quantize_packed (int8) store each weight also in
    the tensor cores' order, as stack_packed does for every layer of K3."""
    dec = _decoder()
    packs = [pack_layer(layer, dtype) for layer in dec.layers]
    if w8:
        packs = [quantize_packed(w) for w in packs]
    stacked = pack_decoder_stacked(dec, dtype, w8=w8)
    for li, w in enumerate(packs):
        if dtype == torch.float32 and not w8:     # the f32 kernel reads [in, out]
            assert not any(k in w for k in TC_KEYS) and not any(k in stacked for k in TC_KEYS)
            continue
        for tk, wk in zip(TC_KEYS, WEIGHT_KEYS):
            k, n = w[wk].shape
            assert w[tk].dtype == w[wk].dtype and w[tk].shape == (k * n,), tk
            assert torch.equal(w[tk], fragment_order(w[wk])), tk
            assert torch.equal(fragment_unorder(w[tk], k, n), w[wk]), tk
            assert torch.equal(stacked[tk][li], w[tk]), (li, tk)


def test_stale_fragments_are_refused():
    """A weight replaced without its fragments (an int8 wqkv beside the bf16
    tc_wqkv), or fragments left out, is refused before any launch."""
    b, d, s, cap, h = 2, 64, 8, 4, 4
    w = pack_layer(_decoder().layers[0], torch.bfloat16)
    x = torch.zeros((b, d), dtype=torch.bfloat16)
    ck, cv = (torch.zeros((b, cap, d), dtype=torch.bfloat16) for _ in range(2))
    mk, mv = (torch.zeros((b, s, d), dtype=torch.bfloat16) for _ in range(2))
    bias = torch.zeros((b, s))

    def operands(weights, w8):
        return check_operands(x, weights, ck, cv, mk, mv, bias, 1, h, None, None, w8, False)

    assert operands(w, False) == (b, d, 128, h, cap, s, 1, 1)
    q = quantize_packed(w)
    assert operands(q, True) == (b, d, 128, h, cap, s, 1, 1)
    with pytest.raises(TypeError):            # tc_* still the bf16 fragments
        operands(dict(q, **{k: w[k] for k in TC_KEYS}), True)
    with pytest.raises(ValueError):
        operands({k: v for k, v in w.items() if k != "tc_wf2"}, False)


@pytest.mark.parametrize("case", [
    ("2x", 512, 2048, 4, True), ("1x", 256, 1024, 4, True),
    ("D % 32", 48, 192, 3, False), ("dh < 16", 64, 256, 8, False),
    ("dh = 256", 1024, 4096, 4, False)], ids=lambda c: c[0])
def test_one_shape_rule_for_k1_and_k3(case):
    """Both wrappers check shapes with one rule, the C kernel's: D and F in
    32s and 16 <= head_dim <= 192 (dh = 256 would pass a looser check and then
    fail at launch), in every storage type and int8 mode."""
    from tal_asrd_tpu_torch.ops import cuda_decode_stacked
    assert cuda_decode_stacked.launch_step.__module__ == check_cluster_shape.__module__
    _, d, f, h, ok = case
    for dtype in (torch.float32, torch.bfloat16):
        for kv8 in (False, True):
            if ok:
                check_cluster_shape(dtype, kv8, d, f, h)
            else:
                with pytest.raises(ValueError):
                    check_cluster_shape(dtype, kv8, d, f, h)
