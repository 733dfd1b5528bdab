"""The port's utils/flops.py against the JAX package's: every function at
the 1x, 2x and a tiny configuration with every beam / kv8 / w8 flag (the
same float arithmetic: rtol 1e-12), the roofline at v5e's peaks passed as
numbers, the H100 defaults; and PyTorch's FlopCounterMode on the port's
tiny ASRModel.encode and one decode step against XLA's cost analysis, at
tests/test_flops.py's bands."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tal_asrd_tpu.core.config import ModelConfig as JModelConfig
from tal_asrd_tpu.models import ASRModel as JASRModel
from tal_asrd_tpu.utils import flops as jfl
from tal_asrd_tpu_torch.core.config import ModelConfig
from tal_asrd_tpu_torch.core.convert import load_into
from tal_asrd_tpu_torch.models import ASRModel
from tal_asrd_tpu_torch.utils import flops as fl

CONFIGS = {"1x": dict(model_type="1x", num_speakers=8, vocab_size=300),
           "2x": dict(model_type="2x", num_speakers=64, vocab_size=10000),
           "tiny": dict(model_type="1x", num_speakers=4, vocab_size=100,
                        tds_depths=(1, 1, 1), dropout=0.0, max_positions=64)}
T = int(28.56 * 16000)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_function_equals_jax(name):
    c, j = ModelConfig(**CONFIGS[name]), JModelConfig(**CONFIGS[name])
    same = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for t in (16000, 32000, T):
        assert fl.mel_frames(t) == jfl.mel_frames(t)
        for b in (1, 8, 32):
            same(fl.encode_flops(c, b, t), jfl.encode_flops(j, b, t))
            same(fl.encode_bytes(c, b, t), jfl.encode_bytes(j, b, t))
            for beam in (1, 5):
                same(fl.greedy_decode_flops(c, b, t, 16, beam=beam),
                     jfl.greedy_decode_flops(j, b, t, 16, beam=beam))
    for b, hist, enc in ((1, 1, 340), (32, 96, 340), (8, 40, 21)):
        same(fl.decode_step_flops(c, b, hist, enc), jfl.decode_step_flops(j, b, hist, enc))
        same(fl.prefill_flops(c, b, enc), jfl.prefill_flops(j, b, enc))
        same(fl.prefill_bytes(c, b, enc), jfl.prefill_bytes(j, b, enc))
        for kv8 in (False, True):
            for w8 in (False, True):
                same(fl.decode_step_bytes(c, b, hist, enc, kv8=kv8, w8=w8),
                     jfl.decode_step_bytes(j, b, hist, enc, kv8=kv8, w8=w8))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("flags", [dict(), dict(beam=5), dict(kv8=True), dict(w8=True),
                                   dict(kv8=True, w8=True)])
def test_roofline_equals_jax_at_the_same_peaks(name, flags):
    """At v5e's peaks, passed as numbers, the roofline is JAX's to the last
    digit; by default the port's is at the H100's."""
    c, j = ModelConfig(**CONFIGS[name]), JModelConfig(**CONFIGS[name])
    mine = fl.greedy_decode_roofline(c, 8, T, 24, peak=197e12, bw=819e9, **flags)
    ref = jfl.greedy_decode_roofline(j, 8, T, 24, **flags)
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-12, atol=0, err_msg=k)
    h100 = fl.greedy_decode_roofline(c, 8, T, 24, **flags)
    assert h100["flops"] == mine["flops"] and h100["bytes"] == mine["bytes"]
    expect = max(fl.encode_flops(c, 8, T) / 989e12, fl.encode_bytes(c, 8, T) / 3.35e12)
    assert h100["encode_sol_secs"] == pytest.approx(expect, rel=1e-12)


def test_the_h100_peaks():
    assert fl.PEAK_BYTES_PER_S == 3.35e12
    assert fl.PEAK_FLOPS == {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
    assert not hasattr(fl, "PEAK_BF16_V5E") and not hasattr(fl, "HBM_BW_V5E")


# ---------------------------------------------------------------------------
# FlopCounterMode against XLA's cost analysis (tests/test_flops.py's bands)
# ---------------------------------------------------------------------------
CFG = CONFIGS["tiny"]


def _cost_flops(jitted, *args):
    cost = jitted.lower(*args).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return float(cost["flops"])


@pytest.fixture(scope="module")
def xla_costs():
    """XLA's flops of the tiny model's encode and one cached decode step
    (batch 2, 2 s, a 16-token buffer), with its parameters."""
    model = JASRModel(JModelConfig(**CFG))
    t = 2 * 16000
    audio = jax.random.normal(jax.random.PRNGKey(0), (2, t)) * 0.1
    lens = jnp.full((2,), t, jnp.int32)
    variables = model.init({"params": jax.random.PRNGKey(0)}, audio,
                           jnp.zeros((2, 4), jnp.int32), lens)
    encode = jax.jit(lambda v, a, l: model.apply(v, a, l, False, method=JASRModel.encode))
    enc = model.apply(variables, audio, lens, False, method=JASRModel.encode)
    state = model.apply(variables, enc, 2, 16, method=JASRModel.init_decode_state)
    step = jax.jit(lambda v, y, st: model.apply(v, y, st, method=JASRModel.decode_step))
    y = jnp.ones((2, 1), jnp.int32)
    return {"encode": _cost_flops(encode, variables, audio, lens),
            "step": _cost_flops(step, variables, y, state),
            "enc_len": int(enc["encoder_out"].shape[1]),
            "params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "audio": np.array(audio), "lens": np.array(lens)}


def _port_model(xla_costs):
    model = ASRModel(ModelConfig(**CFG), dtype=torch.float32, device="cpu")
    return load_into(model, xla_costs["params"]).eval()


def test_flop_counter_on_encode_against_xla(xla_costs):
    model = _port_model(xla_costs)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.encode(torch.from_numpy(xla_costs["audio"]), torch.from_numpy(xla_costs["lens"]))
    counted = counter.get_total_flops()
    analytic = fl.encode_flops(ModelConfig(**CFG), 2, 2 * 16000)
    assert 0.7 < xla_costs["encode"] / counted < 1.6, (xla_costs["encode"], counted)
    assert 0.7 < counted / analytic < 1.3, (counted, analytic)


def test_flop_counter_on_a_decode_step_against_xla(xla_costs):
    model = _port_model(xla_costs)
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(xla_costs["audio"]),
                           torch.from_numpy(xla_costs["lens"]))
        state = model.init_decode_state(enc, 2, 16)
        assert enc["encoder_out"].shape[1] == xla_costs["enc_len"]
        with FlopCounterMode(display=False) as counter:
            model.decode_step(torch.ones((2, 1), dtype=torch.long), state)
    counted = counter.get_total_flops()
    # the cached graph attends over the full static buffer: hist = 16
    analytic = fl.decode_step_flops(ModelConfig(**CFG), 2, 16, xla_costs["enc_len"])
    assert 0.6 < xla_costs["step"] / counted < 1.7, (xla_costs["step"], counted)
    assert 0.6 < counted / analytic < 1.7, (counted, analytic)
