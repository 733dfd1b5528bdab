"""Parity of the port's fused layer step (its plain version, which is what a
CPU tensor gets) with the Pallas kernel in interpret mode, and of
FusedASRDecoder.decode_step / decode_prefill with the JAX FusedASRDecoder (CPU, f32)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.decode.fused_step import FusedASRDecoder as JFusedASRDecoder
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu.models.decoder import RZDecoderLayer as JRZDecoderLayer
from tal_asrd_tpu.ops.pallas_decode import fused_layer_step as j_fused_layer_step
from tal_asrd_tpu.ops.pallas_decode import pack_layer as j_pack_layer
from tal_asrd_tpu_torch.core.convert import params_to_state_dict
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.models.decoder import RZDecoderLayer
from tal_asrd_tpu_torch.ops.cuda_decode import (
    fused_layer_step,
    layer_step_plain,
    pack_decoder,
    pack_layer,
)

from tests.test_torch_helpers import seeded_like, tiny_audio, tiny_model_pair, to_numpy_tree

# the shapes of tests/test_pallas_decode.py
B, D, H, F, S, L = 4, 128, 2, 256, 32, 16
# f32 storage on both sides: only summation order differs. 2e-4 is the bar
# the Pallas kernel itself is held to against the flax layer.
ATOL = 2e-4


@pytest.fixture(scope="module")
def layer_pair():
    jlayer = JRZDecoderLayer(d_model=D, n_head=H, dim_feedforward=F, dropout=0.0,
                             dtype=jnp.float32)
    rng = np.random.default_rng(0)
    mem = (rng.standard_normal((B, S, D)) * 0.3).astype(np.float32)
    params = seeded_like(
        jlayer.init(jax.random.PRNGKey(0), jnp.zeros((B, 1, D)), jnp.asarray(mem))["params"],
        seed=1, scalar_bump=0.5)
    tlayer = RZDecoderLayer(D, H, F, dropout=0.0).eval()
    tlayer.load_state_dict(params_to_state_dict(to_numpy_tree(params)), strict=True)
    mem_kv = jlayer.apply({"params": params}, jnp.asarray(mem),
                          method=JRZDecoderLayer.precompute_mem_kv)
    mk = np.array(mem_kv["k"]).reshape(B, S, D)
    mv = np.array(mem_kv["v"]).reshape(B, S, D)
    mask = np.zeros((B, S), bool)
    mask[:, -5:] = True
    mask[1, -11:] = True
    bias = np.where(mask, -1e9, 0.0).astype(np.float32)
    xs = (rng.standard_normal((3, B, D)) * 0.5).astype(np.float32)
    return dict(jlayer=jlayer, params=params, tlayer=tlayer, mk=mk, mv=mv,
                bias=bias, xs=xs, mem=mem)


def test_pack_layer_matches_jax(layer_pair):
    jw = j_pack_layer(layer_pair["params"], dtype=jnp.float32)
    tw = pack_layer(layer_pair["tlayer"], dtype=torch.float32)
    for key in ("wqkv", "bqkv", "wso", "bso", "wcq", "bcq", "wco", "bco",
                "wf1", "bf1", "wf2", "bf2", "resweight", "resweight_src"):
        np.testing.assert_array_equal(tw[key].numpy(), np.asarray(jw[key]), err_msg=key)
    assert tw["wqkv"].is_contiguous() and tw["rw"].shape == (2,)


def test_plain_layer_step_matches_pallas_interpret(layer_pair):
    p = layer_pair
    jw = j_pack_layer(p["params"], dtype=jnp.float32)
    tw = pack_layer(p["tlayer"], dtype=torch.float32)
    j_ck = jnp.zeros((B, L, D))
    j_cv = jnp.zeros((B, L, D))
    t_ck = torch.zeros((B, L, D))
    t_cv = torch.zeros((B, L, D))
    mk, mv, bias = (torch.from_numpy(p[k]) for k in ("mk", "mv", "bias"))
    j_step = jax.jit(functools.partial(j_fused_layer_step, n_head=H, interpret=True))
    launches = fused_layer_step.launches
    for step in range(3):
        ref = j_step(
            jnp.asarray(p["xs"][step]), jw, j_ck, j_cv, jnp.asarray(p["mk"]),
            jnp.asarray(p["mv"]), jnp.asarray(p["bias"]),
            jnp.asarray(step, jnp.int32))
        j_ck, j_cv = ref[2], ref[3]
        with torch.no_grad():
            out = fused_layer_step(torch.from_numpy(p["xs"][step]), tw, t_ck, t_cv,
                                   mk, mv, bias, step, n_head=H)
        assert out[2] is t_ck and out[3] is t_cv      # caches updated in place
        for name, a, b in zip(("x_out", "attn", "cache_k", "cache_v"), out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL,
                                       err_msg=f"{name} at step {step}")
    assert fused_layer_step.launches == launches      # CPU tensors: no kernel launch


def test_plain_layer_step_matches_port_layer_with_stale_cache(layer_pair):
    """Positions > index may hold stale rows: they must not leak in."""
    p = layer_pair
    tw = pack_layer(p["tlayer"], dtype=torch.float32)
    rng = np.random.default_rng(3)
    stale = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    ck, cv = stale.clone(), stale.clone()
    cache = {"k": torch.zeros(B, L, H, D // H), "v": torch.zeros(B, L, H, D // H)}
    mem_kv = {"k": torch.from_numpy(p["mk"]).reshape(B, S, H, D // H),
              "v": torch.from_numpy(p["mv"]).reshape(B, S, H, D // H)}
    mask = torch.from_numpy(p["bias"] < 0)
    with torch.no_grad():
        for step in range(3):
            x = torch.from_numpy(p["xs"][step])
            ref, ref_attn, cache = p["tlayer"](
                x[:, None], None, memory_key_padding_mask=mask, self_cache=cache,
                cache_index=step, mem_kv=mem_kv)
            out, attn, ck, cv = layer_step_plain(
                x, tw, ck, cv, torch.from_numpy(p["mk"]), torch.from_numpy(p["mv"]),
                torch.from_numpy(p["bias"]), step, H)
            np.testing.assert_allclose(out.numpy(), ref[:, 0].numpy(), rtol=0, atol=ATOL)
            np.testing.assert_allclose(attn.numpy(), ref_attn[:, 0].numpy(), rtol=0, atol=ATOL)


def test_bf16_plain_layer_step_rounds_like_storage(layer_pair):
    """bf16 storage: outputs come back in bf16 and stay near the f32 run."""
    p = layer_pair
    w32 = pack_layer(p["tlayer"], dtype=torch.float32)
    w16 = pack_layer(p["tlayer"], dtype=torch.bfloat16)
    args32 = [torch.from_numpy(p[k]) for k in ("mk", "mv")]
    x = torch.from_numpy(p["xs"][0])
    bias = torch.from_numpy(p["bias"])
    o32 = layer_step_plain(x, w32, torch.zeros(B, L, D), torch.zeros(B, L, D),
                           *args32, bias, 0, H)
    o16 = layer_step_plain(
        x.bfloat16(), w16, torch.zeros(B, L, D, dtype=torch.bfloat16),
        torch.zeros(B, L, D, dtype=torch.bfloat16),
        *[a.bfloat16() for a in args32], bias, 0, H)
    assert o16[0].dtype == torch.bfloat16 and o16[1].dtype == torch.float32
    assert o16[2].dtype == torch.bfloat16
    # bf16 keeps 8 bits: O(1) activations agree to a few 1e-2
    np.testing.assert_allclose(o16[0].float().numpy(), o32[0].numpy(), rtol=0, atol=6e-2)
    np.testing.assert_allclose(o16[1].numpy(), o32[1].numpy(), rtol=0, atol=5e-3)


def test_int8_modes_are_not_ported(layer_pair):
    """The int8 modes are ported now (tests/test_torch_int8.py): what the
    wrapper still refuses is an int8 operand without its scales and an index
    outside the cache."""
    p = layer_pair
    tw = pack_layer(p["tlayer"], dtype=torch.float32)
    x = torch.from_numpy(p["xs"][0])
    ck, cv = torch.zeros(B, L, D), torch.zeros(B, L, D)
    mk, mv, bias = (torch.from_numpy(p[k]) for k in ("mk", "mv", "bias"))
    with pytest.raises(ValueError):
        fused_layer_step(x, tw, ck, cv, mk.to(torch.int8), mv.to(torch.int8), bias, 0,
                         n_head=H)
    w8 = dict(tw, wqkv=tw["wqkv"].to(torch.int8))
    with pytest.raises(TypeError):                  # int8 and float weights mixed
        fused_layer_step(x, w8, ck, cv, mk, mv, bias, 0, n_head=H)
    with pytest.raises(ValueError):
        fused_layer_step(x, tw, ck, cv, mk, mv, bias, L, n_head=H)   # index past the cache


@pytest.fixture(scope="module")
def decoder_pair():
    jmodel, variables, tmodel = tiny_model_pair(seed=21)
    audio, lens = tiny_audio(3)
    j_enc = jmodel.apply(variables, jnp.asarray(audio), jnp.asarray(lens), False,
                         method=JASRModel.encode)
    with torch.no_grad():
        t_enc = tmodel.encode(torch.from_numpy(audio), torch.from_numpy(lens))
    return jmodel, variables, tmodel, j_enc, t_enc


def test_fused_decoder_decode_step_matches_jax(decoder_pair):
    jmodel, variables, tmodel, j_enc, t_enc = decoder_pair
    jdec = JFusedASRDecoder(jmodel, interpret=True)
    tdec = FusedASRDecoder(tmodel)
    assert len(tdec.packed) == 4                       # packed once, at construction
    j_state = jax.jit(lambda v, e: jdec.init_decode_state(v, e, 3, 8))(variables, j_enc)
    j_step = jax.jit(lambda v, tok, st: jdec.decode_step(v, tok, st))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tmodel.cfg.num_tokens, size=(3, 3)).astype(np.int32)
    with torch.no_grad():
        t_state = tdec.init_decode_state(t_enc, 3, 8)
        u_state = tmodel.init_decode_state(t_enc, 3, 8)
        for step in range(3):
            tok = toks[:, step:step + 1]
            ref_logits, _, ref_attn, j_state = j_step(variables, jnp.asarray(tok), j_state)
            logits, spk, attn, t_state = tdec.decode_step(torch.from_numpy(tok).long(), t_state)
            u_logits, _, u_attn, u_state = tmodel.decode_step(
                torch.from_numpy(tok).long(), u_state)
            assert spk is None
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                       rtol=2e-4, atol=ATOL, err_msg=f"step {step}")
            np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn),
                                       rtol=0, atol=ATOL, err_msg=f"step {step}")
            # and the port's fused decoder agrees with the port's unfused model
            np.testing.assert_allclose(logits.numpy(), u_logits.numpy(), rtol=2e-4, atol=ATOL)
            np.testing.assert_allclose(attn.numpy(), u_attn.numpy(), rtol=0, atol=ATOL)
    assert t_state["index"] == 3 and t_state["caches"][0]["k"].shape == (3, 8, 32)


def test_fused_decoder_prefill_matches_jax(decoder_pair):
    jmodel, variables, tmodel, j_enc, t_enc = decoder_pair
    jdec = JFusedASRDecoder(jmodel, interpret=True)
    tdec = FusedASRDecoder(tmodel)
    y = np.random.default_rng(4).integers(0, 64, size=(3, 4)).astype(np.int32)
    j_kvs = jdec.precompute_mem_kvs(variables, j_enc["encoder_out"])
    ref_logits, ref_attn, ref_caches = jax.jit(
        lambda v, tok, kvs, m: jdec.decode_prefill(v, tok, kvs, m, 9))(
        variables, jnp.asarray(y), j_kvs, j_enc["encoder_padding_mask"])
    with torch.no_grad():
        kvs = tdec.precompute_mem_kvs(t_enc["encoder_out"])
        logits, attn, caches = tdec.decode_prefill(
            torch.from_numpy(y).long(), kvs, t_enc["encoder_padding_mask"], 9)
    np.testing.assert_allclose(kvs[2]["k"].numpy(), np.asarray(j_kvs[2]["k"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=2e-4, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), rtol=0, atol=ATOL)
    assert caches[1]["k"].shape == (3, 9, 32)
    np.testing.assert_allclose(caches[1]["k"].numpy(), np.asarray(ref_caches[1]["k"]),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("flag", ["kv8", "w8", "stacked"])
def test_fused_decoder_unported_modes_raise(decoder_pair, flag):
    """The three flags that raised before their kernels were ported now build
    a decoder whose state has the mode's layout (their parity with the JAX
    decoder is in tests/test_torch_int8.py and tests/test_torch_stacked.py)."""
    dec = FusedASRDecoder(decoder_pair[2], **{flag: True})
    with torch.no_grad():
        state = dec.init_decode_state(decoder_pair[4], 3, 8)
    if flag == "stacked":
        assert dec.cache_beam_axis == 1 and state["caches"]["k"].shape == (4, 3, 8, 32)
    elif flag == "kv8":
        assert state["mem_kvs"][0]["k"].dtype == torch.int8 and "sk" in state["mem_kvs"][0]
    else:
        assert dec.packed[0]["wqkv"].dtype == torch.int8 and "sqkv" in dec.packed[0]


def test_pack_decoder_packs_every_layer(decoder_pair):
    packed = pack_decoder(decoder_pair[2].decoder, torch.bfloat16)
    assert len(packed) == 4
    assert packed[0]["wqkv"].dtype == torch.bfloat16 and packed[0]["bqkv"].dtype == torch.float32
    assert packed[0]["wf1"].shape == (32, 128) and packed[0]["wf2"].shape == (128, 32)


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "stacked"])
def test_fused_decoder_rebuilds_the_pad_bias_when_the_mask_changes(decoder_pair, stacked):
    """A state whose mask is swapped between steps (dict(state, mask=...), as a
    window shift does) decodes as the unfused model does with the same
    masks: the pad bias carried in the state follows the new mask, and a
    None mask gives no padding."""
    _, _, tmodel, _, t_enc = decoder_pair
    dec = FusedASRDecoder(tmodel, stacked=stacked)
    s = t_enc["encoder_out"].shape[1]
    first = t_enc["encoder_padding_mask"]
    second = torch.zeros_like(first)
    second[:, s // 2:] = True                          # half of every window padded
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tmodel.cfg.num_tokens, size=(3, 4))).long()
    with torch.no_grad():
        f_state = dec.init_decode_state(t_enc, 3, 8)
        u_state = tmodel.init_decode_state(t_enc, 3, 8)
        for step, mask in enumerate((first, second, second, None)):
            f_state, u_state = dict(f_state, mask=mask), dict(u_state, mask=mask)
            f_logits, _, f_attn, f_state = dec.decode_step(toks[:, step:step + 1], f_state)
            u_logits, _, u_attn, u_state = tmodel.decode_step(toks[:, step:step + 1], u_state)
            np.testing.assert_allclose(f_logits.numpy(), u_logits.numpy(), rtol=2e-4,
                                       atol=ATOL, err_msg=f"step {step}")
            np.testing.assert_allclose(f_attn.numpy(), u_attn.numpy(), rtol=0, atol=ATOL,
                                       err_msg=f"step {step}")
            if mask is not None:
                assert float(f_attn[mask].abs().max()) == 0.0
