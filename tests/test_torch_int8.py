"""Parity of the port's int8 operand modes of the fused layer step (kv8:
int8 cross K/V, w8: int8 weights) with the JAX reference: the quantizers bit
for bit, and the plain version (what a CPU tensor gets) against the Pallas
kernel in interpret mode (CPU, f32 storage)."""
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
from tal_asrd_tpu.ops.pallas_decode import quantize_mem_kv as j_quantize_mem_kv
from tal_asrd_tpu.ops.pallas_decode import quantize_packed as j_quantize_packed
from tal_asrd_tpu_torch.core.convert import params_to_state_dict
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.models.decoder import RZDecoderLayer
from tal_asrd_tpu_torch.ops.cuda_decode import (
    fused_layer_step,
    layer_step_plain,
    pack_layer,
    quantize_mem_kv,
    quantize_packed,
)

from tests.test_torch_helpers import seeded_like, tiny_audio, tiny_model_pair, to_numpy_tree

# the shapes of tests/test_pallas_decode_stacked.py
B, D, H, F, S, L = 4, 128, 2, 256, 32, 16
# f32 storage on both sides and the same int8 operands: only summation order
# differs. 2e-4 is the bar the Pallas kernel is held to against the flax layer.
ATOL = 2e-4
MODES = {"kv8": (True, False), "w8": (False, True), "kv8+w8": (True, True)}


@pytest.fixture(scope="module")
def layer_pair():
    jlayer = JRZDecoderLayer(d_model=D, n_head=H, dim_feedforward=F, dropout=0.0,
                             dtype=jnp.float32)
    rng = np.random.default_rng(10)
    mem = (rng.standard_normal((B, S, D)) * 0.3).astype(np.float32)
    params = seeded_like(
        jlayer.init(jax.random.PRNGKey(0), jnp.zeros((B, 1, D)), jnp.asarray(mem))["params"],
        seed=11, scalar_bump=0.5)
    tlayer = RZDecoderLayer(D, H, F, dropout=0.0).eval()
    tlayer.load_state_dict(params_to_state_dict(to_numpy_tree(params)), strict=True)
    mem_kv = jlayer.apply({"params": params}, jnp.asarray(mem),
                          method=JRZDecoderLayer.precompute_mem_kv)
    mask = np.zeros((B, S), bool)
    mask[0, -5:] = True                 # a padded tail on some lanes
    mask[2, -13:] = True
    return dict(params=params, tlayer=tlayer,
                mk=np.array(mem_kv["k"]).reshape(B, S, D),
                mv=np.array(mem_kv["v"]).reshape(B, S, D),
                bias=np.where(mask, -1e9, 0.0).astype(np.float32),
                xs=(rng.standard_normal((3, B, D)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_mem_kv_is_bit_equal_with_batch_wide_scales(layer_pair, dtype):
    p = layer_pair
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mk = torch.from_numpy(p["mk"]).to(tdt)
    mv = torch.from_numpy(p["mv"] * 3.0).to(tdt)
    ref = j_quantize_mem_kv(jnp.asarray(p["mk"], jdt), jnp.asarray(p["mv"] * 3.0, jdt))
    got = quantize_mem_kv(mk, mv)
    for name, a, r in zip(("k8", "sk", "v8", "sv"), got, ref):
        assert a.dtype == (torch.int8 if name.endswith("8") else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=name)
    assert got[1].shape == (D,)
    # one scale per channel over the whole batch: lane 0 alone quantizes
    # differently wherever another lane holds a channel's maximum
    alone = quantize_mem_kv(mk[:1], mv[:1])
    assert not torch.equal(alone[1], got[1])
    assert not torch.equal(alone[0], got[0][:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_packed_is_bit_equal(layer_pair, dtype):
    p = layer_pair
    jw = j_quantize_packed(j_pack_layer(p["params"], dtype=getattr(jnp, dtype)))
    tw = quantize_packed(pack_layer(p["tlayer"], dtype=getattr(torch, dtype)))
    for wk, sk in (("wqkv", "sqkv"), ("wso", "sso"), ("wcq", "scq"),
                   ("wco", "sco"), ("wf1", "sf1"), ("wf2", "sf2")):
        assert tw[wk].dtype == torch.int8 and tw[sk].shape == (tw[wk].shape[1],)
        np.testing.assert_array_equal(tw[wk].numpy(), np.asarray(jw[wk]), err_msg=wk)
        np.testing.assert_array_equal(tw[sk].numpy(), np.asarray(jw[sk]), err_msg=sk)
    np.testing.assert_array_equal(tw["bqkv"].numpy(), np.asarray(jw["bqkv"]))


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_plain_layer_step_matches_pallas_interpret(layer_pair, mode):
    kv8, w8 = MODES[mode]
    p = layer_pair
    # both sides take the same int8 operands (the quantizers are held bit for
    # bit above)
    tw = pack_layer(p["tlayer"], dtype=torch.float32)
    if w8:
        tw = quantize_packed(tw)
    jw = {k: jnp.asarray(t.numpy()) for k, t in tw.items()}
    t_mem = (torch.from_numpy(p["mk"]), torch.from_numpy(p["mv"]))
    t_scales = (None, None)
    if kv8:
        k8, sk, v8, sv = quantize_mem_kv(*t_mem)
        t_mem, t_scales = (k8, v8), (sk, sv)
    j_mem = tuple(jnp.asarray(t.numpy()) for t in t_mem)
    j_scales = tuple(None if t is None else jnp.asarray(t.numpy()) for t in t_scales)
    j_ck, j_cv = jnp.zeros((B, L, D)), jnp.zeros((B, L, D))
    t_ck, t_cv = torch.zeros((B, L, D)), torch.zeros((B, L, D))
    bias = torch.from_numpy(p["bias"])
    j_step = jax.jit(functools.partial(j_fused_layer_step, n_head=H, interpret=True))
    launches = fused_layer_step.launches
    for step in range(3):                   # chained: the caches carry over
        ref = j_step(jnp.asarray(p["xs"][step]), jw, j_ck, j_cv, *j_mem,
                     jnp.asarray(p["bias"]), jnp.asarray(step, jnp.int32),
                     mem_k_scale=j_scales[0], mem_v_scale=j_scales[1])
        j_ck, j_cv = ref[2], ref[3]
        with torch.no_grad():
            out = fused_layer_step(torch.from_numpy(p["xs"][step]), tw, t_ck, t_cv,
                                   *t_mem, bias, step, n_head=H,
                                   mem_k_scale=t_scales[0], mem_v_scale=t_scales[1])
        assert out[2] is t_ck and out[3] is t_cv      # caches updated in place
        for name, a, r in zip(("x_out", "attn", "cache_k", "cache_v"), out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=ATOL,
                                       err_msg=f"{mode} {name} at step {step}")
    assert fused_layer_step.launches == launches      # CPU tensors: no kernel launch


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_modes_stay_near_the_exact_step(layer_pair, mode):
    """The quantization is the only deviation: about 1 % on the K/V entries
    and 0.4 % on the weights keep the step within a small band of the
    unquantized one, which a mis-applied scale would leave far behind."""
    kv8, w8 = MODES[mode]
    p = layer_pair
    tw = pack_layer(p["tlayer"], dtype=torch.float32)
    mk, mv, bias = (torch.from_numpy(p[k]) for k in ("mk", "mv", "bias"))
    x = torch.from_numpy(p["xs"][0])
    zeros = lambda: torch.zeros((B, L, D))
    exact = layer_step_plain(x, tw, zeros(), zeros(), mk, mv, bias, 0, H)
    scales = (None, None)
    if kv8:
        mk, sk, mv, sv = quantize_mem_kv(mk, mv)
        scales = (sk, sv)
    got = layer_step_plain(x, quantize_packed(tw) if w8 else tw, zeros(), zeros(),
                           mk, mv, bias, 0, H, *scales)
    np.testing.assert_allclose(got[0].numpy(), exact[0].numpy(), rtol=0, atol=0.05)
    np.testing.assert_allclose(got[1].numpy(), exact[1].numpy(), rtol=0, atol=2e-3)


def test_int8_operands_without_scales_raise(layer_pair):
    p = layer_pair
    tw = pack_layer(p["tlayer"], dtype=torch.float32)
    x = torch.from_numpy(p["xs"][0])
    mk, mv, bias = (torch.from_numpy(p[k]) for k in ("mk", "mv", "bias"))
    k8, sk, v8, sv = quantize_mem_kv(mk, mv)
    ck, cv = torch.zeros(B, L, D), torch.zeros(B, L, D)
    with pytest.raises(ValueError):
        fused_layer_step(x, tw, ck, cv, k8, v8, bias, 0, n_head=H, mem_k_scale=sk)
    w8 = quantize_packed(tw)
    del w8["sf2"]
    with pytest.raises(ValueError):
        fused_layer_step(x, w8, ck, cv, mk, mv, bias, 0, n_head=H)
    with pytest.raises(TypeError):
        fused_layer_step(x, tw, ck, cv, k8, mv, bias, 0, n_head=H,
                         mem_k_scale=sk, mem_v_scale=sv)
    # the kernels read scales only with int8 operands: float ones with scales raise
    with pytest.raises(ValueError):
        fused_layer_step(x, tw, ck, cv, mk, mv, bias, 0, n_head=H,
                         mem_k_scale=sk, mem_v_scale=sv)
    with pytest.raises(ValueError):
        fused_layer_step(x, dict(tw, sqkv=quantize_packed(tw)["sqkv"]), ck, cv, mk, mv,
                         bias, 0, n_head=H)


@pytest.fixture(scope="module")
def decoder_pair():
    jmodel, variables, tmodel = tiny_model_pair(seed=21)
    audio, lens = tiny_audio(3)
    j_enc = jax.jit(lambda v, a, n: jmodel.apply(v, a, n, False, method=JASRModel.encode))(
        variables, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        t_enc = tmodel.encode(torch.from_numpy(audio), torch.from_numpy(lens))
    return jmodel, variables, tmodel, j_enc, t_enc


def test_int8_fused_decoder_decode_step_matches_jax(decoder_pair):
    """The per-layer decoder with kv8 and w8: weights quantized once at
    construction, K/V per layer at init_decode_state, scales passed to every
    layer step."""
    jmodel, variables, tmodel, j_enc, t_enc = decoder_pair
    jdec = JFusedASRDecoder(jmodel, interpret=True, kv8=True, w8=True)
    tdec = FusedASRDecoder(tmodel, kv8=True, w8=True)
    assert tdec.cache_beam_axis == 0 and tdec.packed[0]["wf2"].dtype == torch.int8
    j_state = jax.jit(lambda v, e: jdec.init_decode_state(v, e, 3, 8))(variables, j_enc)
    j_step = jax.jit(lambda v, tok, st: jdec.decode_step(v, tok, st))
    toks = np.random.default_rng(2).integers(0, tmodel.cfg.num_tokens, (3, 3)).astype(np.int32)
    with torch.no_grad():
        t_state = tdec.init_decode_state(t_enc, 3, 8)
        assert t_state["mem_kvs"][1]["k"].dtype == torch.int8
        assert t_state["mem_kvs"][1]["sk"].shape == (32,)
        # one set of int8 K/V for both: f32 K/V that differ in the last bit may
        # round to neighbouring int8 steps (the quantizers are held bit for bit above)
        j_state["mem_kvs"] = tuple({k: jnp.asarray(t.numpy()) for k, t in kv.items()}
                                   for kv in t_state["mem_kvs"])
        for step in range(3):
            tok = toks[:, step:step + 1]
            ref_logits, _, ref_attn, j_state = j_step(variables, jnp.asarray(tok), j_state)
            logits, _, attn, t_state = tdec.decode_step(torch.from_numpy(tok).long(), t_state)
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                       rtol=2e-4, atol=ATOL, err_msg=f"step {step}")
            np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn),
                                       rtol=0, atol=ATOL, err_msg=f"step {step}")


def test_int8_fused_decoder_prefill_matches_jax(decoder_pair):
    jmodel, variables, tmodel, j_enc, t_enc = decoder_pair
    jdec = JFusedASRDecoder(jmodel, interpret=True, kv8=True)
    tdec = FusedASRDecoder(tmodel, kv8=True)
    y = np.random.default_rng(4).integers(0, 64, size=(3, 4)).astype(np.int32)
    with torch.no_grad():
        kvs = tdec.precompute_mem_kvs(t_enc["encoder_out"])
        logits, attn, caches = tdec.decode_prefill(
            torch.from_numpy(y).long(), kvs, t_enc["encoder_padding_mask"], 9)
    # one set of int8 K/V for both sides, as in the decode-step test
    j_kvs = tuple({k: jnp.asarray(t.numpy()) for k, t in kv.items()} for kv in kvs)
    ref_logits, ref_attn, ref_caches = jax.jit(
        lambda v, tok, kv, m: jdec.decode_prefill(v, tok, kv, m, 9))(
        variables, jnp.asarray(y), j_kvs, j_enc["encoder_padding_mask"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=2e-4, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), rtol=0, atol=ATOL)
    np.testing.assert_allclose(caches[3]["v"].numpy(), np.asarray(ref_caches[3]["v"]),
                               rtol=0, atol=ATOL)
