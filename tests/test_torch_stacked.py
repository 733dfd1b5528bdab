"""Parity of the port's stacked decoder step (one launch for every layer)
with the JAX reference: `pack_decoder_stacked` bit for bit, the plain version
(what a CPU tensor gets) against the Pallas kernel in interpret mode for
every int8 mode, the stacked `FusedASRDecoder` against the JAX one, and beam
search through the stacked caches (CPU, f32)."""
import functools
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.decode.fused_step import FusedASRDecoder as JFusedASRDecoder
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu.models.decoder import RZDecoderLayer as JRZDecoderLayer
from tal_asrd_tpu.ops.pallas_decode_stacked import pack_decoder_stacked as j_pack_decoder_stacked
from tal_asrd_tpu.ops.pallas_decode_stacked import stacked_decoder_step as j_stacked_decoder_step
from tal_asrd_tpu_torch.core.convert import params_to_state_dict
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.models.decoder import RZDecoderLayer
from tal_asrd_tpu_torch.ops import cuda_decode_stacked
from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step, pack_layer, quantize_mem_kv
from tal_asrd_tpu_torch.ops.cuda_decode_stacked import (
    pack_decoder_stacked,
    stacked_decoder_step,
    stacked_step_plain,
)

from tests.test_torch_helpers import seeded_like, tiny_audio, tiny_model_pair, to_numpy_tree

# the shapes of tests/test_pallas_decode_stacked.py
B, D, H, F, S, CAP, L = 4, 128, 2, 256, 32, 16, 3
# f32 storage on both sides and the same int8 operands: only summation order
# differs. 2e-4 is the bar the Pallas kernels are held to against flax.
ATOL = 2e-4
MODES = {"none": (False, False), "w8": (False, True), "kv8": (True, False),
         "kv8+w8": (True, True)}


@pytest.fixture(scope="module")
def stack():
    jlayer = JRZDecoderLayer(d_model=D, n_head=H, dim_feedforward=F, dropout=0.0,
                             dtype=jnp.float32)
    rng = np.random.default_rng(20)
    mem = jnp.asarray((rng.standard_normal((B, S, D)) * 0.3).astype(np.float32))
    init = jlayer.init(jax.random.PRNGKey(0), jnp.zeros((B, 1, D)), mem)["params"]
    params, tlayers, mks, mvs = {}, [], [], []
    for li in range(L):
        p = seeded_like(init, seed=30 + li, scalar_bump=0.5)
        params[f"layers_{li}"] = p
        tl = RZDecoderLayer(D, H, F, dropout=0.0).eval()
        tl.load_state_dict(params_to_state_dict(to_numpy_tree(p)), strict=True)
        tlayers.append(tl)
        kv = jlayer.apply({"params": p}, mem, method=JRZDecoderLayer.precompute_mem_kv)
        mks.append(np.array(kv["k"]).reshape(B, S, D))
        mvs.append(np.array(kv["v"]).reshape(B, S, D))
    mask = np.zeros((B, S), bool)
    mask[1, -7:] = True                 # a padded tail on some lanes
    mask[3, -12:] = True
    return dict(params=params, decoder=types.SimpleNamespace(layers=tlayers),
                mk=np.stack(mks), mv=np.stack(mvs),
                bias=np.where(mask, -1e9, 0.0).astype(np.float32),
                xs=(rng.standard_normal((3, B, D)) * 0.5).astype(np.float32))


def _mem(p, kv8):
    """Stacked cross K/V (+ [L, D] scales), quantized layer by layer."""
    mk, mv = torch.from_numpy(p["mk"]), torch.from_numpy(p["mv"])
    if not kv8:
        return mk, mv, None, None
    qs = [quantize_mem_kv(mk[li], mv[li]) for li in range(L)]
    return tuple(torch.stack([q[i] for q in qs]) for i in (0, 2, 1, 3))


@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "w8"])
def test_pack_decoder_stacked_matches_jax(stack, w8):
    ref = j_pack_decoder_stacked(stack["params"], L, dtype=jnp.bfloat16, w8=w8)
    got = pack_decoder_stacked(stack["decoder"], torch.bfloat16, w8=w8)
    # the port also keeps the weights in its tensor-core order (tc_*), which
    # unpack to the [L, in, out] weights bit for bit
    tc = {k: got.pop(k) for k in cuda_decode_stacked.TC_KEYS}
    for key, t in tc.items():
        w = got[key[3:]]
        assert t.dtype == w.dtype and t.is_contiguous()
        assert torch.equal(cuda_decode_stacked.fragment_unorder(t, *w.shape[1:]), w), key
    # the reference adds all-ones scales without w8 (one TPU kernel signature);
    # the port's kernel reads scales only for int8 weights and packs none
    assert set(got) == (set(ref) if w8 else {k for k in ref if not k.startswith("s")})
    assert all(np.all(np.asarray(ref[k]) == 1) for k in set(ref) - set(got))
    for key in got:
        assert got[key].is_contiguous()
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(ref[key], np.float32), err_msg=key)
    assert got["wqkv"].dtype == (torch.int8 if w8 else torch.bfloat16)
    assert got["rw"].shape == (L, 2) and (not w8 or got["sf1"].shape == (L, F))


@pytest.mark.parametrize("mode", list(MODES))
def test_stacked_plain_matches_pallas_interpret(stack, mode):
    kv8, w8 = MODES[mode]
    p = stack
    # both sides take the same int8 operands (the quantizers are held bit for
    # bit in test_torch_int8.py and test_pack_decoder_stacked_matches_jax)
    tw = pack_decoder_stacked(p["decoder"], torch.float32, w8=w8)
    jw = {k: jnp.asarray(t.numpy()) for k, t in tw.items()}
    if not w8:          # the reference's kernel always takes (all-ones) scales
        jw.update({"s" + k[1:]: jnp.ones((L, tw[k].shape[-1]), jnp.float32)
                   for k in ("wqkv", "wso", "wcq", "wco", "wf1", "wf2")})
    tmk, tmv, tsk, tsv = _mem(p, kv8)
    jmk, jmv, jsk, jsv = (None if t is None else jnp.asarray(t.numpy())
                          for t in (tmk, tmv, tsk, tsv))
    j_step = jax.jit(functools.partial(j_stacked_decoder_step, n_head=H, interpret=True))
    j_ck, j_cv = jnp.zeros((L, B, CAP, D)), jnp.zeros((L, B, CAP, D))
    t_ck, t_cv = torch.zeros((L, B, CAP, D)), torch.zeros((L, B, CAP, D))
    bias = torch.from_numpy(p["bias"])
    launches = stacked_decoder_step.launches
    for step in range(3):                   # chained: the caches carry over
        ref = j_step(jnp.asarray(p["xs"][step]), jw, j_ck, j_cv, jmk, jmv,
                     jnp.asarray(p["bias"]), jnp.asarray(step, jnp.int32),
                     mem_k_scale=jsk, mem_v_scale=jsv)
        j_ck, j_cv = ref[2], ref[3]
        with torch.no_grad():
            out = stacked_decoder_step(torch.from_numpy(p["xs"][step]), tw, t_ck, t_cv,
                                       tmk, tmv, bias, step, n_head=H,
                                       mem_k_scale=tsk, mem_v_scale=tsv)
        assert out[2] is t_ck and out[3] is t_cv      # caches updated in place
        for name, a, r in zip(("x_out", "attn", "cache_k", "cache_v"), out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=ATOL,
                                       err_msg=f"{mode} {name} at step {step}")
    assert stacked_decoder_step.launches == launches   # CPU tensors: no kernel launch


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "kv8"])
def test_stacked_plain_matches_the_layer_step_chain(stack, kv8):
    """In f32 the two kernels' rounding points coincide up to where the kv8
    scales are applied (folded into q and after the PV sum by the layer step,
    on the K/V entries by the stacked step), which moves only f32 rounding:
    the stack equals L chained layer steps with their attn meaned."""
    p = stack
    packed = [pack_layer(tl, torch.float32) for tl in p["decoder"].layers]
    tw = pack_decoder_stacked(p["decoder"], torch.float32)
    mk, mv, sk, sv = _mem(p, kv8)
    bias = torch.from_numpy(p["bias"])
    ck, cv = torch.zeros((L, B, CAP, D)), torch.zeros((L, B, CAP, D))
    lk, lv = torch.zeros((L, B, CAP, D)), torch.zeros((L, B, CAP, D))
    for step in range(2):
        x = torch.from_numpy(p["xs"][step])
        got, attn, _, _ = stacked_step_plain(x, tw, ck, cv, mk, mv, bias, step, H, sk, sv)
        attn_sum = 0
        for li in range(L):
            x, a, _, _ = fused_layer_step(
                x, packed[li], lk[li], lv[li], mk[li], mv[li], bias, step, n_head=H,
                mem_k_scale=None if sk is None else sk[li],
                mem_v_scale=None if sv is None else sv[li])
            attn_sum = attn_sum + a
        np.testing.assert_allclose(got.numpy(), x.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(attn.numpy(), (attn_sum / L).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ck.numpy(), lk.numpy(), rtol=0, atol=1e-5)


def test_stacked_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    src = inspect.getsource(cuda_decode_stacked.stacked_decoder_step)
    assert "try:" not in src and "except" not in src
    assert src.count("stacked_step_plain(") == 1
    before = src.split("stacked_step_plain(")[0].splitlines()
    assert 'device.type == "cpu"' in before[-2]
    assert isinstance(stacked_decoder_step.launches, int)


@pytest.fixture(scope="module")
def decoder_pair():
    jmodel, variables, tmodel = tiny_model_pair(seed=21)
    audio, lens = tiny_audio(3)
    j_enc = jax.jit(lambda v, a, n: jmodel.apply(v, a, n, False, method=JASRModel.encode))(
        variables, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        t_enc = tmodel.encode(torch.from_numpy(audio), torch.from_numpy(lens))
    return jmodel, variables, tmodel, j_enc, t_enc


@pytest.mark.parametrize("mode", ["none", "kv8+w8"])
def test_stacked_fused_decoder_decode_step_matches_jax(decoder_pair, mode):
    kv8, w8 = MODES[mode]
    jmodel, variables, tmodel, j_enc, t_enc = decoder_pair
    jdec = JFusedASRDecoder(jmodel, interpret=True, kv8=kv8, w8=w8, stacked=True)
    tdec = FusedASRDecoder(tmodel, kv8=kv8, w8=w8, stacked=True)
    assert tdec.cache_beam_axis == 1 and tdec.packed["wqkv"].shape == (4, 32, 96)
    j_state = jax.jit(lambda v, e: jdec.init_decode_state(v, e, 3, 8))(variables, j_enc)
    j_step = jax.jit(lambda v, tok, st: jdec.decode_step(v, tok, st))
    toks = np.random.default_rng(2).integers(0, tmodel.cfg.num_tokens, (3, 3)).astype(np.int32)
    launches = stacked_decoder_step.launches
    with torch.no_grad():
        t_state = tdec.init_decode_state(t_enc, 3, 8)
        assert t_state["caches"]["k"].shape == (4, 3, 8, 32)
        assert t_state["mem_kvs"]["k"].dtype == (torch.int8 if kv8 else torch.float32)
        # one set of int8 K/V for both: f32 K/V that differ in the last bit may
        # round to neighbouring int8 steps (the quantizers are held bit for bit
        # in tests/test_torch_int8.py)
        j_state["mem_kvs"] = {k: jnp.asarray(t.numpy()) for k, t in t_state["mem_kvs"].items()}
        for step in range(3):
            tok = toks[:, step:step + 1]
            ref_logits, _, ref_attn, j_state = j_step(variables, jnp.asarray(tok), j_state)
            logits, spk, attn, t_state = tdec.decode_step(torch.from_numpy(tok).long(), t_state)
            assert spk is None
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                       rtol=2e-4, atol=ATOL, err_msg=f"{mode} step {step}")
            np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn),
                                       rtol=0, atol=ATOL, err_msg=f"{mode} step {step}")
    np.testing.assert_allclose(t_state["caches"]["v"].numpy(),
                               np.asarray(j_state["caches"]["v"]), rtol=0, atol=ATOL)
    assert t_state["index"] == 3 and stacked_decoder_step.launches == launches


def test_stacked_kv8_prefill_matches_jax(decoder_pair):
    jmodel, variables, tmodel, j_enc, t_enc = decoder_pair
    jdec = JFusedASRDecoder(jmodel, interpret=True, kv8=True, stacked=True)
    tdec = FusedASRDecoder(tmodel, kv8=True, stacked=True)
    y = np.random.default_rng(4).integers(0, 64, size=(3, 4)).astype(np.int32)
    j_kvs = jdec.precompute_mem_kvs(variables, j_enc["encoder_out"])
    with torch.no_grad():
        kvs = tdec.precompute_mem_kvs(t_enc["encoder_out"])
        logits, attn, caches = tdec.decode_prefill(
            torch.from_numpy(y).long(), kvs, t_enc["encoder_padding_mask"], 9)
    assert kvs["k"].dtype == torch.int8 and kvs["sk"].shape == (4, 32)
    # each side quantizes its own f32 K/V, which may differ in the last bit:
    # an int8 value may then sit one step over
    assert np.abs(kvs["k"].numpy().astype(int) - np.asarray(j_kvs["k"]).astype(int)).max() <= 1
    np.testing.assert_allclose(kvs["sk"].numpy(), np.asarray(j_kvs["sk"]), rtol=1e-6, atol=0)
    # the prefill itself from one set of int8 K/V
    ref_logits, ref_attn, ref_caches = jax.jit(
        lambda v, tok, kv, m: jdec.decode_prefill(v, tok, kv, m, 9))(
        variables, jnp.asarray(y), {k: jnp.asarray(t.numpy()) for k, t in kvs.items()},
        j_enc["encoder_padding_mask"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=2e-4, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), rtol=0, atol=ATOL)
    assert caches["k"].shape == (4, 3, 9, 32)
    np.testing.assert_allclose(caches["k"].numpy(), np.asarray(ref_caches["k"]),
                               rtol=0, atol=ATOL)


def test_beam_search_through_stacked_caches(decoder_pair):
    """Beam 3 reorders the stacked caches [L, B*K, cap, D] along axis 1: the
    tokens equal the per-layer decoder's and the unfused model's."""
    tmodel, t_enc = decoder_pair[2], decoder_pair[4]
    cfg = tmodel.cfg
    spec = BeamSearchSpec(beam_size=3, max_new_tokens=6, eos_id=-1,
                          vocab_size=cfg.num_tokens, text_vocab_size=cfg.vocab_size,
                          force_output=True)
    prime = torch.ones((3, 1), dtype=torch.long)
    with torch.no_grad():
        out = {name: beam_search(m, t_enc, prime, spec) for name, m in (
            ("unfused", tmodel), ("per_layer", FusedASRDecoder(tmodel)),
            ("stacked", FusedASRDecoder(tmodel, stacked=True)))}
    for name in ("per_layer", "stacked"):
        np.testing.assert_array_equal(out[name]["tokens"].numpy(),
                                      out["unfused"]["tokens"].numpy(), err_msg=name)
        np.testing.assert_allclose(out[name]["scores"].numpy(),
                                   out["unfused"]["scores"].numpy(), rtol=0, atol=1e-4)
