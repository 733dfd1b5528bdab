"""Parity of the PyTorch port's unfused decoder and model with the JAX
package (CPU, float32, tiny size): teacher-forced logits, a cached
decode_step chain with a pad mask, prefill, and the padding mask itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu.models.asr import encoder_padding_mask as j_encoder_padding_mask
from tal_asrd_tpu.models.decoder import sinusoidal_positions as j_sinusoidal_positions
from tal_asrd_tpu_torch.core.config import ModelConfig
from tal_asrd_tpu_torch.models.asr import ASRModel, encoder_padding_mask
from tal_asrd_tpu_torch.models.decoder import PositionalEncoding, sinusoidal_positions

from tests.test_torch_helpers import TINY, tiny_audio, tiny_model_pair

# f32 on both sides; the chain of ~20 small products per layer differs only in
# summation order. 2e-4 is the repo's own bar for its fused-vs-flax tests.
ATOL = 2e-4
N_STEPS = 6


@pytest.fixture(scope="module")
def pair():
    jmodel, variables, tmodel = tiny_model_pair(seed=11)
    audio, lens = tiny_audio(3)
    rng = np.random.default_rng(5)
    y = rng.integers(0, tmodel.cfg.num_tokens, size=(3, N_STEPS)).astype(np.int32)
    j_enc = jax.jit(lambda v, a, n: jmodel.apply(v, a, n, False, method=JASRModel.encode))(
        variables, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        t_enc = tmodel.encode(torch.from_numpy(audio), torch.from_numpy(lens))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel, y=y,
                j_enc=j_enc, t_enc=t_enc, audio=audio, lens=lens)


def test_encode_matches_jax(pair):
    ref = np.asarray(pair["j_enc"]["encoder_out"])
    ours = pair["t_enc"]["encoder_out"].numpy()
    assert ours.shape == ref.shape
    # encoder activations reach O(10) after three conv groups: relative bar
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=ATOL)
    np.testing.assert_array_equal(
        pair["t_enc"]["encoder_padding_mask"].numpy(),
        np.asarray(pair["j_enc"]["encoder_padding_mask"]))
    assert pair["t_enc"]["encoder_padding_mask"].any()   # the mask is exercised


def test_teacher_forced_decode_matches_jax(pair):
    ref_logits, ref_attn = pair["jmodel"].apply(
        pair["variables"], jnp.asarray(pair["y"]), pair["j_enc"],
        method=JASRModel.decode)
    with torch.no_grad():
        logits, attn = pair["tmodel"].decode(
            torch.from_numpy(pair["y"]).long(), pair["t_enc"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=2e-4, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), rtol=0, atol=ATOL)


def test_forward_returns_logits_and_encoder_out(pair):
    (ref, _), _ = pair["jmodel"].apply(
        pair["variables"], jnp.asarray(pair["audio"]), jnp.asarray(pair["y"]),
        jnp.asarray(pair["lens"]))
    with torch.no_grad():
        (ours, spk), enc = pair["tmodel"](
            torch.from_numpy(pair["audio"]), torch.from_numpy(pair["y"]).long(),
            torch.from_numpy(pair["lens"]))
    assert spk is None and "encoder_out" in enc
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4, atol=ATOL)


def test_decode_step_chain_matches_jax(pair):
    jm, tm, variables = pair["jmodel"], pair["tmodel"], pair["variables"]
    j_state = jm.apply(variables, pair["j_enc"], 3, N_STEPS + 2,
                       method=JASRModel.init_decode_state)
    j_step = jax.jit(lambda v, tok, st: jm.apply(v, tok, st, method=JASRModel.decode_step))
    with torch.no_grad():
        t_state = tm.init_decode_state(pair["t_enc"], 3, N_STEPS + 2)
        for step in range(N_STEPS):
            tok = pair["y"][:, step:step + 1]
            ref_logits, _, ref_attn, j_state = j_step(variables, jnp.asarray(tok), j_state)
            logits, spk, attn, t_state = tm.decode_step(
                torch.from_numpy(tok).long(), t_state)
            assert spk is None and t_state["index"] == step + 1
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                       rtol=2e-4, atol=ATOL, err_msg=f"step {step}")
            np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn),
                                       rtol=0, atol=ATOL, err_msg=f"step {step}")
    # the cache was written in place, layout [B, L, H, dh] as in the reference
    np.testing.assert_allclose(t_state["caches"][0]["k"].numpy(),
                               np.asarray(j_state["caches"][0]["k"]), rtol=0, atol=ATOL)


def test_decode_prefill_matches_jax(pair):
    jm, tm, variables = pair["jmodel"], pair["tmodel"], pair["variables"]
    j_kvs = jm.apply(variables, pair["j_enc"]["encoder_out"],
                     method=JASRModel.precompute_mem_kvs)
    ref_logits, ref_attn, ref_caches = jm.apply(
        variables, jnp.asarray(pair["y"]), j_kvs,
        pair["j_enc"]["encoder_padding_mask"], N_STEPS + 3,
        method=JASRModel.decode_prefill)
    with torch.no_grad():
        kvs = tm.precompute_mem_kvs(pair["t_enc"]["encoder_out"])
        logits, attn, caches = tm.decode_prefill(
            torch.from_numpy(pair["y"]).long(), kvs,
            pair["t_enc"]["encoder_padding_mask"], N_STEPS + 3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=2e-4, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), rtol=0, atol=ATOL)
    np.testing.assert_allclose(caches[3]["v"].numpy(), np.asarray(ref_caches[3]["v"]),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["buffer", "batch_max"])
def test_encoder_padding_mask_matches_jax(mode):
    lens = np.array([48000, 30000, 17000, 400], np.int32)
    ref = np.asarray(j_encoder_padding_mask(jnp.asarray(lens), 52000, 21, mode=mode))
    ours = encoder_padding_mask(torch.from_numpy(lens), 52000, 21, mode=mode).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_positional_encoding_offset():
    np.testing.assert_array_equal(sinusoidal_positions(16, 8), j_sinusoidal_positions(16, 8))
    pe = PositionalEncoding(8, 16, 0.0).eval()
    x = torch.zeros(1, 3, 8)
    np.testing.assert_array_equal(pe(x, offset=5)[0].numpy(), sinusoidal_positions(16, 8)[5:8])


def test_int16_audio_is_scaled(pair):
    tm = pair["tmodel"]
    pcm = (pair["audio"] * 32768.0).round().clip(-32768, 32767).astype(np.int16)
    with torch.no_grad():
        a = tm.extract_features(torch.from_numpy(pcm))
        b = tm.extract_features(torch.from_numpy(pcm.astype(np.float32) / 32768.0))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_enc_posenc_gate_matches_jax():
    jmodel, variables, tmodel = tiny_model_pair(seed=13, enc_posenc=True)
    mem = np.random.default_rng(1).standard_normal((2, 21, 32)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(mem), method=JASRModel.add_mem_posenc))
    with torch.no_grad():
        ours = tmodel.add_mem_posenc(torch.from_numpy(mem)).numpy()
    assert np.abs(ours - mem).max() > 0.1      # alpha was bumped: the code is added
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_speaker_head_is_not_ported():
    """The speaker head is ported (its parity with JAX:
    tests/test_torch_spk_head.py): a head model builds with the head's
    modules, gives per-token speaker logits beside text-only logits, and is
    refused by the fused decoder, as the reference's assert refuses it."""
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    model = ASRModel(ModelConfig(use_speaker_head=True, **TINY), device="cpu")
    audio, lens = tiny_audio(2)
    y = torch.zeros((2, 3), dtype=torch.long)
    with torch.no_grad():
        (lm, spk), enc = model(torch.from_numpy(audio), y, torch.from_numpy(lens))
    assert lm.shape == (2, 3, TINY["vocab_size"]) and spk.shape == (2, 3, TINY["num_speakers"])
    assert enc["speaker_out"].shape == enc["encoder_out"].shape
    with pytest.raises(ValueError, match="speaker-token mode"):
        FusedASRDecoder(model)


def test_initial_weights_are_the_references_truncated_lecun_normal():
    """flax's lecun_normal: a normal cut at +-2 and scaled by 1/0.8796, std
    1/sqrt(fan_in), no value beyond 2.2737/sqrt(fan_in) — in the helper on a
    large draw and in every matrix, conv kernel and embedding_proj of a
    freshly initialised model (the embedding table is uniform)."""
    import math

    from tal_asrd_tpu_torch.models.layers import lecun_normal_
    from tal_asrd_tpu_torch.ops.grouped_conv import GroupedConv1D

    def cut(fan_in):
        return 2.0 / 0.87962566103423978 / math.sqrt(fan_in)

    n, fan_in = 400_000, 50
    t = lecun_normal_(torch.empty(n), fan_in, torch.Generator().manual_seed(0))
    assert float(t.abs().max()) <= cut(fan_in) * (1 + 1e-6)
    assert float(t.abs().max()) > 0.99 * cut(fan_in)           # it reaches the cut
    # sampling error of the std of n draws: < 1/sqrt(2n) relative
    assert abs(float(t.std()) * math.sqrt(fan_in) - 1.0) < 5 / math.sqrt(2 * n)
    assert abs(float(t.mean())) * math.sqrt(fan_in) < 5 / math.sqrt(n)

    model = ASRModel(ModelConfig(**TINY), dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    checked = 0
    for name, p in model.named_parameters():
        if p.dim() < 2 or name == "embedding.weight":
            continue
        fan = p.shape[0] if name == "embedding_proj" else p[0].numel()
        assert float(p.abs().max()) <= cut(fan) * (1 + 1e-6), name
        checked += 1
    assert checked > 10
    conv = GroupedConv1D(80, 800, 21, groups=80)
    assert float(conv.weight.abs().max()) <= cut(21) * (1 + 1e-6)
    assert abs(float(conv.weight.std()) * math.sqrt(21) - 1.0) < 0.02
