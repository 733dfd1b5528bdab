"""The non-causal reference decode (decode/reference_mode.py), port against
JAX package on the CPU, float32:

  * on the tiny model pair (tests/test_torch_helpers.py, seed 1, ReZero
    scalars 0.4), tokens and lengths equal to JAX's `greedy_noncausal` with
    no EOS, with an EOS that one row emits, and with one that every row
    emits (the loop stops early), `attn` within 1e-5; against the
    exact-length loop, the reference's computation, row by row; the
    emitted positions' `attn` rows are distributions; and the non-causal
    tokens differ from the causal greedy search's here, so the test would
    notice a causal decode;
  * the tracked checkpoint at full width on the first 4 segments of the
    synthetic test split, as one batch: tokens and lengths equal to the
    JAX CPU reference's (tests/fixtures/torch_embed_reference.json, made by
    scripts/torch_embed_reference.py), `attn` within 1e-4.

JAX runs each search once, in the module's fixture."""
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.decode.reference_mode import greedy_noncausal as j_greedy_noncausal
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu_torch.decode.reference_mode import greedy_noncausal

from tests.test_torch_helpers import tiny_audio, tiny_model_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference.json")
ARRAYS = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference_arrays.npz")
CHECKPOINT = os.path.join(ROOT, "accuracy_release", "avg_last_3.bf16.msgpack")
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")

MAX_LEN, BATCH = 14, 3
# None; 36: emitted by row 1 alone (mid-sequence); 17: emitted by every row
EOS_CASES = (None, 36, 17)


@pytest.fixture(scope="module")
def world():
    jmodel, variables, tmodel = tiny_model_pair(seed=1)
    audio, lens = tiny_audio(BATCH)
    prime = np.ones((BATCH, 1), np.int32)
    j_enc = jmodel.apply(variables, jnp.asarray(audio), jnp.asarray(lens), False,
                         method=JASRModel.encode)
    refs = {eos: {k: np.asarray(v) for k, v in j_greedy_noncausal(
        jmodel, variables, j_enc, jnp.asarray(prime), MAX_LEN, eos_id=eos).items()}
        for eos in EOS_CASES}
    with torch.inference_mode():
        t_enc = tmodel.encode(torch.from_numpy(audio), torch.from_numpy(lens))
    return dict(tmodel=tmodel, t_enc=t_enc, prime=torch.from_numpy(prime).long(), refs=refs)


def port(w, eos, max_len=MAX_LEN):
    return greedy_noncausal(w["tmodel"], w["t_enc"], w["prime"], max_len, eos_id=eos)


@pytest.mark.parametrize("eos", EOS_CASES)
def test_matches_jax(world, eos):
    got, ref = port(world, eos), world["refs"][eos]
    np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), ref["lengths"])
    assert got["tokens"].dtype == torch.long and got["attn"].dtype == torch.float32
    np.testing.assert_allclose(got["attn"].numpy(), ref["attn"], rtol=0, atol=1e-5)
    lengths = got["lengths"].tolist()
    if eos == 36:
        assert lengths[1] < MAX_LEN and lengths[0] == lengths[2] == MAX_LEN
        assert (got["tokens"][1, lengths[1]:] == eos).all()
    if eos == 17:      # every row done: the loop stopped before the buffer's end
        assert max(lengths) < MAX_LEN and (got["attn"][:, max(lengths):] == 0).all()


def exact_length_loop(model, enc, row, prime, max_len, eos):
    """The reference loop for one row: decode the exact prefix, append the
    argmax, stop at EOS."""
    one = {k: (v[row:row + 1] if v is not None else None) for k, v in enc.items()}
    toks = list(prime)
    while len(toks) < max_len:
        with torch.inference_mode():
            logits, _ = model.decode(torch.tensor([toks]), one, causal=False)
        toks.append(int(logits[0, -1].argmax()))
        if toks[-1] == eos:
            break
    return toks


@pytest.mark.parametrize("eos", [36, 17])
def test_matches_the_exact_length_loop(world, eos):
    got = port(world, eos)
    for i in range(BATCH):
        want = exact_length_loop(world["tmodel"], world["t_enc"], i, [1], MAX_LEN, eos)
        assert got["tokens"][i, :got["lengths"][i]].tolist() == want, i


def test_attn_rows_are_distributions(world):
    attn = port(world, None)["attn"][:, 1:].numpy()
    np.testing.assert_allclose(attn.sum(-1), np.ones(attn.shape[:2]), atol=1e-5)
    assert (port(world, None)["attn"][:, 0] == 0).all()


def test_differs_from_the_causal_greedy_search(world):
    spec = BeamSearchSpec(beam_size=1, max_new_tokens=MAX_LEN - 1, eos_id=-1,
                          vocab_size=world["tmodel"].cfg.num_tokens,
                          text_vocab_size=world["tmodel"].cfg.vocab_size, force_output=True)
    with torch.inference_mode():
        causal = beam_search(world["tmodel"], world["t_enc"], world["prime"], spec)
    assert not torch.equal(causal["tokens"], port(world, None)["tokens"])


def test_tracked_checkpoint_matches_the_jax_fixture(tmp_path):
    """The first batch of 4 segments of the seed-202 test split (its first
    episode cut to 5 utterances), f32 at full width."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.core.convert import load_into
    from tal_asrd_tpu_torch.data.aligned import AlignedDataset
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

    with open(FIXTURE) as f:
        fx = json.load(f)
    ref = fx["noncausal"]["cpu"]
    split = str(tmp_path)
    transcripts = build_synth_corpus(split, **fx["splits"]["cpu"])
    with open(os.path.join(split, "transcript.pkl"), "wb") as f:
        pickle.dump({"ep0": transcripts["ep0"][:fx["cpu_utterances"]]}, f)
    tok = BpeTokenizer(model_path=BPE)
    ds = AlignedDataset(split, tok, num_utterances=1, min_segment_duration=3,
                        max_segment_duration=20,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        tokenizer_speakers=True, return_spk_ids=True)
    batch = next(iter(DataLoader(ds, fx["batch"]["cpu"], BucketedCollater(tok.pad_token_id),
                                 num_workers=0, drop_last=False)))
    assert batch["idx"].tolist() == ref["idx"]
    model = ASRModel(ModelConfig(model_type="1x", num_speakers=8, vocab_size=len(tok)),
                     device="cpu")
    load_into(model, load_pytree(CHECKPOINT))
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(batch["audio"]),
                           torch.from_numpy(batch["audio_lens"]))
        got = greedy_noncausal(model, enc, torch.from_numpy(batch["text"][:, :1]).long(),
                               ref["max_len"], eos_id=tok.eos_token_id)
    assert got["lengths"].tolist() == ref["lengths"]
    assert [got["tokens"][i, :n_i].tolist() for i, n_i in enumerate(ref["lengths"])] == \
        ref["tokens"]
    attn = np.load(ARRAYS)["noncausal/cpu/attn"]
    np.testing.assert_allclose(got["attn"].numpy()[:len(attn)], attn, rtol=0, atol=1e-4)
