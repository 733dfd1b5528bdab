"""The aligned evaluation as a whole, port against JAX package, on the tiny
model pair (tests/test_torch_helpers.py, float32, ReZero scalars bumped):

  * beam search's expected-speaker-embedding track (`collect_spk_embed`) at
    beam 1 and 3, through the unfused model and through FusedASRDecoder's
    plain path;
  * EvalRunner over a 30 s split of the synthetic test corpus (seed 202):
    test_result.pkl (text, speaker ids, speakerEmbed), hyp.txt, ref.txt, the
    loss, and WER / WDER after scoring.

The track is stored in bf16 by both packages. Its values are held to 1e-5;
where two f32 sources that agree to ~1e-6 fall on either side of a bf16
rounding boundary, the stored values are one bf16 step apart, and exactly
one step is accepted there, at a few values in a hundred at most
(`bf16_track_steps`)."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.core.config import DecodeConfig as JDecodeConfig
from tal_asrd_tpu.data import AlignedDataset as JAlignedDataset
from tal_asrd_tpu.data import BucketedCollater as JBucketedCollater
from tal_asrd_tpu.data import DataLoader as JDataLoader
from tal_asrd_tpu.data import ShardedSampler as JShardedSampler
from tal_asrd_tpu.data.synth import build_synth_corpus as j_build_synth_corpus
from tal_asrd_tpu.decode.beam import BeamSearchSpec as JBeamSearchSpec
from tal_asrd_tpu.decode.beam import beam_search as j_beam_search
from tal_asrd_tpu.eval.convert import convert_results as j_convert_results
from tal_asrd_tpu.eval.runner import EvalRunner as JEvalRunner
from tal_asrd_tpu.eval.wder import corpus_wder as j_corpus_wder
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu_torch.core.config import DecodeConfig
from tal_asrd_tpu_torch.core.convert import load_into
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.collate import BucketedCollater
from tal_asrd_tpu_torch.data.loader import DataLoader, ShardedSampler
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.eval.convert import score_test_result
from tal_asrd_tpu_torch.eval.runner import EvalRunner
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

from tests.test_torch_helpers import tiny_audio, tiny_model_pair, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")
ATOL = 1e-5
MAX_NEW = 12
# Share of track values allowed one bf16 step (2^-8 relative) apart: the two
# packages' f32 logits differ at ~1e-6 (tests/test_torch_decoder.py), so a
# few values in a hundred sit at a rounding boundary (readings: 1 of 2304
# values in the beam test, 2 of 128 in the slice).
MAX_STEP_SHARE = 0.05


def bf16_track_steps(got, ref, atol=ATOL):
    """Holds |got - ref| <= atol except where got and ref are adjacent bf16
    numbers (a rounding boundary between two f32 sources); returns (the
    count of those, the count of values). A wrong track differs by O(value),
    never by one step only."""
    got = torch.as_tensor(got).to(torch.bfloat16)
    ref = torch.as_tensor(ref).to(torch.bfloat16)
    assert got.shape == ref.shape
    far = (got.float() - ref.float()).abs() > atol
    adjacent = torch.nextafter(got, ref) == ref
    assert bool(adjacent[far].all()), (got[far], ref[far])
    return int(far.sum()), got.numel()


# ---------------------------------------------------------------------------
# The speaker-embedding track of beam search
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def track():
    jmodel, variables, tmodel = tiny_model_pair(seed=31)
    audio, lens = tiny_audio(3)
    prime = np.ones((3, 1), np.int32)
    cfg = tmodel.cfg
    kw = dict(max_new_tokens=MAX_NEW, eos_id=-1, vocab_size=cfg.num_tokens,
              text_vocab_size=cfg.vocab_size, num_speakers=cfg.num_speakers,
              collect_spk_embed=True, force_output=True)
    # an EOS id that greedy decoding emits mid-sequence in lane 0, so that
    # retirement copies the track into the finished pool
    free = make_generate_fn(tmodel, BeamSearchSpec(beam_size=1, **kw), device="cpu")(
        audio, lens, prime)
    kw["eos_id"] = int(free["tokens"][0, 4])
    j_enc = jax.jit(lambda v, a, n: jmodel.apply(v, a, n, False, method=JASRModel.encode))(
        variables, jnp.asarray(audio), jnp.asarray(lens))
    refs = {}
    for k in (1, 3):
        spec = JBeamSearchSpec(beam_size=k, **kw)
        refs[k] = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda v, e, p, s=spec: j_beam_search(jmodel, v, e, p, s))(
            variables, j_enc, jnp.asarray(prime)))
    return dict(tmodel=tmodel, audio=audio, lens=lens, prime=prime, kw=kw, refs=refs)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_plain"])
@pytest.mark.parametrize("k", [1, 3])
def test_speaker_embedding_track_matches_jax(track, k, fused):
    t = track
    spec = BeamSearchSpec(beam_size=k, **t["kw"])
    decoder = FusedASRDecoder(t["tmodel"]) if fused else None
    out = make_generate_fn(t["tmodel"], spec, decoder=decoder, device="cpu")(
        t["audio"], t["lens"], t["prime"])
    ref = t["refs"][k]
    np.testing.assert_array_equal(out["tokens"].numpy(), ref["tokens"])
    np.testing.assert_array_equal(out["lengths"].numpy(), ref["lengths"])
    assert out["spk_embed"].dtype == torch.bfloat16
    assert out["spk_embed"].shape == (3, MAX_NEW, 64)
    steps, n = bf16_track_steps(out["spk_embed"], ref["spk_embed"].astype(np.float32))
    assert steps <= MAX_STEP_SHARE * n, (steps, n)
    # the track is live: rows of expectations over the speaker rows
    assert float(out["spk_embed"].float().abs().max()) > 1e-2
    # some rows retired at EOS (the finished pool), others were taken live
    assert ref["found"].all() and (ref["lengths"] < 1 + MAX_NEW).any()


def test_speaker_rows_are_the_last_rows_of_the_table(track):
    tm = track["tmodel"]
    rows = tm.speaker_rows()
    assert rows.shape == (tm.cfg.num_speakers, 64)
    assert torch.equal(rows, tm.embedding.weight[-tm.cfg.num_speakers:])
    assert torch.equal(FusedASRDecoder(tm).speaker_rows(), rows)


# ---------------------------------------------------------------------------
# The slice: EvalRunner, port against JAX
# ---------------------------------------------------------------------------
# The tiny pair's seed and the scale of its speaker rows: chosen (by a search
# over seeds 0-3 and scales 2-4) so that some rows end in EOS after text and
# a speaker token. The test asserts that they do.
SLICE_SEED, SPEAKER_SCALE = 1, 3.0
SPLIT = dict(n_episodes=1, episode_seconds=30.0, n_speakers=8, seed=202)
BATCH = 5        # the split's 5 segments in one batch, as the CLI's batch 64 takes them


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    return _slice_runs(tmp_path_factory.mktemp("slice"))


def _slice_runs(root):
    jmodel, variables, tmodel = tiny_model_pair(seed=SLICE_SEED, vocab_size=300,
                                                num_speakers=8)
    params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    to_numpy_tree(variables["params"]))
    params["embedding"]["embedding"][300:] *= SPEAKER_SCALE
    load_into(tmodel, {"params": params})

    runs = {}
    for side in ("port", "jax"):
        split, out = str(root / side / "test"), str(root / side / "out")
        (build_synth_corpus if side == "port" else j_build_synth_corpus)(split, **SPLIT)
        ds_cls, tok = ((AlignedDataset, BpeTokenizer(model_path=BPE)) if side == "port"
                       else (JAlignedDataset, JBpeTokenizer(model_path=BPE)))
        ds = ds_cls(split, tok, num_utterances=1, min_segment_duration=3,
                    max_segment_duration=20,
                    speaker_map_loc=os.path.join(split, "speaker_map.json"),
                    tokenizer_speakers=True, return_spk_ids=True)
        if side == "port":
            runner = EvalRunner(tmodel, tok, DecodeConfig(beam_size=3), out_dir=out,
                                device="cpu")
            loader = DataLoader(ds, BATCH, BucketedCollater(tok.pad_token_id),
                                ShardedSampler(len(ds), shuffle=False), 0, drop_last=False)
        else:
            runner = JEvalRunner(jmodel, {"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                 tok, JDecodeConfig(beam_size=3), out_dir=out)
            loader = JDataLoader(ds, BATCH, JBucketedCollater(tok.pad_token_id),
                                 JShardedSampler(len(ds), shuffle=False), 0, drop_last=False)
        losses = [runner.test_step_aligned(b, [ds.index[int(i)][1] for i in b["idx"]])["loss"]
                  for b in loader]
        runs[side] = dict(out=out, losses=losses, end=runner.test_end())
    return runs


def read(run, name):
    mode = "rb" if name.endswith(".pkl") else "r"
    with open(os.path.join(run["out"], name), mode) as f:
        return pickle.load(f) if mode == "rb" else f.read()


def test_slice_writes_what_the_jax_runner_writes(slice_runs):
    port, ref = slice_runs["port"], slice_runs["jax"]
    got, want = read(port, "test_result.pkl"), read(ref, "test_result.pkl")
    assert len(got) == len(want) == 5
    n_emb, steps, n = 0, 0, 0
    for (refs, hyps), (jrefs, jhyps) in zip(got, want):
        assert refs == jrefs
        assert [(h["utterance"], h["speakerId"]) for h in hyps] == \
            [(h["utterance"], h["speakerId"]) for h in jhyps]
        for h, jh in zip(hyps, jhyps):
            assert set(h) == set(jh)
            if "speakerEmbed" in jh:
                n_emb += 1
                assert h["speakerEmbed"].dtype == np.float32
                st, nv = bf16_track_steps(h["speakerEmbed"], jh["speakerEmbed"])
                steps, n = steps + st, n + nv
    assert steps <= MAX_STEP_SHARE * n, (steps, n)
    # the weights make some rows end in EOS after text and a speaker token,
    # so the speakerEmbed slicing is exercised
    assert n_emb >= 2
    assert sum(bool(h) for _, h in got) >= 2
    assert read(port, "hyp.txt") == read(ref, "hyp.txt")
    assert read(port, "ref.txt") == read(ref, "ref.txt")


def test_slice_loss_and_scores_match_jax(slice_runs):
    port, ref = slice_runs["port"], slice_runs["jax"]
    assert len(port["losses"]) == len(ref["losses"]) == 1
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0, atol=ATOL)
    assert abs(port["end"]["test_loss"] - ref["end"]["test_loss"]) <= ATOL
    print("loss", port["end"]["test_loss"], ref["end"]["test_loss"])
    scored = score_test_result(os.path.join(port["out"], "test_result.pkl"))
    _, _, j_wder, j_dist, j_n_words, j_wer = j_corpus_wder(
        j_convert_results(read(ref, "test_result.pkl")), workers=1)
    assert (scored["overall_wer"], scored["overall_wder"]) == (j_wer, j_wder)
    assert tuple(scored["dist"]) == tuple(j_dist) and tuple(scored["n_words"]) == tuple(j_n_words)
