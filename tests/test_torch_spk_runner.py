"""`EvalRunner` with the separate speaker head, port against JAX package on
the CPU (float32, tiny width, every ReZero scalar 0.4), at spk_weight 0.5 on
a 30 s split: the aligned leg (test_result.pkl equal, speakerLogits within
1e-2); the `speakerLogits` entries of a given search output, the row two
utterances share included; the split's episode through the state machine
and the VAD windows (the JAX runner's tokens, and no speakerLogits in either
long-form leg). Each package's runner runs once, in the module's fixture."""
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
from tal_asrd_tpu.data.audio_io import load_audio_segment as j_load_audio_segment
from tal_asrd_tpu.data.synth import build_synth_corpus as j_build_synth_corpus
from tal_asrd_tpu.decode.unaligned import UnalignedSpec as JUnalignedSpec
from tal_asrd_tpu.eval.runner import EvalRunner as JEvalRunner
from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu_torch.core.config import DecodeConfig
from tal_asrd_tpu_torch.core.convert import load_into
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
from tal_asrd_tpu_torch.data.collate import BucketedCollater
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.decode.unaligned import UnalignedSpec
from tal_asrd_tpu_torch.eval.runner import EvalRunner
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

from tests.test_torch_helpers import tiny_model_pair, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")
TRACK_ATOL = 1e-2          # the track is stored in bf16 by both packages
SPK = 0.5


def head_pair(seed=2, eos_scale=2.0):
    """A tiny head pair over the BPE's 300 tokens and 8 speakers, its EOS
    row scaled so that some searches end (the seed and the scale: a search
    over seeds 1-3 and scales 2-8 for two segments of the 30 s split that
    end in EOS after text; the test asserts that they do)."""
    jmodel, variables, tmodel = tiny_model_pair(seed=seed, vocab_size=300, num_speakers=8,
                                                use_speaker_head=True)
    params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    to_numpy_tree(variables["params"]))
    params["embedding"]["embedding"][1] *= eos_scale
    load_into(tmodel, {"params": params})
    return jmodel, {"params": jax.tree_util.tree_map(jnp.asarray, params)}, tmodel


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    return _runner_runs(tmp_path_factory.mktemp("spk_runner"))


SM_SPEC = dict(eos_id=1, chunk_size=48, max_positions=32, max_tokens=128, max_iters=300,
               max_outer=64, stall_patience=8, text_vocab_size=300)


def boundary_output(b):
    """A search output for `b` rows whose first two rows hold two and three
    utterances (text EOS text (EOS text), then the final EOS), with a
    random speaker track."""
    tokens = np.zeros((b, 16), np.int64)
    lengths = np.full((b,), 3)
    tokens[:, :3] = [1, 40, 1]
    tokens[0, :8] = [1, 40, 41, 1, 42, 43, 44, 1]
    tokens[1, :10] = [1, 50, 1, 51, 52, 1, 53, 54, 55, 1]
    lengths[:2] = (8, 10)
    spk = np.random.default_rng(0).standard_normal((b, 15, 8)).astype(np.float32)
    return {"tokens": tokens, "lengths": lengths, "found": np.ones((b,), bool),
            "scores": np.zeros((b,), np.float32), "spk": spk}


def _runner_runs(root):
    """Each package's runner at spk_weight 0.5 on the 30 s split: the aligned
    leg (its segments in one batch), the same batch through a given search
    output (`boundary_output`), and the split's episode through the VAD
    windows and the state machine."""
    jmodel, jvars, tmodel = head_pair()
    out = {}
    for side in ("port", "jax"):
        res = {}
        build = build_synth_corpus if side == "port" else j_build_synth_corpus
        tok = BpeTokenizer(model_path=BPE) if side == "port" else JBpeTokenizer(model_path=BPE)
        split = str(root / side / "split")
        build(split, n_episodes=1, episode_seconds=30.0, n_speakers=8, seed=202)
        ds = (AlignedDataset if side == "port" else JAlignedDataset)(
            split, tok, num_utterances=1, min_segment_duration=3, max_segment_duration=20,
            speaker_map_loc=os.path.join(split, "speaker_map.json"),
            tokenizer_speakers=False, return_spk_ids=True)
        batch = (BucketedCollater if side == "port" else JBucketedCollater)(
            tok.pad_token_id)([ds[i] for i in range(len(ds))])
        refs = [ds.index[int(i)][1] for i in batch["idx"]]
        with open(os.path.join(split, "transcript.pkl"), "rb") as f:
            (stub, utts), = pickle.load(f).items()
        wav = (load_audio_segment if side == "port" else j_load_audio_segment)(
            os.path.join(split, f"{stub}.wav"), 0.0, None)
        for leg in ("aligned", "boundary", "vad", "sm"):
            d = str(root / side / leg)
            if side == "port":
                runner = EvalRunner(tmodel, tok, DecodeConfig(beam_size=3), out_dir=d,
                                    device="cpu", spk_weight=SPK)
                spec = UnalignedSpec(**SM_SPEC)
            else:
                runner = JEvalRunner(jmodel, jvars, tok, JDecodeConfig(beam_size=3), out_dir=d,
                                     spk_weight=SPK)
                spec = JUnalignedSpec(**SM_SPEC)
            if leg == "boundary":
                fake = boundary_output(len(refs))
                if side == "port":
                    runner._generate_fn = lambda max_new: lambda *a: {
                        k: torch.as_tensor(v) for k, v in fake.items()}
                else:
                    runner._generate_fn = lambda shape, max_new: lambda *a: {
                        k: jnp.asarray(v) for k, v in fake.items()}
            if leg in ("aligned", "boundary"):
                res[f"{leg}_loss"] = runner.test_step_aligned(batch, refs)["loss"]
            elif leg == "vad":
                runner.test_step_unaligned_vad(wav, len(wav), utts, batch_lanes=4)
            else:
                runner.test_step_unaligned(wav, len(wav), utts, spec=spec)
            with open(os.path.join(d, "test_result.pkl"), "rb") as f:
                res[leg] = pickle.load(f)
        out[side] = res
    return out


def test_speaker_logits_entries_share_their_boundary_row(runner_runs):
    """Both runners slice one search output the same way: utterance u gets
    the track's rows [last, split_u], and the next starts at split_u, so two
    consecutive utterances share that row."""
    port = [hyp for _, hyp in runner_runs["port"]["boundary"]]
    ref = [hyp for _, hyp in runner_runs["jax"]["boundary"]]
    assert len(port) == len(ref) == 5
    for hyp_p, hyp_j in zip(port, ref):
        assert len(hyp_p) == len(hyp_j) >= 1
        for a, b in zip(hyp_p, hyp_j):
            assert a["utterance"] == b["utterance"]
            np.testing.assert_array_equal(a["speakerLogits"], b["speakerLogits"])
        for first, second in zip(hyp_p, hyp_p[1:]):
            np.testing.assert_array_equal(first["speakerLogits"][-1], second["speakerLogits"][0])
    assert [len(h) for h in port[:2]] == [2, 3]
    assert [u["speakerLogits"].shape[0] for u in port[1]] == [3, 4, 4]


def test_aligned_runner_writes_the_references_speaker_logits(runner_runs):
    port, ref = runner_runs["port"]["aligned"], runner_runs["jax"]["aligned"]
    assert len(port) == len(ref) == 5
    n = 0
    for (refs_p, hyp_p), (refs_j, hyp_j) in zip(port, ref):
        assert refs_p == refs_j and len(hyp_p) == len(hyp_j)
        for a, b in zip(hyp_p, hyp_j):
            assert (a["utterance"], a["speakerId"]) == (b["utterance"], b["speakerId"])
            assert set(a) == set(b) == {"utterance", "speakerId", "speakerLogits"}
            np.testing.assert_allclose(a["speakerLogits"], np.asarray(b["speakerLogits"]),
                                       rtol=0, atol=TRACK_ATOL)
            n += 1
    assert n >= 2            # the EOS row makes searches end: entries are written
    assert abs(runner_runs["port"]["aligned_loss"] - runner_runs["jax"]["aligned_loss"]) <= 1e-5


@pytest.mark.parametrize("leg", ["vad", "sm"])
def test_long_form_legs_decode_without_the_head(runner_runs, leg):
    """The state machine builds its state without the head's caches and the
    VAD windows keep no track: the JAX runner's tokens, no speakerLogits."""
    (ref_p, hyp_p), = runner_runs["port"][leg]
    (ref_j, hyp_j), = runner_runs["jax"][leg]
    assert [u["utterance"] for u in ref_p] == [u["utterance"] for u in ref_j]
    assert len(hyp_p) == len(hyp_j) > 0
    for a, b in zip(hyp_p, hyp_j):
        assert (a["utterance"], a["speakerId"]) == (b["utterance"], b["speakerId"])
        assert list(a["utteranceTokens"]) == [int(t) for t in b["utteranceTokens"]]
        np.testing.assert_array_equal(np.asarray(a["chunkStart"]), np.asarray(b["chunkStart"]))
        assert "speakerLogits" not in a and "speakerLogits" not in b
