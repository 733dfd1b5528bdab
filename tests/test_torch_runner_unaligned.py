"""The long-form legs of EvalRunner, port against JAX package
(tal_asrd_tpu/eval/runner.py), on the tiny model pair
(tests/test_torch_helpers.py: float32, ReZero scalars bumped, the speaker
rows scaled so that hypotheses carry speaker tokens) over synthetic
episodes (seed 202), each side's own split:

  * `test_step_unaligned_batched` (two equal-length 20 s episodes encoded
    together) and `test_step_unaligned` (the first alone), the state
    machine at a small spec: test_result.pkl equal — utterances, speaker ids, utteranceTokens
    and chunkStart exactly, attention rows equal or one bf16 step apart —,
    hyp.txt / ref.txt equal, WER / WDER equal;
  * `test_step_unaligned_vad` on one 60 s episode (7 windows in the 5, 10
    and 20 s buckets), beam 3 in batches of 4: the same entries.

JAX compiles each decode once, in one module fixture."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.core.config import DecodeConfig as JDecodeConfig
from tal_asrd_tpu.data.audio_io import load_audio_segment as j_load_audio_segment
from tal_asrd_tpu.data.synth import build_synth_corpus as j_build_synth_corpus
from tal_asrd_tpu.decode.unaligned import UnalignedSpec as JUnalignedSpec
from tal_asrd_tpu.eval.convert import convert_results as j_convert_results
from tal_asrd_tpu.eval.runner import EvalRunner as JEvalRunner
from tal_asrd_tpu.eval.wder import corpus_wder as j_corpus_wder
from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu_torch.core.config import DecodeConfig
from tal_asrd_tpu_torch.core.convert import load_into
from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.decode.unaligned import UnalignedSpec
from tal_asrd_tpu_torch.eval.convert import score_test_result
from tal_asrd_tpu_torch.eval.runner import EvalRunner
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

from tests.test_torch_helpers import tiny_model_pair, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")
SPLIT = dict(n_episodes=2, episode_seconds=20.0, n_speakers=8, seed=202)
VAD_SPLIT = dict(n_episodes=1, episode_seconds=60.0, n_speakers=8, seed=202)
SEED, SPEAKER_SCALE = 1, 3.0           # as tests/test_torch_runner.py's slice
SPEC = dict(eos_id=1, chunk_size=48, max_positions=32, max_tokens=128, max_iters=300,
            max_outer=64, stall_patience=8)
VAD_LANES = 4


def episodes(split, loader):
    """[(audio, utterances)] of the split's episodes, in name order."""
    with open(os.path.join(split, "transcript.pkl"), "rb") as f:
        transcripts = pickle.load(f)
    return [(loader(os.path.join(split, f"{stub}.wav"), 0.0, None), transcripts[stub])
            for stub in sorted(transcripts)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("long_form")
    jmodel, variables, tmodel = tiny_model_pair(seed=SEED, vocab_size=300,
                                                num_speakers=8)
    params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    to_numpy_tree(variables["params"]))
    params["embedding"]["embedding"][300:] *= SPEAKER_SCALE
    load_into(tmodel, {"params": params})
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}

    out = {}
    for side in ("port", "jax"):
        build = build_synth_corpus if side == "port" else j_build_synth_corpus
        load = load_audio_segment if side == "port" else j_load_audio_segment
        build(str(root / side / "split"), **SPLIT)
        build(str(root / side / "vad_split"), **VAD_SPLIT)
        eps = episodes(str(root / side / "split"), load)
        assert len(eps) == 2 and len(eps[0][0]) == len(eps[1][0])
        n = len(eps[0][0])
        ((vad_wav, vad_utts),) = episodes(str(root / side / "vad_split"), load)
        res = {}
        for leg in ("batched", "single", "vad"):
            d = str(root / side / leg)
            if side == "port":
                runner = EvalRunner(tmodel, BpeTokenizer(model_path=BPE),
                                    DecodeConfig(beam_size=3), out_dir=d, device="cpu")
                spec = UnalignedSpec(**SPEC)
            else:
                runner = JEvalRunner(jmodel, jvars, JBpeTokenizer(model_path=BPE),
                                     JDecodeConfig(beam_size=3), out_dir=d)
                spec = JUnalignedSpec(**SPEC)
            if leg == "batched":
                info = runner.test_step_unaligned_batched(
                    [w for w, _ in eps], n, [u for _, u in eps], spec=spec)
            elif leg == "single":
                info = runner.test_step_unaligned(eps[0][0], n, eps[0][1], spec=spec)
            else:
                info = runner.test_step_unaligned_vad(vad_wav, len(vad_wav), vad_utts,
                                                      batch_lanes=VAD_LANES)
            res[leg] = dict(out=d, info=info)
        out[side] = res
    return out


def read(d, name):
    with open(os.path.join(d, name), "rb" if name.endswith(".pkl") else "r") as f:
        return pickle.load(f) if name.endswith(".pkl") else f.read()


def assert_attention_close(got, want):
    got = torch.from_numpy(np.asarray(got, np.float32)).to(torch.bfloat16)
    want = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert got.shape == want.shape
    far = got.float() != want.float()
    assert bool((torch.nextafter(got, want) == want)[far].all())


@pytest.mark.parametrize("leg", ["batched", "single", "vad"])
def test_long_form_leg_writes_what_the_jax_runner_writes(runs, leg):
    got_dir, want_dir = runs["port"][leg]["out"], runs["jax"][leg]["out"]
    got, want = read(got_dir, "test_result.pkl"), read(want_dir, "test_result.pkl")
    assert len(got) == len(want) == (2 if leg == "batched" else 1)
    for (refs, hyps), (jrefs, jhyps) in zip(got, want):
        assert refs == jrefs
        assert len(hyps) == len(jhyps)
        for h, jh in zip(hyps, jhyps):
            assert set(h) == set(jh) == {"utterance", "speakerId", "attention",
                                         "chunkStart", "utteranceTokens"}
            assert (h["utterance"], h["speakerId"]) == (jh["utterance"], jh["speakerId"])
            assert [int(t) for t in h["utteranceTokens"]] == \
                [int(t) for t in jh["utteranceTokens"]]
            np.testing.assert_array_equal(h["chunkStart"], jh["chunkStart"])
            assert_attention_close(h["attention"], jh["attention"])
    assert read(got_dir, "hyp.txt") == read(want_dir, "hyp.txt")
    assert read(got_dir, "ref.txt") == read(want_dir, "ref.txt")
    scored = score_test_result(os.path.join(got_dir, "test_result.pkl"))
    _, _, j_wder, _, _, j_wer = j_corpus_wder(j_convert_results(want), workers=1)
    assert (scored["overall_wer"], scored["overall_wder"]) == (j_wer, j_wder)


def test_the_legs_decode_something_and_carry_speakers(runs):
    port = runs["port"]
    infos = port["batched"]["info"]
    assert [i["num_tokens"] for i in infos] == \
        [i["num_tokens"] for i in runs["jax"]["batched"]["info"]]
    assert all(i["iters"] > 0 and i["events"]["windows"] >= 2 for i in infos)
    assert port["single"]["info"]["num_tokens"] > 1
    vad = port["vad"]["info"]
    assert vad["num_windows"] == runs["jax"]["vad"]["info"]["num_windows"] == 7
    assert set(vad["buckets"]) == {5, 10, 20}
    assert vad["num_tokens"] == runs["jax"]["vad"]["info"]["num_tokens"]
    speakers = {e["speakerId"] for leg in ("batched", "vad")
                for _, hyps in read(port[leg]["out"], "test_result.pkl") for e in hyps}
    assert speakers - {None}
