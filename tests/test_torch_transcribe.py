"""Windowed transcription (decode/transcribe.py), port against JAX package
(tal_asrd_tpu/decode/transcribe.py):

  * overlap splicing: `overlap_ix`, `splice_ix` and `splice_strings` equal on
    overlapping, disjoint, empty and single inputs, and on drawn word lists;
  * `Transcriber` on the tiny model pair (tests/test_torch_helpers.py,
    float32, ReZero scalars bumped): 6 s of seeded audio in overlapped 1.5 s
    windows, one batch, beam 2, primed with BOS and stopped at EOT: the
    window texts and the spliced string equal JAX's.

Strings: equal, no tolerance. JAX's beam search is compiled once."""
import os

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tal_asrd_tpu.decode.transcribe import TranscribeConfig as JTranscribeConfig
from tal_asrd_tpu.decode.transcribe import Transcriber as JTranscriber
from tal_asrd_tpu.decode.transcribe import overlap_ix as j_overlap_ix
from tal_asrd_tpu.decode.transcribe import splice_ix as j_splice_ix
from tal_asrd_tpu.decode.transcribe import splice_strings as j_splice_strings
from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu_torch.decode.transcribe import (
    TranscribeConfig,
    Transcriber,
    overlap_ix,
    splice_ix,
    splice_strings,
)
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

from tests.test_torch_helpers import tiny_model_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")

CASES = [
    (["the quick brown fox jumps over the lazy dog",
      "over the lazy dog and runs away fast"], 6),
    (["completely different words", "zzz qqq xxx"], 3),
    (["one two three four five six", "four five six seven eight", "seven eight nine ten"], 4),
    (["  padded text  "], 5),
    ([], 20),
    (["a b c", "", "c d e"], 2),
]


@pytest.mark.parametrize("strs, overlap", CASES)
def test_splice_strings_matches_jax(strs, overlap):
    assert splice_strings(strs, overlap) == j_splice_strings(strs, overlap)
    for a, b in zip(strs[:-1], strs[1:]):
        assert overlap_ix(a, b, overlap) == j_overlap_ix(a, b, overlap)
        assert splice_ix(a, b, overlap) == j_splice_ix(a, b, overlap)


def test_splice_keeps_one_copy_of_the_overlap():
    out = splice_strings(*CASES[0])
    assert out.count("lazy dog") == 1 and out.startswith("the quick") and \
        out.endswith("away fast")


WORDS = st.lists(st.sampled_from(["a", "bb", "ccc", "the", "dog", "runs", "x"]),
                 min_size=0, max_size=12).map(" ".join)


@settings(max_examples=60, deadline=None)
@given(st.lists(WORDS, min_size=1, max_size=4), st.integers(1, 8))
def test_splice_strings_matches_jax_on_drawn_texts(strs, overlap):
    assert splice_strings(strs, overlap) == j_splice_strings(strs, overlap)


@pytest.fixture(scope="module")
def pair():
    return tiny_model_pair(seed=2)


def test_transcriber_matches_jax(pair):
    jmodel, variables, tmodel = pair
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(16000 * 6) * 0.1).astype(np.float32)
    kw = dict(window_seconds=1.5, overlap=0.25, batch_size=8, beam_size=2,
              max_new_tokens=8, use_eot=True, splice=False)
    ref = JTranscriber(jmodel, variables, JBpeTokenizer(model_path=BPE),
                       JTranscribeConfig(**kw)).transcribe_array(x)
    tok = BpeTokenizer(model_path=BPE)
    got = Transcriber(tmodel, tok, TranscribeConfig(**kw), device="cpu").transcribe_array(x)
    assert isinstance(got, list) and len(got) == len(ref) == 5
    assert got == ref
    assert any(t.strip() for t in got)
    # the spliced result of the same windows: an overlap of 0.375 s gives
    # the merge window's floor of 5 words
    spliced = Transcriber(tmodel, tok, TranscribeConfig(**dict(kw, splice=True)),
                          device="cpu").transcribe_array(x)
    assert spliced == j_splice_strings(ref, 5)


def test_transcribe_cli_with_the_tracked_checkpoint(tmp_path):
    """`python -m tal_asrd_tpu_torch.cli.transcribe --device cpu` at full
    width with the tracked checkpoint: a directory of one 12 s wav from the
    synthetic test split, 5 s windows, beam 2, spliced; writes the
    transcript and skips it on a second run."""
    from tal_asrd_tpu_torch.cli.transcribe import main
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment, write_wav
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    split, audio, out = (str(tmp_path / n) for n in ("split", "audio", "out"))
    build_synth_corpus(split, n_episodes=1, episode_seconds=12.0, n_speakers=8, seed=202)
    os.makedirs(audio)
    write_wav(os.path.join(audio, "ep0.wav"),
              load_audio_segment(os.path.join(split, "ep0.wav"), 0.0, None))
    argv = ["--audio", audio, "--out-dir", out, "--tokenizer", BPE, "--model-type", "1x",
            "--num-speakers", "8", "--load", os.path.join(ROOT, "accuracy_release",
                                                         "avg_last_3.bf16.msgpack"),
            "--window-secs", "5", "--beam-size", "2", "--length", "24", "--device", "cpu"]
    written = main(argv)
    assert list(written) == [os.path.join(audio, "ep0.wav")]
    with open(os.path.join(out, "ep0.txt")) as f:
        text = f.read()
    assert text.strip() and text == written[os.path.join(audio, "ep0.wav")] + "\n"
    assert main(argv) == {}          # the transcript exists: skipped


def test_transcribe_cli_lm_weight_is_inert(tmp_path):
    """The reference's transcribe CLI takes --lm-weight and builds no LM, so
    the weight changes nothing; the port's runs it so (it exited before LM
    fusion was ported): the same transcript at --lm-weight 0.3 and 0, at
    full width with the tracked checkpoint."""
    from tal_asrd_tpu_torch.cli.transcribe import main
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment, write_wav
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    split, audio = str(tmp_path / "split"), str(tmp_path / "audio")
    build_synth_corpus(split, n_episodes=1, episode_seconds=6.0, n_speakers=8, seed=202)
    os.makedirs(audio)
    wav = os.path.join(audio, "ep0.wav")
    write_wav(wav, load_audio_segment(os.path.join(split, "ep0.wav"), 0.0, None))
    argv = ["--audio", audio, "--tokenizer", BPE, "--model-type", "1x", "--num-speakers", "8",
            "--load", os.path.join(ROOT, "accuracy_release", "avg_last_3.bf16.msgpack"),
            "--window-secs", "5", "--beam-size", "2", "--length", "16", "--device", "cpu"]
    texts = [main(argv + ["--out-dir", str(tmp_path / f"out{w}"), "--lm-weight", w])[wav]
             for w in ("0.3", "0")]
    assert texts[0] == texts[1] and texts[0].strip()
