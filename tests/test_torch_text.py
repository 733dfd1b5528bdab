"""The port's host text stack against the JAX package's: the BPE tokenizer on
the tracked model accuracy_release/bpe.model (encode, decode,
decode_speakers on seeded sentences with speaker tokens), the trainer, the
word tokenizers; and the native host libraries (fastbpe, bpetrain,
editdist, built from native/*.cpp) against their pure-Python paths."""
import os

import numpy as np
import pytest

from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu.text.bpe import BpeTrainer as JBpeTrainer
from tal_asrd_tpu.utils import wordtok as jwordtok
from tal_asrd_tpu_torch.eval import editdist
from tal_asrd_tpu_torch.text.bpe import BpeModel, BpeTokenizer, BpeTrainer
from tal_asrd_tpu_torch.utils import wordtok
from tal_asrd_tpu_torch.utils.native import BUILD_DIR, load_host_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")
N_SPEAKERS = 8


def seeded_sentences(n=40, seed=0):
    """Words of the synthetic corpus, plus capitals, digits, punctuation and
    characters outside the model (unk) now and then."""
    from tal_asrd_tpu_torch.data.synth import WORDS
    rng = np.random.default_rng(seed)
    extra = ["Hello,", "don't", "42", "3.14", "Ωmega", "naïve", "x-ray", "...", "wow!"]
    out = []
    for _ in range(n):
        words = [WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(1, 12))]
        if rng.random() < 0.5:
            words.insert(int(rng.integers(0, len(words) + 1)),
                         extra[int(rng.integers(0, len(extra)))])
        out.append(" ".join(words) + ("  " if rng.random() < 0.2 else ""))
    return out


@pytest.fixture(scope="module")
def toks():
    return BpeTokenizer(model_path=BPE), JBpeTokenizer(model_path=BPE)


def test_encode_and_decode_match_jax(toks):
    tok, jtok = toks
    assert len(tok) == len(jtok) == 300
    for s in seeded_sentences():
        for bos in (True, False):
            ids = tok.encode(s, bos_token=bos, eos_token=not bos)
            assert ids == jtok.encode(s, bos_token=bos, eos_token=not bos), s
            assert tok.decode(ids) == jtok.decode(ids)


def test_decode_speakers_matches_jax_on_streams_with_speaker_tokens(toks):
    """Streams in the model's format — <EOS> text <spk> <EOS> ... — with
    missing speaker tokens, doubled EOS, BOS inside and an unterminated tail."""
    tok, jtok = toks
    rng = np.random.default_rng(1)
    sents = seeded_sentences(60, seed=1)
    for trial in range(20):
        stream = [tok.eos_token_id]
        for _ in range(int(rng.integers(1, 5))):
            stream += tok.encode(sents[int(rng.integers(0, len(sents)))], False, False)
            r = rng.random()
            if r < 0.7:
                stream.append(tok.speaker_token_id(int(rng.integers(0, N_SPEAKERS))))
            elif r < 0.8:
                stream.append(tok.bos_token_id)
            stream.append(tok.eos_token_id)
            if rng.random() < 0.1:
                stream.append(tok.eos_token_id)
        if trial % 3 == 0:
            stream += tok.encode(sents[trial], False, False)       # unterminated
        for add_last in (True, False):
            got = tok.decode_speakers(stream, add_last=add_last)
            assert got == jtok.decode_speakers(stream, add_last=add_last)
        assert tok.decode(np.asarray(stream)) == jtok.decode(np.asarray(stream))
    utts, splits = tok.decode_speakers(stream)
    assert utts and all(isinstance(s, int) for s in splits)


def test_native_merge_loop_equals_the_python_path(monkeypatch):
    """fastbpe's encode_word against the Python merge loop, word by word."""
    assert load_host_library("fastbpe") is not None
    assert any(f.startswith("libfastbpe_") for f in os.listdir(BUILD_DIR))
    native = BpeModel.load(BPE)
    words = ["▁" + w for s in seeded_sentences(30, seed=2) for w in s.split()]
    got = [native.encode_word_ids(w, 3) for w in words]
    assert native._native() is not None
    monkeypatch.setenv("TAL_ASRD_NO_NATIVE", "1")
    python = BpeModel.load(BPE)
    assert python._native() is None
    assert got == [python.encode_word_ids(w, 3) for w in words]


def test_trainer_matches_jax_and_its_native_loop(monkeypatch):
    """BpeTrainer: port (native bpetrain) == JAX package == port (Python loop),
    pieces and merges, on the synthetic corpus's text with ties."""
    from tal_asrd_tpu_torch.data.synth import random_sentence
    rng = np.random.RandomState(3)
    lines = [random_sentence(rng) for _ in range(60)] + ["aa ab aa ab ba"] * 5
    assert load_host_library("bpetrain") is not None
    native = BpeTrainer(vocab_size=150).train(lines)
    ref = JBpeTrainer(vocab_size=150).train(lines)
    monkeypatch.setenv("TAL_ASRD_NO_NATIVE", "1")
    python = BpeTrainer(vocab_size=150).train(lines)
    assert len(native.merges) > 50
    for m in (ref, python):
        assert native.pieces == m.pieces and native.merges == m.merges


def test_tokenizer_pickles_without_its_model(toks, tmp_path):
    import pickle
    tok = pickle.loads(pickle.dumps(toks[0]))
    assert tok.encode("the water") == toks[1].encode("the water")


@pytest.mark.parametrize("fn", ["word_tokenize", "tweet_tokenize"])
def test_word_tokenizers_match_jax(fn):
    for s in seeded_sentences(20, seed=4) + ["Don't stop, it's 3.5 o'clock... ok?!"]:
        assert getattr(wordtok, fn)(s) == getattr(jwordtok, fn)(s)
    words = "well , it 's fine . right ?".split()
    assert wordtok.detokenize(words) == jwordtok.detokenize(words)


def test_native_edit_distance_equals_the_python_path():
    assert load_host_library("editdist") is not None
    rng = np.random.RandomState(0)
    for _ in range(30):
        a = list(rng.randint(0, 5, rng.randint(0, 30)))
        b = list(rng.randint(0, 5, rng.randint(0, 30)))
        ia, ib = editdist.intern_symbols(a, b)
        assert editdist.eval_distance(a, b) == editdist._py_distance(ia, ib)
        if a and b:
            assert editdist.opcodes(a, b) == editdist._py_opcodes(ia, ib)


def test_edit_distance_without_the_library(monkeypatch):
    """TAL_ASRD_NO_NATIVE takes the Python path, with the same answers."""
    a, b = "the cat sat on the mat".split(), "a cat sat on mat".split()
    native = (editdist.eval_distance(a, b), editdist.opcodes(a, b))
    monkeypatch.setenv("TAL_ASRD_NO_NATIVE", "1")
    assert editdist._editdist() is None
    assert (editdist.eval_distance(a, b), editdist.opcodes(a, b)) == native
    assert native[0] == 2
